"""FedISL (Razmi et al.): intra-orbit ISL relaying to a star PS.

Non-ideal: GS at Rolla — each orbit must wait for ANY member to be
visible; all K models relay through that member (no partial aggregation,
so K full models cross the SGL). Ideal: MEO PS above the equator
(persistent visibility for most orbits) — same rules, ideal station
config (``stations="meo"``). Execution rides the shared
:class:`RoundStrategy` plan/execute split; FedISL evaluates every round.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

from repro_torch.core.weights import renormalize
from repro_torch.sim.strategies.base import RoundStrategy, register_strategy


@dataclasses.dataclass(frozen=True)
class IslRoundPlan:
    """One FedISL round: lossless FedAvg weights + relay/upload latency."""
    mu: np.ndarray            # (n_sats,) FedAvg weights (sizes / total)
    round_end: float          # when the last orbit's K uploads finish [s]
    t_next: float             # == round_end (no inter-station ring)


@register_strategy("fedisl")
class FedIsl(RoundStrategy):

    def eval_due(self, cfg: Any, events: int) -> bool:
        return True           # FedISL records accuracy every round

    def plan_round(self, eng: Any, t: float) -> IslRoundPlan | None:
        """Vectorized schedule for the round starting at ``t``.

        Round latency: train + relay K models halfway around the ring
        + K full-model uploads through the gateway's single SGL. All
        orbits' gateway picks and upload delays are one batched gather.
        """
        cfg = eng.cfg
        k = cfg.sats_per_orbit
        orbit_t = eng.first_orbit_contacts(t)
        if np.isnan(orbit_t).any():
            return None
        isl = eng.isl_delay()
        L = cfg.num_orbits
        tidx = eng.tidx(orbit_t)                   # (L,) batched lookup
        any_vis = eng.any_vis[:, tidx]             # (n_sat, L)
        blocks = any_vis.reshape(L, k, L)[np.arange(L), :, np.arange(L)]
        if not blocks.any(axis=1).all():
            raise RuntimeError(
                "first_orbit_contacts returned a tick with no visible "
                f"member for orbits {np.nonzero(~blocks.any(axis=1))[0]}")
        gw = blocks.argmax(axis=1) + np.arange(L) * k   # first visible
        up = eng.shl_delays(np.zeros(L, dtype=np.int64), gw, tidx)
        lat = float(np.max((orbit_t - t) + eng.train_time()
                           + (k // 2) * isl + k * up))
        # FedAvg aggregate of ALL satellites (FedISL is lossless).
        mu = eng.sizes / eng.sizes.sum()
        if eng.fault_plane is not None:
            # Lost uploads (fault plane): an orbit whose gateway upload
            # is lost at the report tick drops out of this round's
            # FedAvg; survivors renormalize. All lost -> all-zero mu,
            # the drivers carry params forward. No-loss rounds keep the
            # original weights bit-for-bit.
            ok = eng.fault_plane.upload_ok[gw, tidx]        # (L,)
            if not ok.all():
                mu = renormalize(np.where(np.repeat(ok, k), mu, 0.0))
        return IslRoundPlan(mu, t + lat, t + lat)


@register_strategy("fedisl_ideal")
class FedIslIdeal(FedIsl):
    """Identical rules; the 'ideal' part is the MEO PS above the equator,
    which is pure station config (``stations="meo"``)."""
