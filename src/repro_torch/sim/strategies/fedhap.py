"""FedHAP (paper Alg. 1): intra-orbit Eq.-14 chains, HAP collection.

Scheduling: the source HAP accumulates partials until every satellite is
covered — each orbit reports at its own first visibility and the round
completes when the LAST orbit reports (paper Alg. 1 line 18 reschedules
until the cover is full). Weighting: closed-form Eq. 14-16 per-satellite
weights from `repro.core.weights`. Execution (train -> fold -> eval) is
the shared :class:`RoundStrategy` machinery — per-round or the fused
plan-ahead block driver.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

from repro_torch.core.weights import (
    chain_stats,
    mu_from_chain,
    renormalize,
    segment_ends,
)
from repro_torch.sim.strategies.base import RoundStrategy, register_strategy


@dataclasses.dataclass(frozen=True)
class RoundPlan:
    """Scheduling + weighting decision for one FedHAP round (no training
    involved — also driven standalone by the --sim-wallclock benches)."""
    orbit_t: np.ndarray       # (L,) per-orbit report times [s]
    mu: np.ndarray            # (n_sats,) Eq. 14-16 global weights
    round_end: float          # when the last partial lands on the HAP [s]
    t_next: float             # round_end + inter-HAP dissemination ring [s]


@register_strategy("fedhap")
class FedHap(RoundStrategy):

    def plan_round(self, eng: Any, t: float) -> RoundPlan | None:
        """Vectorized schedule for the round starting at ``t``.

        Returns None when some orbit has no remaining contact before the
        horizon (the run ends). Per-orbit visibility rows are gathered at
        each orbit's own report time; chain weights for ALL orbits come
        from one batched closed-form evaluation.
        """
        cfg = eng.cfg
        orbit_t = eng.first_orbit_contacts(t)
        if np.isnan(orbit_t).any():
            return None
        L, k = cfg.num_orbits, cfg.sats_per_orbit

        # (L, n_st, k) station visibility of each orbit at its own time.
        tidx = eng.tidx(orbit_t)                  # (L,) batched lookup
        rows = eng.vis[:, :, tidx]                # (n_st, n_sat, L)
        rows = rows.reshape(rows.shape[0], L, k, L)
        vis_rows = rows[:, np.arange(L), :, np.arange(L)]    # (L, n_st, k)
        any_vis = vis_rows.any(axis=1)                       # (L, k)
        sizes = eng.sizes.reshape(L, k)

        lam, seg_mass = chain_stats(any_vis, sizes, cfg.partial_mode)
        mu = mu_from_chain(lam, seg_mass, sizes,
                           cfg.orbit_weighting).reshape(-1)
        seg_end = segment_ends(any_vis)                      # (L, k)

        # Latency: each segment hops its run over the ISL ring, then
        # uploads through the first station that sees its terminal
        # satellite (Eq. 15 dedup: IDs filter duplicates across HAPs).
        # Every (orbit, segment-end) upload is priced by ONE batched
        # delay-table gather instead of per-segment shl_delay calls.
        train_t = eng.train_time()
        isl = eng.isl_delay()
        owner = np.where(vis_rows.any(axis=1),
                         vis_rows.argmax(axis=1), 0)         # (L, k)
        counts = np.zeros((L, k), dtype=np.int64)            # members/end
        np.add.at(counts, (np.arange(L)[:, None], seg_end), 1)
        sat_ids = np.arange(L)[:, None] * k + np.arange(k)[None, :]
        shl = eng.shl_delays(owner, sat_ids, tidx[:, None])  # (L, k)
        lat = train_t + counts * isl + shl
        ends = counts > 0                        # slots that end a segment
        round_end = max(t, float((orbit_t[:, None] + lat)[ends].max()))
        if eng.fault_plane is not None:
            # Lost uploads (fault plane): a segment whose terminal
            # satellite's upload is lost at the report tick contributes
            # nothing this round — its members' mu zero out and the
            # Eq. 14-16 weights renormalize over the surviving uploads.
            # The round barrier still waits for the lost reports (the
            # loss is discovered at arrival); rounds with no loss keep
            # the original weights bit-for-bit. An all-lost round
            # returns an all-zero mu: the drivers fold nothing and
            # carry params forward.
            end_ids = np.arange(L)[:, None] * k + seg_end    # (L, k)
            ok = eng.fault_plane.upload_ok[end_ids, tidx[:, None]]
            if not ok.all():
                mu = renormalize(np.where(ok.reshape(-1), mu, 0.0))
        # Inter-HAP ring (down + up) before the next round can start.
        return RoundPlan(orbit_t, mu, round_end,
                         round_end + eng.ring_delay())
