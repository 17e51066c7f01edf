"""FedSink (Elmahallawy & Luo, arXiv:2302.13447, on FedHAP physics):
intra-plane model propagation to a per-orbit *elected sink* satellite
which does the SHL exchange with the parameter stations.

Scheduling: each round, every orbit elects the member that minimizes the
aggregate reachability score — the Eq.-14-chain-weighted routed arrival
delay of its members' models plus the candidate's station exit cost
(wait for its next contact + SHL transfer); see
:meth:`repro.sim.engine.RoundEngine.elect_sinks` /
:func:`repro.orbits.routing.elect_sinks`. All orbits are scored by ONE
vectorized election over the sparse block-diagonal *intra-plane*
contact graph (CSR edge tables, stitched across windows on shells past
``SimConfig.isl_grid_max_bytes``) — disjoint blocks relax
independently, so the batched call is bit-equal to routing each
orbit's induced subgraph — and exits are priced on the full-horizon
contact tables, so mega-shell elections match the single-graph oracle
exactly. All members train, their
models fold along the closed-form intra-plane chain into the sink, and
the round completes when the slowest orbit's sink finishes its upload.
Weighting: Eq. 14-16 with exactly one visible satellite (the sink) per
ring — the same closed-form engine as fedhap.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

from repro_torch.core.weights import mu_weights, renormalize
from repro_torch.sim.strategies.base import RoundStrategy, register_strategy


@dataclasses.dataclass(frozen=True)
class SinkRoundPlan:
    """Scheduling + weighting decision of one fedsink round (driven
    standalone by the --sim-wallclock benches, like fedhap's RoundPlan)."""
    sinks: np.ndarray         # (L,) elected sink satellite ids
    mu: np.ndarray            # (n_sats,) Eq. 14-16 global weights
    round_end: float          # when the last sink's upload completes [s]
    t_next: float             # round_end + inter-HAP dissemination ring [s]


@register_strategy("fedsink")
class FedSink(RoundStrategy):

    def plan_round(self, eng: Any, t: float) -> SinkRoundPlan | None:
        """Vectorized sink election + pricing for the round at ``t``.

        Returns None when some orbit has no candidate that can exit
        before the horizon (the run ends). Elections, routed chain
        delays, and station exits are all batched engine/router queries.
        """
        cfg = eng.cfg
        L, k = cfg.num_orbits, cfg.sats_per_orbit
        t0 = t + eng.train_time()
        el = eng.elect_sinks(t0)
        if not np.isfinite(el.scores).all():
            return None
        # Lost-upload-aware exit pricing: under a fault plane a sink's
        # upload retries through the next contact with capped backoff
        # (engine `upload_end`; the election itself doesn't foresee
        # losses — it scores the next-contact exit like the paper's
        # ideal links, and a sink down in its upload window already
        # prices its exit through the next up contact via the masked
        # visibility grid, i.e. re-election is in the scores).
        upload_end = eng.upload_end(el.sinks, el.delivery)
        ok = np.isfinite(upload_end)
        if not ok.all() and (eng.fault_plane is None or not ok.any()):
            return None
        visible = np.zeros((L, k), dtype=bool)
        visible[np.arange(L)[ok], el.sink_slots[ok]] = True
        mu = mu_weights(visible.reshape(-1), eng.sizes, k,
                        cfg.partial_mode, cfg.orbit_weighting)
        if not ok.all():
            # Orbits whose sink exhausted its retries drop out of the
            # round; Eq. 14-16 weights renormalize over the survivors.
            mu = renormalize(np.asarray(mu))
        round_end = max(t, float(upload_end[ok].max()))
        # Inter-HAP ring (down + up) before the next round can start.
        return SinkRoundPlan(el.sinks, np.asarray(mu), round_end,
                             round_end + eng.ring_delay())
