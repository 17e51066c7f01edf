"""Asynchronous FedHAP over routed sinks: HAPs fold whatever routed
orbit models have arrived, staleness-discounted.

Each orbit cycles independently (no round barrier): train from the
global it last saw, fold the members along the Eq.-14 intra-plane chain
into the orbit's elected sink (:meth:`RoundEngine.elect_sinks` — the
election routes over the intra-plane contact graph, stitched across
windows on shells past the grid byte budget), and upload at the sink's
next station contact (:meth:`RoundEngine.station_upload_end`, priced on
the full-horizon contact tables). The station folds each
arrival immediately:

    global <- (1 - rho) * global + rho * orbit_model,
    rho = (m_orbit / m_total) * staleness_discount(tag - base_tag)

with the discount from the closed-form weights engine
(:func:`repro.core.weights.staleness_discount`) — orbits that cycled
against an old global are down-weighted, exactly the FedSpace rule
applied on top of FedHAP's Eq. 14 chain weights. Event-driven: the
simulator jumps between arrivals, no fixed-tick stepping.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import numpy as np

from repro_torch.core.treeops import tree_add, tree_scale
from repro_torch.core.weights import staleness_discount
from repro_torch.sim.strategies.base import (
    AsyncFoldPlan,
    CycleStrategy,
    RunState,
    register_strategy,
)


@register_strategy("fedhap_async")
class FedHapAsync(AsyncFoldPlan, CycleStrategy):

    def schedule_cycle(self, eng: Any, l: int,
                       t_s: float) -> Optional[Tuple[float, np.ndarray]]:
        t0 = t_s + eng.train_time()
        el = eng.elect_sinks(t0, orbits=(l,))
        if not np.isfinite(el.scores[0]):
            return None
        # Lost-upload-aware: under a fault plane the sink retries a
        # lost upload through the next contact with capped backoff
        # (engine `upload_end`; delegates to station_upload_end
        # bit-identically without one).
        end = float(eng.upload_end(int(el.sinks[0]),
                                   float(el.delivery[0])))
        if not np.isfinite(end):
            return None
        return end, el.lam[0]

    def schedule_cycle_batch(self, eng: Any, ls, ts) -> list:
        """Batched pricing: one sink election over the block-diagonal
        intra-plane graph for every cycle in the run
        (:meth:`RoundEngine.elect_sinks_batch`), then one gather for
        the elected sinks' station-upload ends — bit-equal to looping
        :meth:`schedule_cycle` (shared per-(orbit, t) sink cache)."""
        t0 = np.asarray(ts, dtype=np.float64) + eng.train_time()
        el = eng.elect_sinks_batch(ls, t0)
        ok = np.isfinite(el.scores)
        ends = np.full(len(ls), np.inf)
        if ok.any():
            ends[ok] = eng.upload_end(el.sinks[ok], el.delivery[ok])
        return [(float(ends[i]), el.lam[i])
                if ok[i] and np.isfinite(ends[i]) else None
                for i in range(len(ls))]

    def fold(self, eng: Any, s: RunState, l: int, orbit_model: Any,
             base_tag: int) -> None:
        cfg = eng.cfg
        sc = s.scratch
        sl = eng.orbit_slice(l)
        rho = float(eng.sizes[sl].sum() / eng.sizes.sum()
                    * staleness_discount(sc["tag"] - base_tag,
                                         cfg.staleness_power))
        s.params = tree_add(tree_scale(s.params, 1.0 - rho),
                            tree_scale(orbit_model, rho))
        sc["tag"] += 1
        s.events += 1
        if (s.events - 1) % cfg.eval_every_rounds == 0:
            eng.eval_and_record(s)
