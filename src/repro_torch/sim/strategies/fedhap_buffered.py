"""Buffered FedHAP over routed multi-hop paths: buffer-then-flush
dissemination through whichever satellite can exit first.

Like ``fedhap_async``, every orbit cycles independently and folds its
members along the Eq.-14 chain into its elected sink — but the folded
model then rides the contact-graph router *cross-plane*
(:meth:`RoundEngine.route_exit_end`: stitched earliest-arrival from the
sink to every satellite, windows chained past the grid byte budget) and
exits through the satellite with the earliest completed station upload,
not necessarily one of the orbit's own. The station buffers arrivals
and flushes once ``buffer_fraction`` of the orbits have reported:

    global <- (1 - sum rho_j) * global + sum_j rho_j * model_j,
    rho_j = (m_orbit_j / m_total) * staleness_discount(tag - base_tag_j)

one einsum over the stacked buffered models, with the shared discount
from :func:`repro.core.weights.staleness_discount`.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import numpy as np

from repro_torch.core.treeops import tree_add, tree_scale
from repro_torch.core.weights import staleness_discount
from repro_torch.sim.strategies.base import (
    CycleStrategy,
    RunState,
    register_strategy,
)


@register_strategy("fedhap_buffered")
class FedHapBuffered(CycleStrategy):

    def buffer_slots(self, eng: Any) -> int:
        return max(1, int(eng.cfg.buffer_fraction * eng.cfg.num_orbits))

    def plan_fold(self, eng: Any, st: dict, l: int) -> dict:
        """Plan-phase mirror of :meth:`fold`: buffer the arrival's slot;
        on the threshold arrival, price the staleness-discounted flush
        weights of everything buffered (discounts at flush time, as the
        reference computes them) and clear the plan-side buffer."""
        B = self.buffer_slots(eng)
        slot = st["fill"]
        st["meta"].append((l, st["base_tag"][l]))
        st["fill"] += 1
        if st["fill"] < B:
            return dict(rhos=np.zeros(B), keep=1.0, slot=slot,
                        flush=False, folds=0)
        total = eng.sizes.sum()
        rhos = np.zeros(B)
        for j, (jl, btag) in enumerate(st["meta"]):
            rhos[j] = (eng.sizes[eng.orbit_slice(jl)].sum() / total
                       * staleness_discount(st["tag"] - btag,
                                            eng.cfg.staleness_power))
        keep = max(0.0, 1.0 - float(rhos.sum()))
        st["meta"].clear()
        st["fill"] = 0
        st["tag"] += 1
        return dict(rhos=rhos, keep=keep, slot=slot, flush=True, folds=1)

    def schedule_cycle(self, eng: Any, l: int,
                       t_s: float) -> Optional[Tuple[float, np.ndarray]]:
        t0 = t_s + eng.train_time()
        el = eng.elect_sinks(t0, orbits=(l,))
        if not np.isfinite(el.scores[0]):
            return None
        # Route the folded model from the sink to EVERY satellite and
        # exit through the earliest completed station upload (the sink
        # itself is a zero-hop candidate: arr[sink] == delivery). The
        # engine stitches the sweep across contact-graph windows, so
        # exits landing past a window boundary still price correctly.
        # Under a fault plane the exit pricing is lost-upload aware:
        # route_exit_end(s) price through the engine's `upload_end`
        # retry wrapper, so a lost exit retries through later contacts
        # (capped) and ISL terminal faults are already masked out of
        # the routed graph.
        end = eng.route_exit_end(int(el.sinks[0]), float(el.delivery[0]))
        if not np.isfinite(end):
            return None
        return end, el.lam[0]

    def schedule_cycle_batch(self, eng: Any, ls, ts) -> list:
        """Batched pricing: one sink election over the block-diagonal
        intra-plane graph for the whole run
        (:meth:`RoundEngine.elect_sinks_batch`), then ONE multi-source
        cross-plane exit sweep for every elected sink
        (:meth:`RoundEngine.route_exit_ends` — per-source start times,
        a single frontier relaxation) — bit-equal to looping
        :meth:`schedule_cycle` (shared per-(orbit, t) sink cache)."""
        t0 = np.asarray(ts, dtype=np.float64) + eng.train_time()
        el = eng.elect_sinks_batch(ls, t0)
        ok = np.isfinite(el.scores)
        ends = np.full(len(ls), np.inf)
        if ok.any():
            ends[ok] = eng.route_exit_ends(el.sinks[ok], el.delivery[ok])
        return [(float(ends[i]), el.lam[i])
                if ok[i] and np.isfinite(ends[i]) else None
                for i in range(len(ls))]

    def fold(self, eng: Any, s: RunState, l: int, orbit_model: Any,
             base_tag: int) -> None:
        cfg = eng.cfg
        sc = s.scratch
        buf = sc.setdefault("buffer", [])
        buf.append((l, orbit_model, base_tag))
        if len(buf) < self.buffer_slots(eng):
            return
        total = eng.sizes.sum()
        rhos = np.array([
            eng.sizes[eng.orbit_slice(j)].sum() / total
            * staleness_discount(sc["tag"] - btag, cfg.staleness_power)
            for j, _, btag in buf])
        stacked = eng.trainer.stack([m for _, m, _ in buf])
        keep = max(0.0, 1.0 - float(rhos.sum()))
        s.params = tree_add(tree_scale(s.params, keep),
                            eng.combine(stacked, rhos))
        buf.clear()
        sc["tag"] += 1
        s.events += 1
        if (s.events - 1) % cfg.eval_every_rounds == 0:
            eng.eval_and_record(s)
