"""FedSat (Razmi et al., async, ideal NP GS): per-orbit periodic visits;
the PS folds each orbit's fresh average in as it arrives (port of
``repro.sim.strategies.fedsat``).

All orbits visited in one tick train as one replica-stacked burst (one
batched mini-batch gather across every participating satellite); the
per-orbit async folds stay sequential, as the method requires. The tick
schedule (visited orbits, gateway delays) is param-independent — the
plan phase, the reference's numpy unchanged — so the fused loop keeps
the global and the per-orbit base models resident on the device and
executes each visited tick as one
:meth:`~repro_torch.sim.executor.FusedExecutor.fedsat_event` call: one
``fedagg`` launch per visited orbit on the card."""
from __future__ import annotations

from typing import Any

import numpy as np

from repro_torch.core.treeops import tree_add, tree_scale
from repro_torch.sim.strategies.base import (
    RunState, Strategy, register_strategy)


@register_strategy("fedsat")
class FedSat(Strategy):

    def _plan_tick(self, eng: Any, t: float):
        """Pure-numpy tick plan: visited orbits + the tick's gateway
        time advance (None when nothing is visible)."""
        cfg = eng.cfg
        k = cfg.sats_per_orbit
        vis = eng.vis_at(t).any(axis=0)
        visited = [l for l in range(cfg.num_orbits)
                   if vis[eng.orbit_slice(l)].any()]
        if visited and eng.fault_plane is not None:
            # Lost uploads (fault plane): each visited orbit relays
            # through its first visible member; when that relay's upload
            # is lost at this tick the orbit drops out of the tick and
            # retries at its next pass. No-loss ticks are untouched.
            relays = np.array([int(np.argmax(vis[eng.orbit_slice(l)]))
                               + l * k for l in visited])
            okv = eng.upload_survives(relays, t)
            visited = [l for l, o in zip(visited, okv) if o]
        if not visited:
            return None
        gw_delay = (eng.train_time() + (k // 2) * eng.isl_delay()
                    + k * eng.shl_delay(0, 0, t))
        return visited, max(gw_delay, cfg.time_step_s)

    def step(self, eng: Any, s: RunState) -> bool:
        cfg = eng.cfg
        k = cfg.sats_per_orbit
        # per-orbit last-known global (staleness source)
        base = s.scratch.setdefault("orbit_base",
                                    [s.params] * cfg.num_orbits)
        plan = self._plan_tick(eng, s.t)
        if plan is None:
            s.t += cfg.time_step_s
            return True
        visited, advance = plan
        # ONE training burst for every satellite of every visited orbit,
        # each replica starting from its orbit's last-known global.
        clients = [c for l in visited
                   for c in range(l * k, (l + 1) * k)]
        stacked = eng.trainer.stack(
            [base[l] for l in visited for _ in range(k)])
        sel = eng.sample_indices(clients, s.t)
        stacked, _ = eng.trainer.train_selection(stacked, eng.fd, sel)
        for i, l in enumerate(visited):
            sl = eng.orbit_slice(l)
            orbit_rows = {n: x[i * k:(i + 1) * k]
                          for n, x in stacked.items()}
            orbit_model = eng.combine(
                orbit_rows, eng.sizes[sl] / eng.sizes[sl].sum())
            # async fold: global <- (1-rho) global + rho orbit_model
            rho = eng.sizes[sl].sum() / eng.sizes.sum()
            s.params = tree_add(tree_scale(s.params, 1 - rho),
                                tree_scale(orbit_model, rho))
            base[l] = s.params
            s.events += 1
        s.t += advance
        eng.eval_and_record(s)
        return True

    def run_fused(self, eng: Any, s: RunState) -> None:
        cfg = eng.cfg
        ex = eng.executor
        k = cfg.sats_per_orbit
        total = eng.sizes.sum()
        bases = ex.broadcast_rows(s.params, cfg.num_orbits)
        loaded = eng.ckpt_resume(s, {"params": s.params, "bases": bases})
        if loaded is not None:
            s.params, bases = loaded["params"], loaded["bases"]
        while (s.events < cfg.max_rounds and s.t <= eng.horizon_s
               and s.acc < cfg.target_accuracy):
            plan = self._plan_tick(eng, s.t)
            if plan is None:
                s.t += cfg.time_step_s
                continue
            visited, advance = plan
            clients = [c for l in visited
                       for c in range(l * k, (l + 1) * k)]
            idx = eng.sample_indices(clients, s.t)
            sizes = eng.sizes.reshape(cfg.num_orbits, k)[visited]
            lam_rows = sizes / sizes.sum(axis=1, keepdims=True)
            rhos = sizes.sum(axis=1) / total
            s.params, bases = ex.fedsat_event(
                s.params, bases, np.asarray(visited), idx, lam_rows,
                rhos)
            s.events += len(visited)
            s.t += advance
            eng.eval_and_record(s)
            eng.ckpt_tick(s, {"params": s.params, "bases": bases})
