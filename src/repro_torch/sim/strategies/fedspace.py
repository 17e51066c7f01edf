"""FedSpace (So et al.): semi-asynchronous buffered aggregation against
a GS with scheduled aggregation; stale updates are down-weighted (port
of ``repro.sim.strategies.fedspace``).

The tick schedule (rising-edge passes) and the staleness weights are
param-independent — the plan phase — so the fused loop keeps the
per-satellite base models stacked on the device, trains every fresh
pass of a tick in one burst that returns the stacked deltas
(:meth:`~repro_torch.sim.executor.FusedExecutor.fedspace_train`), and
applies the buffered flush through the fold
(:meth:`~repro_torch.sim.executor.FusedExecutor.fedspace_flush`: one
``fedagg`` launch per flush on the card)."""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.core.treeops import tree_add, tree_sub
from repro_torch.core.weights import staleness_discount
from repro_torch.sim.strategies.base import (
    RunState, Strategy, register_strategy)


@register_strategy("fedspace")
class FedSpace(Strategy):

    def _flush_size(self, eng: Any) -> int:
        return max(1, int(eng.cfg.buffer_fraction * eng.n_sats))

    def step(self, eng: Any, s: RunState) -> bool:
        cfg = eng.cfg
        sc = s.scratch
        if not sc:
            sc.update(
                buffer=[],                 # (sat, delta, round_tag)
                sat_base=[s.params] * eng.n_sats,
                sat_base_tag=np.zeros(eng.n_sats, dtype=int),
                tag=0,
                last_seen=np.zeros(eng.n_sats, dtype=bool),
            )
        vis = eng.vis_at(s.t).any(axis=0)
        newly = vis & ~sc["last_seen"]      # rising edge: a new pass
        sc["last_seen"] = vis
        new_sats = np.nonzero(newly)[0]
        if eng.fault_plane is not None and len(new_sats):
            # Lost uploads (fault plane): a pass whose upload is lost
            # at the rising edge contributes nothing — the pass is
            # consumed (last_seen already advanced) and the satellite
            # retries at its next rising edge. No-loss ticks untouched.
            new_sats = new_sats[eng.upload_survives(new_sats, s.t)]
        if len(new_sats):
            # every fresh pass in this tick trains in ONE burst
            stacked = eng.trainer.stack(
                [sc["sat_base"][int(x)] for x in new_sats])
            sel = eng.sample_indices(new_sats.tolist(), s.t)
            trained, _ = eng.trainer.train_selection(
                stacked, eng.fd, sel)
            for j, sat in enumerate(new_sats):
                sat = int(sat)
                new_p = eng.trainer.unstack(trained, j)
                delta = tree_sub(new_p, sc["sat_base"][sat])
                sc["buffer"].append(
                    (sat, delta, int(sc["sat_base_tag"][sat])))
                sc["sat_base"][sat] = s.params
                sc["sat_base_tag"][sat] = sc["tag"]
        if len(sc["buffer"]) >= self._flush_size(eng):
            total = eng.sizes.sum()
            wts = np.array([
                eng.sizes[sat] / total
                * staleness_discount(sc["tag"] - btag, cfg.staleness_power)
                for sat, _, btag in sc["buffer"]])
            stacked = eng.trainer.stack([d for _, d, _ in sc["buffer"]])
            s.params = tree_add(s.params, eng.combine(stacked, wts))
            sc["buffer"].clear()
            sc["tag"] += 1
            s.events += 1
            eng.eval_and_record(s)
        s.t += cfg.time_step_s
        return True

    def run_fused(self, eng: Any, s: RunState) -> None:
        cfg = eng.cfg
        ex = eng.executor
        bases = ex.broadcast_rows(s.params, eng.n_sats)
        base_tag = np.zeros(eng.n_sats, dtype=int)
        last_seen = np.zeros(eng.n_sats, dtype=bool)
        buffer = []                        # (deltas (N,...), sats, tags)
        buffered = 0
        tag = 0
        total = eng.sizes.sum()
        loaded = eng.ckpt_resume(s, {"params": s.params, "bases": bases})
        if loaded is not None:
            s.params, bases = loaded["params"], loaded["bases"]
            meta = eng.ckpt_meta()
            base_tag = np.asarray(meta["base_tag"], dtype=int)
            last_seen = np.asarray(meta["last_seen"], dtype=bool)
            tag = int(meta["tag"])
        while (s.events < cfg.max_rounds and s.t <= eng.horizon_s
               and s.acc < cfg.target_accuracy):
            vis = eng.vis_at(s.t).any(axis=0)
            new_sats = np.nonzero(vis & ~last_seen)[0]
            last_seen = vis
            if eng.fault_plane is not None and len(new_sats):
                new_sats = new_sats[eng.upload_survives(new_sats, s.t)]
            if len(new_sats):
                idx = eng.sample_indices(new_sats.tolist(), s.t)
                deltas, bases = ex.fedspace_train(
                    s.params, bases, new_sats, idx)
                buffer.append((deltas, new_sats, base_tag[new_sats]))
                base_tag[new_sats] = tag
                buffered += len(new_sats)
            if buffered >= self._flush_size(eng):
                # The executor does not pad (the reference pads to a
                # power of two, with zero-weight rows): one weight per
                # buffered delta row.
                wts = np.concatenate([
                    eng.sizes[sats] / total
                    * staleness_discount(tag - tags, cfg.staleness_power)
                    for _, sats, tags in buffer])
                stacked = {n: torch.cat([d[n] for d, _, _ in buffer])
                           for n in buffer[0][0]}
                s.params = ex.fedspace_flush(s.params, stacked, wts)
                buffer.clear()
                buffered = 0
                tag += 1
                s.events += 1
                eng.eval_and_record(s)
            s.t += cfg.time_step_s
            if buffered == 0:
                # Checkpoint only at flush boundaries: the in-flight
                # buffer holds device-resident delta stacks that the
                # snapshot template can't carry.
                eng.ckpt_tick(
                    s, {"params": s.params, "bases": bases},
                    meta={"base_tag": base_tag.tolist(),
                          "last_seen": last_seen.tolist(),
                          "tag": int(tag)})
