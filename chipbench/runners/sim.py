"""Runner of whole FedHAP simulations: each timed unit is one fresh
``RoundEngine(SimConfig(...)).run()``, the engine's build and plan
included, from the same seed.

Set-up renders the digits once (the program's engine would render them
again on every build) and hands them in through the dataset registry;
the CNN's first weights are the benchmark's own draw, handed in as
``run(init_params=...)``. One simulation runs before the window: it
builds the kernels and warms every shape the window uses.

The check runs the plain reference (``reference/cnn_fedhap.py``) once,
after the window, on the same inputs, and compares every simulation of
the window with it: the rounds and their simulated hours (exact); the
global model and the accuracy after the first round, where 54 SGD steps
have not yet amplified the order of the sums; and the final global
model, which 810 steps of every satellite's SGD take chaotically apart
from the reference's by ~1e-3-2e-2 of its norm (a coarse check there).
"""
from __future__ import annotations

import time
import types

import torch

from chipbench import costs
from chipbench.inputs import digits, weights

DATASET = "chipbench-digits"
_DATA: dict = {}


def _digits_loader(num_samples: int, seed: int, **_):
    return _DATA[(num_samples, seed)]


def _register_dataset() -> None:
    from repro_torch.clients.registry import (available_datasets,
                                              register_dataset)
    if DATASET not in available_datasets():
        register_dataset(DATASET)(_digits_loader)


def sim_config(cell) -> dict:
    sim = dict(cell.config["sim"], **cell.workload.get("sim", {}))
    sim["seed"] = cell.seed % 2**63
    return sim


def setup(cell, log):
    from repro_torch.configs.paper_cnn import CONFIG
    from repro_torch.models.cnn import CNN
    from repro_torch.sim.engine import SimConfig

    sim = sim_config(cell)
    specs = weights.cnn_specs(cell.config)
    mine = {k: tuple(s) for k, s, _ in specs}
    theirs = {k: tuple(d.shape) for k, d in CNN(CONFIG).defs().items()}
    if mine != theirs:
        raise RuntimeError(f"the port's CNN has leaves {theirs}; the "
                           f"configuration {mine}")
    t = time.perf_counter()
    images, labels = digits.make_digits_dataset(
        sim["num_samples"], weights.stream_seed(cell.seed, 4))
    _DATA[(sim["num_samples"], sim["seed"])] = (images, labels)
    _register_dataset()
    log(f"digits rendered in {time.perf_counter() - t:.2f} s")
    init = {k: v.cpu().numpy() for k, v in weights.materialize(
        specs, cell.seed, cell.device, torch.float32).items()}
    cfg = SimConfig(**dict(sim, dataset=DATASET, device=str(cell.device)))
    st = types.SimpleNamespace(cell=cell, sim=sim, cfg=cfg, init=init,
                               images=images, labels=labels, runs=[],
                               build_s=[], log=log)
    t = time.perf_counter()
    unit(st, -1)
    log(f"warm-up simulation: {len(st.runs[0][0])} rounds in "
        f"{time.perf_counter() - t:.2f} s")
    st.warm = st.runs.pop()
    st.build_s.clear()
    return st


def unit(st, i: int) -> None:
    from repro_torch.sim.engine import RoundEngine

    t = time.perf_counter()
    eng = RoundEngine(st.cfg)
    st.build_s.append(time.perf_counter() - t)
    held = {}
    ex = eng.executor
    run_block, fold = ex.run_block, ex._fold

    def spy_block(*args, **kw):
        out = run_block(*args, **kw)
        held["final"] = out[0]
        return out

    def spy_fold(*args, **kw):
        out = fold(*args, **kw)
        held.setdefault("first", {k: v.clone() for k, v in out.items()})
        return out
    ex.run_block, ex._fold = spy_block, spy_fold
    result = eng.run(init_params=st.init)
    st.runs.append((result.history, held["final"], held["first"]))


def window_metrics(st, units: int, elapsed: float, peak: int) -> dict:
    return {"sim_s": elapsed / units}


def context(st, units: int, elapsed: float):
    sim, c = st.sim, st.cell.config["cnn"]
    rounds = sum(len(r[0]) for r in st.runs)
    fwd = costs.cnn_forward_flop(c["image_size"], tuple(c["channels"]),
                                 c["kernel"], c["hidden"], c["num_classes"])
    trained = (rounds * sim["num_orbits"] * sim["sats_per_orbit"]
               * sim["local_steps"] * sim["batch_size"])
    n_params = sum(v.size for v in st.init.values())
    return types.SimpleNamespace(
        kind="sim", cell=st.cell, units=units, elapsed=elapsed,
        rounds=rounds, build_s=list(st.build_s),
        model_flop=3 * fwd * trained + fwd * sim["eval_samples"] * rounds,
        peak_flop_per_s=costs.F32_FLOP_PER_S,
        fold=dict(s=sim["num_orbits"] * sim["sats_per_orbit"], p=n_params,
                  itemsize=4, launches=rounds))


def release(st) -> None:
    _DATA.clear()
    st.runs = [(h, *({k: v.detach().cpu() for k, v in p.items()}
                     for p in ps)) for h, *ps in st.runs]
    if st.cell.device.type == "cuda":
        torch.cuda.empty_cache()


def reference(st, tf32: bool = False):
    from chipbench.reference import cnn_fedhap
    return cnn_fedhap.simulate(st.sim, st.init, st.images, st.labels,
                               st.cell.device, tf32=tf32)


def _leaf_gap(got: dict, want: dict) -> float:
    """The worst leaf's distance from the reference's, relative to it."""
    return max(float((got[k].to(w.device, torch.float32) - w).norm()
                     / w.norm().clamp_min(1e-30)) for k, w in want.items())


def compare(runs: list, ref_hist: list, ref_final: dict, ref_first: dict,
            limits: dict) -> tuple:
    """The numbers compared, each the worst over every simulation of
    ``runs`` ``(history, final, first)``: the difference in rounds and in
    any round's simulated hours, the first round's global model and
    accuracy, and the final global model. Also how many simulations fail
    a limit."""
    worst = dict(rounds=0.0, hours=0.0, round1_gap=0.0, acc1_gap=0.0,
                 final_gap=0.0)
    bad = 0
    for hist, final, first in runs:
        one = dict(
            rounds=float(abs(len(hist) - len(ref_hist))),
            hours=max((abs(a[0] - b[0]) for a, b in zip(hist, ref_hist)),
                      default=0.0),
            round1_gap=_leaf_gap(first, ref_first),
            acc1_gap=abs(hist[0][2] - ref_hist[0][2]),
            final_gap=_leaf_gap(final, ref_final))
        bad += int(any(one[k] > limits[k] for k in one))
        worst = {k: max(worst[k], one[k]) for k in worst}
    return worst, bad


def check(st, log):
    t = time.perf_counter()
    ref = reference(st)
    log(f"reference: {len(ref[0])} rounds in "
        f"{time.perf_counter() - t:.2f} s, final accuracy "
        f"{ref[0][-1][2] if ref[0] else float('nan')}")
    limits = st.cell.workload["limits"]
    found, bad = compare(st.runs, *ref, limits)
    return {k: {"value": v, "limit": limits[k]}
            for k, v in found.items()}, bad

