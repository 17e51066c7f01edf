#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout on a machine with one NVIDIA card:

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises (exit code != 0):

1. device — require CUDA; print the card's name and power limit;
2. build  — compile every kernel of ``src/repro_torch/kernels/csrc`` with
   nvcc for sm_90a, all sources at once;
3. kernels — hold each kernel against its plain PyTorch version on the
   card, at the main path's shapes and at ragged ones, and time kernel,
   plain version and the one-call PyTorch yardstick (``library_ms``,
   timed here only; the port never calls it);
4. card vs CPU — one round of the default config at full width (except
   ``local_steps=2``) through ``FusedExecutor.run_block`` on the card
   and on the CPU from the same init: params must agree;
5. slice — ``RoundEngine(SimConfig(max_rounds=16)).run()`` on the card:
   FedHAP, 40 satellites, the paper CNN, 70k digits, 54 local steps, two
   fused blocks of up to 8 rounds (the 72 h horizon ends it at 15).
   The kernel launch counts are zeroed just before and read just after;
   every kernel of the path must have run;
6. profile — one more full-width round under torch.profiler: device
   time by kernel and the device's busy share of the round.

Prints a ``{"kernels": [...]}`` JSON line, the card line, and last
``{"ok": true, "device": {...}}``. Imports nothing of JAX or ``repro``.
"""
from __future__ import annotations

import json
import math
import pathlib
import subprocess
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent

# H100 SXM data sheet (dense, at the 700 W limit): HBM rate and the f32
# rate outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12

# Kernel-vs-plain tolerances: those of the JAX package's own kernel sweep
# (tests/test_kernels.py). f32: the kernel's sequential FMA chain and the
# plain version's separately rounded multiply + tree sum differ by a few
# ulps of an O(5) sum. bf16: one bf16 ulp of the rounded output.
TOL = {"float32": dict(atol=3e-5, rtol=1e-4),
       "bfloat16": dict(atol=5e-2, rtol=5e-2)}
# Card vs CPU after one round of 2 SGD steps + the fold, both full f32
# (TF32 off): the convolutions and matmuls reduce in other orders, which
# moves O(0.05) params by a few f32 ulps per step.
PARAM_TOL = dict(atol=1e-5, rtol=1e-4)


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def nvidia_smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", f"--query-gpu={query}",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip()


def time_ms(torch, fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def max_err(torch, got, want) -> float:
    return float((got.float() - want.float()).abs().max())


def check_close(torch, got, want, dtype_name: str, what: str) -> float:
    err = max_err(torch, got, want)
    tol = TOL[dtype_name]
    ok = torch.allclose(got.float(), want.float(), **tol)
    if not ok:
        raise AssertionError(f"{what}: kernel disagrees with its plain "
                             f"version, max |err| {err:.3e} ({tol})")
    return err


def phase_kernels(torch, fedagg_mod, ops, leaf_shapes, n_sats):
    """fedagg on the card against fedagg_plain; returns the kernels-line
    entry (launches filled in later from the main path)."""
    fedagg, fedagg_plain = fedagg_mod.fedagg, fedagg_mod.fedagg_plain
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    w = torch.rand(n_sats, generator=gen, device=dev)

    # Main path: the CNN's 8 leaves, S=40, f32.
    xs = [torch.randn((n_sats, int(np.prod(shape))), generator=gen,
                      device=dev) for shape in leaf_shapes.values()]
    worst = 0.0
    rows = []
    for (name, shape), x in zip(leaf_shapes.items(), xs):
        err = check_close(torch, fedagg(x, w), fedagg_plain(x, w),
                          "float32", f"leaf {name}")
        worst = max(worst, err)
        p = x.shape[1]
        nbytes = (n_sats * p + p) * 4 + n_sats * 4
        rows.append(dict(
            leaf=name, P=p, max_abs_err=err,
            ms=time_ms(torch, lambda x=x: fedagg(x, w)),
            plain_ms=time_ms(torch, lambda x=x: fedagg_plain(x, w)),
            library_ms=time_ms(torch, lambda x=x: torch.mv(x.t(), w)),
            bound_ms=1e3 * max(nbytes / HBM_BYTES_PER_S,
                               2 * n_sats * p / F32_FLOP_PER_S),
            bytes=nbytes))
    for r in rows:
        log("kernels", "fedagg leaf " + json.dumps(r))

    # One whole fold (all 8 leaves, as a round runs it).
    fold = lambda f: [f(x) for x in xs]                       # noqa: E731
    total_bytes = sum(r["bytes"] for r in rows)
    total_flop = sum(2 * n_sats * r["P"] for r in rows)
    fold_ms = time_ms(torch, lambda: fold(lambda x: fedagg(x, w)))
    plain_ms = time_ms(torch, lambda: fold(lambda x: fedagg_plain(x, w)))
    lib_ms = time_ms(torch, lambda: fold(lambda x: torch.mv(x.t(), w)))
    bound_ms = 1e3 * max(total_bytes / HBM_BYTES_PER_S,
                         total_flop / F32_FLOP_PER_S)
    bound_by = ("bytes" if total_bytes / HBM_BYTES_PER_S
                >= total_flop / F32_FLOP_PER_S else "operations")
    log("kernels", f"fedagg fold of {len(xs)} leaves, S={n_sats}, "
        f"{total_bytes} bytes: kernel {fold_ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, torch.mv {lib_ms:.4f} ms, bound "
        f"{bound_ms:.4f} ms ({bound_by}); kernel at "
        f"{total_bytes / fold_ms / 1e6:.1f} GB/s")

    # Ragged shapes and unaligned views, f32 and bf16.
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        for s, p, offset in ((1, 7, 0), (40, 7, 0), (3, 1001, 0),
                             (40, 333, 0), (40, 4096, 0), (8, 4096, 1),
                             (5, 1003, 1)):
            gw = torch.rand(s, generator=gen, device=dev)
            base = torch.randn(s * p + offset, generator=gen,
                               device=dev).to(dtype)
            x = base[offset:].view(s, p)
            err = check_close(torch, fedagg(x, gw), fedagg_plain(x, gw),
                              dname, f"{dname} S={s} P={p} off={offset}")
            log("kernels", f"fedagg {dname} S={s} P={p} "
                f"unaligned={bool(offset)}: max |err| {err:.3e}")

    # Zero-weight padding rows add exactly zero.
    tree = {k: x.view(n_sats, *shape)
            for (k, shape), x in zip(leaf_shapes.items(), xs)}
    padded, pw = ops.pad_stacked_rows(tree, w, 16)
    a = ops.fold_stacked_tree(tree, w)
    b = ops.fold_stacked_tree(padded, pw)
    if not all(torch.equal(a[k], b[k]) for k in a):
        raise AssertionError("zero-weight padded rows changed the fold")
    log("kernels", f"zero-weight padding to {pw.numel()} rows: "
        f"fold bit-equal")
    del xs, tree, padded
    return dict(name="fedagg", route="cuda",
                source="src/repro_torch/kernels/csrc/fedagg.cu",
                replaces="src/repro/kernels/fedagg.py:30",
                launches=None, max_abs_err=worst, ms=fold_ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=lib_ms)


def phase_card_vs_cpu(torch, eng, sim):
    """One full-width round with local_steps=2 on the card and on the
    CPU from the same init, through FusedExecutor.run_block."""
    from repro_torch.models.params import params_to_numpy, params_from_numpy
    from repro_torch.sim.strategies import FedHap

    steps = 2
    plan = FedHap().plan_round(eng, 0.0)
    rng = np.random.default_rng((eng.cfg.seed, 4))
    idx = eng.trainer.sample_client_indices(
        eng.fd, np.arange(eng.n_sats), steps, rng)[None]
    mu = np.asarray(plan.mu, np.float32)[None]
    flags = np.ones(1, bool)
    init = params_to_numpy(eng.trainer.init(eng.cfg.seed))

    outs = {}
    for device, ex in (("cuda", eng.executor),
                       ("cpu", sim.FusedExecutor(
                           sim.LocalTrainer(eng.trainer.model,
                                            eng.cfg.learning_rate,
                                            eng.cfg.batch_size, "cpu"),
                           eng.fd, eng.eval_images, eng.eval_labels))):
        t0 = time.perf_counter()
        params, accs = ex.run_block(params_from_numpy(init, device), idx,
                                    mu, flags, flags)
        if device == "cuda":
            torch.cuda.synchronize()
        outs[device] = (params_to_numpy(params), float(accs[0]))
        log("card-vs-cpu", f"{device}: one round ({eng.n_sats} replicas x "
            f"{steps} steps + fold + eval) in "
            f"{time.perf_counter() - t0:.3f} s, acc {accs[0]:.6f}")
    worst = 0.0
    for k, want in outs["cpu"][0].items():
        got = outs["cuda"][0][k]
        worst = max(worst, float(np.abs(got - want).max()))
        np.testing.assert_allclose(got, want, **PARAM_TOL,
                                   err_msg=f"param {k}: card vs CPU")
    n_eval = len(eng.eval_labels)
    dacc = abs(outs["cuda"][1] - outs["cpu"][1])
    # Accuracy: at most two flipped predictions of the eval set.
    if dacc > 2.0 / n_eval + 1e-7:
        raise AssertionError(f"card vs CPU accuracy differs by {dacc}")
    log("card-vs-cpu", f"params agree: max |card - cpu| {worst:.3e} "
        f"({PARAM_TOL}); accuracy differs by {dacc:.6f}")


def phase_profile(torch, eng):
    """Where one round's device time goes: one planned full-width round
    through ``run_block`` (after a warm-up round) under torch.profiler.
    Prints device time by kernel and the busy share of the round's wall
    time; "not measured" if the profiler records no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.sim.strategies import FedHap

    plan = FedHap().plan_round(eng, 0.0)
    idx = eng.sample_indices(np.arange(eng.n_sats), 0.0)[None]
    mu = np.asarray(plan.mu, np.float32)[None]
    flags = np.ones(1, bool)
    params = eng.trainer.init(eng.cfg.seed)
    eng.executor.run_block(params, idx, mu, flags, flags)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.executor.run_block(params, idx, mu, flags, flags)
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    by_name: dict[str, list] = {}
    spans = []
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            row = by_name.setdefault(ev.name, [0.0, 0])
            row[0] += ev.time_range.elapsed_us()
            row[1] += 1
            spans.append((ev.time_range.start, ev.time_range.end))
    busy_us = sum(r[0] for r in by_name.values())
    if not busy_us:
        log("profile", "device time by kernel: not measured (the profiler "
            "recorded no device activity)")
        return
    # Busy time = the union of the kernels' intervals (kernels that
    # overlap count once); the window runs from the first kernel's start
    # to the last one's end.
    spans.sort()
    union, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    for s, e in spans[1:]:
        if s > cur_e:
            union += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    union += cur_e - cur_s
    window = spans[-1][1] - spans[0][0]
    log("profile", f"one round: host wall {wall_us / 1e3:.3f} ms (profiler "
        f"on), {sum(r[1] for r in by_name.values())} kernels summing to "
        f"{busy_us / 1e3:.3f} ms; device busy (union) {union / 1e3:.3f} ms "
        f"= {100 * union / window:.1f}% of the {window / 1e3:.3f} ms kernel "
        f"window, {100 * union / wall_us:.1f}% of the host wall")
    fold_us = sum(r[0] for n, r in by_name.items() if "fedagg" in n)
    log("profile", f"fedagg: {fold_us:.1f} us "
        f"({100 * fold_us / busy_us:.3f}% of device time)")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    for name, (us, n) in top:
        log("profile", f"{100 * us / busy_us:6.2f}%  {us / 1e3:9.3f} ms  "
            f"x{n:<5d} {name[:110]}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this "
              "script runs on a machine with an NVIDIA card",
              file=sys.stderr)
        return 1
    src = ROOT / "src"
    if not (src / "repro_torch").is_dir():
        print(f"chip_smoke: {src / 'repro_torch'} not found; run from a "
              f"checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(src))

    # 1. device
    card = nvidia_smi("name,power.limit")
    kind = torch.cuda.get_device_name(0)
    log("device", f"{card} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | {kind} x {torch.cuda.device_count()}")

    # 2. build
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    built = build.build()
    for name, info in built.items():
        log("build", f"{name}: {info['seconds']:.2f} s "
            f"(cached={info['cached']})")
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log("build", f"  {line.strip()}")
    log("build", f"all kernels built in {time.perf_counter() - t0:.2f} s")

    # 3. kernels
    from repro_torch import sim
    from repro_torch.kernels import fedagg as fedagg_mod, ops
    eng_t0 = time.perf_counter()
    eng = sim.RoundEngine(sim.SimConfig(max_rounds=16))
    log("slice", f"engine built in {time.perf_counter() - eng_t0:.2f} s: "
        f"{eng.n_sats} satellites, {eng.trainer.model.count_params()} "
        f"params, {len(eng.fd.labels)} train / {len(eng.eval_labels)} eval "
        f"samples, device {eng.device}")
    leaf_shapes = {k: d.shape for k, d in eng.trainer.model.defs().items()}
    entry = phase_kernels(torch, fedagg_mod, ops, leaf_shapes, eng.n_sats)

    # 4. card vs CPU
    phase_card_vs_cpu(torch, eng, sim)

    # 5. the slice, on the card; counts zeroed just before, read after.
    torch.cuda.reset_peak_memory_stats()
    fedagg_mod.fedagg.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fedagg_mod.fedagg.launches
    entry["launches"] = launches
    for t_h, rnd, acc in res.history:
        log("slice", f"round {rnd:3d}  t={t_h:.4f} h  acc={acc:.4f}")
    log("slice", f"{res.rounds} rounds in {wall:.3f} s: "
        f"{wall / max(res.rounds, 1):.4f} s/round (plan + train + fold + "
        f"eval, the first block included); peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
        f"card now {nvidia_smi('clocks.sm,power.draw,temperature.gpu')}")
    n_leaves = len(leaf_shapes)
    # The default 72 h horizon holds 15 FedHAP rounds, so max_rounds=16
    # ends at the horizon: one full block of 8 and one of 7 (its last
    # slot an invalid, carried-through round).
    if res.rounds <= eng.cfg.plan_block:
        raise AssertionError(f"expected more than one block of rounds, "
                             f"ran {res.rounds}")
    if launches != res.rounds * n_leaves:
        raise AssertionError(f"fedagg launched {launches} times in "
                             f"{res.rounds} rounds; expected "
                             f"{res.rounds * n_leaves}")
    accs = [a for _, _, a in res.history]
    if not all(math.isfinite(a) for a in accs) or accs[-1] <= 0.10:
        raise AssertionError(f"accuracies not finite or not above chance: "
                             f"{accs}")
    log("slice", f"fedagg launches on the main path: {launches} "
        f"({n_leaves} per round)")

    # 6. where a round's device time goes (after the counts were read)
    phase_profile(torch, eng)

    print(json.dumps({"kernels": [entry]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
