"""Roofline of every (arch x shape) step on one NVIDIA H100 from the dry
run's counts (port of ``repro.launch.roofline``).

The card's terms, per device:

    compute    = (FLOP - FLOP_f32 - FLOP_tf32x3) / BF16_FLOP_PER_S
                 + FLOP_f32 / F32_FLOP_PER_S
                 + FLOP_tf32x3 / TF32X3_FLOP_PER_S
    memory     = bytes accessed / HBM_BYTES_PER_S
    collective = collective bytes / LINK_BYTES_PER_S

``FLOP_f32`` is the work outside the tensor cores: matmuls on f32
operands (TF32 is off, PyTorch's default) and the recurrences' and the
fold's kernels, which run on the CUDA cores. ``FLOP_tf32x3`` is f32 work
on the tensor cores as 3xTF32 (flash attention's ``mma`` kernels: three
TF32 products a term), at a third of TF32's rate. The peaks are the H100 SXM5
80GB data sheet's, dense, at its 700 W power limit (NVIDIA H100 80GB
HBM3, power limit 700.00 W, is the card ``chip_smoke.py`` runs on); a
card set below that limit runs slower under load. The link term: a
16 x 16 mesh of 256 GPUs cannot sit inside one 8-GPU NVLink domain, so
the mesh's collectives cross nodes, at each GPU's inter-node bandwidth,
one 400 Gb/s NDR InfiniBand port (50e9 B/s). These are bounds computed
from counts, not measurements.

Eager torch runs, and the dry run counts, every op of every layer, so
the JAX module's per-period differencing (``_variant``: 1 and 2 periods,
extrapolated) is not needed: the step is traced once at full depth. As
``_variant`` does, the compute count is made with ``remat=False``: the
recomputed forward of activation checkpointing is not the step's own
work. For ``train`` shapes the FedHAP round is also traced on its own at
the model's shards and reported as ``aggregation`` (it is part of the
step's counts already). Every count is one device's, its params its
shards over ``model`` (``model_axis: "sharded"``): the collective term
holds the ``model`` axis's all-reduces and all-gathers (the
tensor-parallel layers' and the gathered leaves') beside the round's.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.roofline --arch qwen3-0.6b \\
      --shape prefill_32k
  PYTHONPATH=src python -m repro_torch.launch.roofline --all

Runs on the CPU through ``launch/dryrun.py``: nothing is allocated on a
device and no kernel is built.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import pathlib
import traceback

from repro_torch.configs import SHAPES, get_config, list_configs
from repro_torch.launch import dryrun
from repro_torch.models.transformer import Transformer

#: H100 SXM5 80GB data sheet, dense, at 700 W: bf16 on the tensor cores.
BF16_FLOP_PER_S = 989e12
#: The same, f32 outside the tensor cores.
F32_FLOP_PER_S = 67e12
#: The same, TF32 on the tensor cores.
TF32_FLOP_PER_S = 495e12
#: f32 on the tensor cores as 3xTF32 (three TF32 products a term).
TF32X3_FLOP_PER_S = TF32_FLOP_PER_S / 3
#: The same, HBM3.
HBM_BYTES_PER_S = 3.35e12
#: One 400 Gb/s NDR InfiniBand port a GPU, the inter-node link.
LINK_BYTES_PER_S = 50e9
#: The card the peaks are for.
CARD = "NVIDIA H100 80GB HBM3, power limit 700.00 W"

_SUGGEST = {
    "compute": ("raise the tensor cores' share: keep matmuls in bf16 "
                "(f32 operands run at 67 of 989 TFLOP/s), fuse the hot "
                "matmul chains into fewer, larger kernels, and drop the "
                "recomputed forward where memory allows"),
    "memory": ("cut HBM traffic: fuse the elementwise passes (casts, "
               "norms, adds) into the kernels around them, keep "
               "activations in bf16, and read each cache or weight once a "
               "step"),
    "collective": ("replace the K-hop ring echo with the fused "
                   "closed-form round (one all-reduce), overlap the "
                   "'model' axis's all-reduces and the round's "
                   "collectives with local compute, or gather fewer "
                   "leaves (heads that 'model' does not divide)"),
}


def compute_s(flops: float, flops_f32: float,
              flops_tf32x3: float = 0.0) -> float:
    """Seconds the card needs at least for ``flops``, of which
    ``flops_f32`` run outside the tensor cores and ``flops_tf32x3`` on
    them as 3xTF32."""
    return ((flops - flops_f32 - flops_tf32x3) / BF16_FLOP_PER_S
            + flops_f32 / F32_FLOP_PER_S
            + flops_tf32x3 / TF32X3_FLOP_PER_S)


def bound_ms(flops: float, nbytes: float, tensor_cores: bool,
             f32: bool = False) -> tuple[float, str]:
    """A kernel call's bound: the larger of its FLOP over the card's rate
    for them (bf16 on the tensor cores, f32 on them as 3xTF32 with
    ``f32``, or f32 outside them) and its bytes over HBM's; in ms, and
    which of the two bounds it (``"operations"`` or ``"bytes"``)."""
    rate = (F32_FLOP_PER_S if not tensor_cores
            else TF32X3_FLOP_PER_S if f32 else BF16_FLOP_PER_S)
    t_ops = flops / rate
    t_bytes = nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _totals(c: dryrun.Counts) -> dict:
    return {"flops": float(c.flops), "flops_f32": float(c.flops_f32),
            "flops_tf32x3": float(c.flops_tf32x3),
            "bytes": float(c.bytes),
            "coll_bytes": float(c.collectives["total_bytes"]),
            "coll_detail": {k: v for k, v in c.collectives.items()
                            if isinstance(v, dict) and v["count"]}}


def roofline_one(arch: str, shape_name: str, multi_pod: bool = False,
                 round_kind: str = "fedhap", partial_mode: str = "paper",
                 ship_echo: bool = True,
                 overrides: dict | None = None,
                 mesh_shape: tuple[int, ...] | None = None) -> dict:
    """One cell's terms; ``mesh_shape`` replaces the production mesh's
    shape (same axis names)."""
    cfg = get_config(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    cfg = dataclasses.replace(cfg, remat=False)
    shape = SHAPES[shape_name]
    mesh_shape = tuple(mesh_shape or dryrun.MESHES[multi_pod][0])
    chips = math.prod(mesh_shape)
    total = _totals(dryrun.trace_step(cfg, shape_name, multi_pod, round_kind,
                                      partial_mode, ship_echo=ship_echo,
                                      mesh_shape=mesh_shape))
    agg = None
    if shape.mode == "train":
        agg = _totals(dryrun.trace_step(cfg, shape_name, multi_pod,
                                        round_kind, partial_mode,
                                        ship_echo=ship_echo, what="round",
                                        mesh_shape=mesh_shape))

    n_active = Transformer(cfg).active_param_count()
    if shape.mode == "train":
        model_flops = 6.0 * n_active * shape.global_batch * shape.seq_len
    elif shape.mode == "prefill":
        model_flops = 2.0 * n_active * shape.global_batch * shape.seq_len
    else:
        model_flops = 2.0 * n_active * shape.global_batch
    model_flops_dev = model_flops / chips

    terms = {
        "compute_s": compute_s(total["flops"], total["flops_f32"],
                               total["flops_tf32x3"]),
        "memory_s": total["bytes"] / HBM_BYTES_PER_S,
        "collective_s": total["coll_bytes"] / LINK_BYTES_PER_S,
    }
    dominant = max(terms, key=lambda k: terms[k]).replace("_s", "")
    train = shape.mode == "train"
    return {
        "arch": arch,
        "shape": shape_name,
        "mesh": "x".join(map(str, mesh_shape)),
        "mode": shape.mode,
        "round_kind": round_kind if train else None,
        "partial_mode": partial_mode if train else None,
        "ship_echo": ship_echo if train else None,
        "chips": chips,
        "card": CARD,
        "model_axis": "sharded",
        "per_device": total,
        "aggregation": agg,
        "terms_s": terms,
        "dominant": dominant,
        "model_flops_per_device": model_flops_dev,
        "useful_flops_ratio": (model_flops_dev / total["flops"]
                               if total["flops"] else 0.0),
        "suggestion": _SUGGEST[dominant],
    }


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list_configs())
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--mesh", choices=["single", "multi"], default="single")
    ap.add_argument("--round", dest="round_kind", default="fedhap",
                    choices=["fedhap", "fedhap_fused", "fedavg"])
    ap.add_argument("--partial-mode", default="paper",
                    choices=["paper", "exact"])
    ap.add_argument("--no-echo", dest="ship_echo", action="store_false")
    ap.add_argument("--override", action="append", default=[],
                    help="cfg field override, e.g. num_layers=4")
    ap.add_argument("--tag", default="",
                    help="artifact filename suffix for variants")
    ap.add_argument("--out", default="runs/roofline_torch")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)
    overrides = {}
    for ov in args.override:
        k, v = ov.split("=", 1)
        overrides[k] = (int(v) if v.lstrip("-").isdigit()
                        else (v == "True" if v in ("True", "False")
                              else v))
    if args.all:
        combos = [(a, s) for a in list_configs() for s in SHAPES]
    elif args.arch and args.shape:
        combos = [(args.arch, args.shape)]
    else:
        ap.error("give --arch and --shape, or --all")

    outdir = pathlib.Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)
    multi = args.mesh == "multi"
    failures = []
    for arch, shape in combos:
        suffix = "" if args.round_kind == "fedhap" else f"_{args.round_kind}"
        if not args.ship_echo:
            suffix += "_noecho"
        if args.tag:
            suffix += f"_{args.tag}"
        name = f"{arch}_{shape}_{args.mesh}{suffix}.json"
        path = outdir / name
        if args.skip_existing and path.exists():
            print(f"[skip] {name}")
            continue
        print(f"[roofline] {arch} x {shape} ({args.round_kind}) ...",
              flush=True)
        try:
            art = roofline_one(arch, shape, multi, args.round_kind,
                               args.partial_mode, args.ship_echo,
                               overrides=overrides or None)
        except Exception as e:        # one combination; the sweep goes on
            failures.append((arch, shape, repr(e)))
            print(f"  FAILED: {e}\n{traceback.format_exc()}", flush=True)
            continue
        art["overrides"] = overrides
        path.write_text(json.dumps(art, indent=1))
        t = art["terms_s"]
        print(f"  compute={t['compute_s']:.4f}s "
              f"memory={t['memory_s']:.4f}s "
              f"collective={t['collective_s']:.4f}s "
              f"dominant={art['dominant']} "
              f"useful={art['useful_flops_ratio']:.4f}", flush=True)
    if failures:
        print("FAILURES:")
        for f in failures:
            print(" ", f)
        raise SystemExit(1)


if __name__ == "__main__":
    main()
