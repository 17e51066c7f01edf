"""Dry run on the meta device: trace every (arch x shape x mesh) step of
one device without allocating anything (port of ``repro.launch.dryrun``).

For each combination this driver:
  1. builds the production mesh (16x16 single-pod / 2x16x16 multi-pod,
     with ``make_constellation_map``'s 4 x 4 satellites a pod) on torch's
     fake process group, for the steps' collectives;
  2. makes the params and the step's inputs on the meta device (the
     torch counterpart of ``ShapeDtypeStruct``: shapes and dtypes, no
     memory), one device's shard of them: the batch over the lead axes
     (``launch/specs.py``) and every leaf over ``model`` by its sanitized
     spec (``models/sharding.py``);
  3. runs the right step (train / prefill / serve) once under a
     ``TorchDispatchMode`` that sees every aten op, with the kernels'
     and the collectives' meter installed (``kernels/meter.py``);
  4. writes a JSON artifact to ``runs/dryrun_torch/`` for the roofline
     stage (``launch/roofline.py``), with the JAX artifact's keys.

The artifact, per device:
  - ``cost_analysis``: ``flops``, the matmul-class aten ops (mm, addmm,
    bmm, baddbmm, convolution and their backwards: the formulas of
    ``torch.utils.flop_counter``) plus the hand-written kernels' own
    counts (their modules' cost functions); ``flops f32``, the part of
    them outside the tensor cores (f32 operands, and the recurrences'
    and the fold's kernels, which run on the CUDA cores); ``bytes
    accessed``, every aten op's operand and result bytes (views, which
    move nothing, and ``empty``, which writes nothing, count 0) plus the
    kernels' bytes.
  - ``memory_analysis``: ``argument_size_in_bytes`` (the params' and the
    inputs' storages, exact), ``output_size_in_bytes`` (the result's
    storages that are not arguments: a decode step's cache is updated in
    place) and ``temp_size_in_bytes``, the peak of the storages live at
    once among those the step allocated (the outputs' included while
    they are live), read from each storage's allocation and release.
  - ``collectives``: each collective's count and output bytes, in the
    layout of the JAX package's ``parse_collective_bytes``.
  - ``kernels``: calls, FLOP and bytes of each kernel.
  - ``param_count`` / ``active_param_count`` from ``Transformer``.
  - ``model_axis``: ``"sharded"``: each device holds its shard of every
    leaf, so the per-device params bytes are the JAX package's sanitized
    shards'; ``sharding``: each leaf's sanitized spec and local shape,
    and the leaves the layers gathered at use (heads that ``model`` does
    not divide) or once a step (leaves ``sanitize_specs`` relocated).
    The ``model`` axis's all-reduces and all-gathers are metered with the
    round's collectives.
  - ``aten_ops``: the ops traced. ``lower_s`` is the trace's seconds;
    nothing compiles, so ``compile_s`` is 0 and ``hlo_lines`` null.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-0.6b \\
      --shape train_4k --mesh single [--round fedhap|fedhap_fused|fedavg]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both

Runs on the CPU, builds no kernel and touches no card. The fake process
group (``torch.testing._internal.distributed.fake_pg``) is an internal
torch API: it is used here only, and the dry run fails with a clear
error where it is missing.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import pathlib
import time
import traceback
import weakref
from typing import Any, Callable, Iterator

import torch
import torch.distributed as dist
from torch.utils import flop_counter
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.configs import SHAPES, get_config, list_configs
from repro_torch.kernels import meter as meter_lib
from repro_torch.launch import specs as specs_lib
from repro_torch.models import sharding
from repro_torch.models.transformer import Transformer

#: The production meshes: 16 x 16 for one pod, 2 x 16 x 16 for two.
MESHES = {False: ((16, 16), ("data", "model")),
          True: ((2, 16, 16), ("pod", "data", "model"))}

_TENSOR_CORE_DTYPES = (torch.bfloat16, torch.float16)
_aten = torch.ops.aten
#: Ops that allocate and write nothing: no bytes accessed.
_NO_BYTES = {_aten.empty.memory_format, _aten.empty_strided.default,
             _aten.empty_like.default, _aten.new_empty.default,
             _aten.new_empty_strided.default}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class Trace(TorchDispatchMode):
    """Counts every aten op it sees: matmul-class FLOP by operand dtype,
    operand and result bytes, and the bytes of the storages the traced
    code allocates that are live at once (their peak). Storages alive
    when the trace starts (:meth:`arguments`) are not the step's
    allocations and are left out of the peak. A storage is known by its
    C++ address (``_cdata``: a meta storage has no data pointer) while it
    lives; ``weakref.finalize`` on it releases its bytes when the last
    tensor or view of it goes, saved-for-backward ones included."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.flops_f32 = 0
        self.bytes = 0
        self.ops = 0
        self.live = 0
        self.peak = 0
        self._args: set[int] = set()
        self._tracked: dict[int, int] = {}

    def arguments(self, tensors: list[torch.Tensor]) -> int:
        """Mark the storages of ``tensors`` as arguments; returns their
        bytes, each storage counted once."""
        total = 0
        for t in tensors:
            st = t.untyped_storage()
            if st._cdata not in self._args:
                self._args.add(st._cdata)
                total += st.nbytes()
        return total

    def _free(self, key: int) -> None:
        self.live -= self._tracked.pop(key, 0)

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._args:
            return
        n = st.nbytes()
        known = self._tracked.get(key)
        if known is None:
            self._tracked[key] = n
            weakref.finalize(st, self._free, key)
            self.live += n
        elif n > known:                       # resized in place
            self._tracked[key] = n
            self.live += n - known
        self.peak = max(self.peak, self.live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.ops += 1
        packet = func._overloadpacket
        if packet in flop_counter.flop_registry:
            flops = int(flop_counter.flop_registry[packet](
                *args, **kwargs, out_val=out))
            self.flops += flops
            first = next(a for a in tree_flatten((args, kwargs))[0]
                         if isinstance(a, torch.Tensor))
            if first.dtype not in _TENSOR_CORE_DTYPES:
                self.flops_f32 += flops
        outs = [t for t in tree_flatten(out)[0]
                if isinstance(t, torch.Tensor)]
        if not func.is_view and func not in _NO_BYTES:
            ins = [t for t in tree_flatten((args, kwargs))[0]
                   if isinstance(t, torch.Tensor)]
            self.bytes += sum(_nbytes(t) for t in ins + outs)
        for t in outs:
            self._track(t)
        return out


@dataclasses.dataclass
class Counts:
    """What one traced call cost on one device."""
    flops: int
    flops_f32: int
    bytes: int
    ops: int
    argument_bytes: int
    output_bytes: int
    temp_bytes: int
    kernels: dict
    collectives: dict
    seconds: float
    gathered: tuple = ()
    flops_tf32x3: int = 0

    def cost_analysis(self) -> dict:
        return {"flops": float(self.flops),
                "flops f32": float(self.flops_f32),
                "flops tf32x3": float(self.flops_tf32x3),
                "bytes accessed": float(self.bytes)}

    def memory_analysis(self) -> dict:
        return {"argument_size_in_bytes": self.argument_bytes,
                "output_size_in_bytes": self.output_bytes,
                "temp_size_in_bytes": self.temp_bytes}


def trace(fn: Callable, *args: Any) -> tuple[Any, Counts]:
    """Run ``fn(*args)`` once (meta tensors in ``args``) under
    :class:`Trace` and a fresh meter; returns its result and
    :class:`Counts`, the kernels' and the collectives' reports added."""
    t0 = time.perf_counter()
    flat_args = [t for t in tree_flatten(args)[0]
                 if isinstance(t, torch.Tensor)]
    tr = Trace()
    with meter_lib.metering() as m:
        arg_bytes = tr.arguments(flat_args)
        with tr:
            out = fn(*args)
    k_flops, k_bytes, k_f32, k_tf32x3 = m.kernel_totals()
    seen, out_bytes = set(), 0
    for t in tree_flatten(out)[0]:
        if isinstance(t, torch.Tensor):
            st = t.untyped_storage()
            if st._cdata not in tr._args and st._cdata not in seen:
                seen.add(st._cdata)
                out_bytes += st.nbytes()
    return out, Counts(
        flops=tr.flops + k_flops, flops_f32=tr.flops_f32 + k_f32,
        flops_tf32x3=k_tf32x3,
        bytes=tr.bytes + k_bytes, ops=tr.ops, argument_bytes=arg_bytes,
        output_bytes=out_bytes, temp_bytes=tr.peak, kernels=m.kernels,
        collectives=m.collective_summary(),
        seconds=time.perf_counter() - t0)


@contextlib.contextmanager
def fake_mesh(shape: tuple[int, ...], names: tuple[str, ...]) -> Iterator:
    """A ``DeviceMesh`` of ``shape`` over torch's fake process group, seen
    from rank 0: collectives on it would complete without moving data,
    and the port's own primitives, given meta tensors, do not call them
    (``core/mesh_round.py``). The group is destroyed on exit. Raises
    ``RuntimeError`` where torch has no fake backend, or where a process
    group is already initialised."""
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:          # an internal API: say what is missing
        raise RuntimeError(
            "the dry run builds its mesh on torch's fake process group "
            "(torch.testing._internal.distributed.fake_pg), which this "
            "torch does not have") from e
    from torch.distributed.device_mesh import init_device_mesh
    if dist.is_initialized():
        raise RuntimeError("the dry run starts a fake process group of its "
                           "own, but one is already initialised")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=math.prod(shape))
    try:
        yield init_device_mesh("cpu", shape, mesh_dim_names=names)
    finally:
        dist.destroy_process_group()


def meta_params(model: Transformer, lead: tuple[int, ...] = (),
                dtype: torch.dtype = torch.bfloat16,
                specs: dict | None = None, m: int = 1) -> dict:
    """The model's params on the meta device in ``dtype``, each leaf with
    ``lead`` prepended (the satellite dim of a train step's shard); with
    ``specs`` (sanitized trailing specs), one of ``m`` devices' shard
    over ``model``."""
    return {k: torch.empty(lead + sharding.local_shape(
                d.shape, None if specs is None else specs[k], m),
                           dtype=dtype, device="meta")
            for k, d in model.defs().items()}


def _shard(x: torch.Tensor, n: int) -> torch.Tensor:
    """One device's block of ``x``'s leading dim over ``n`` devices."""
    return torch.empty((x.shape[0] // n,) + tuple(x.shape[1:]),
                       dtype=x.dtype, device="meta")


def device_batch(multi_pod: bool, batch: int,
                 sizes: dict | None = None) -> int:
    """One device's share of a serving batch on the production mesh (or
    on a mesh of axis ``sizes``): the batch over the devices
    ``specs._dp`` splits it over."""
    if sizes is None:
        shape, names = MESHES[multi_pod]
        sizes = dict(zip(names, shape))
    axes = specs_lib._dp(multi_pod, batch, sizes)
    return batch // (math.prod(sizes[a] for a in axes) if axes else 1)


def trace_step(cfg, shape_name: str, multi_pod: bool,
               round_kind: str = "fedhap", partial_mode: str = "paper",
               local_steps: int = 1, ship_echo: bool = True,
               what: str = "step",
               mesh_shape: tuple[int, ...] | None = None) -> Counts:
    """Trace one device's step of ``cfg`` at ``shape_name``: ``what`` is
    ``"step"`` (the whole step), or for a train shape ``"round"`` (the
    FedHAP round alone, on the model's shards). ``mesh_shape`` replaces
    the production mesh's shape (same axis names)."""
    shape = SHAPES[shape_name]
    model = Transformer(cfg)
    default, names = MESHES[multi_pod]
    mesh_shape = tuple(mesh_shape or default)
    sizes = dict(zip(names, mesh_shape))
    specs = specs_lib.model_specs(model, sizes)
    m = sizes["model"]
    with fake_mesh(mesh_shape, names) as mesh:
        if shape.mode == "train":
            step, _, _, cmap = specs_lib.make_train_step(
                model, mesh, round_kind=round_kind,
                partial_mode=partial_mode, ship_global_echo=ship_echo,
                local_steps=local_steps)
            n = math.prod(sizes[a] for a in names if a != "model")
            spec = specs_lib.train_input_specs(cfg, shape, cmap)
            batch = {k: _shard(v, n) for k, v in spec["batch"].items()}
            params = meta_params(model, (1,), specs=specs, m=m)
            sat_sizes, visible = (_shard(spec[k], n)
                                  for k in ("sizes", "visible"))
            if what == "round":
                from repro_torch.core.mesh_round import (FedRoundConfig,
                                                         build_round)
                rcfg = FedRoundConfig(cmap=cmap, partial_mode=partial_mode,
                                      ship_global_echo=ship_echo)
                fn = build_round(mesh, rcfg, None, model_specs=specs,
                                 kind=round_kind)
                return trace(fn, params, sat_sizes, visible)[1]
            counts = trace(step, params, batch, sat_sizes, visible)[1]
            axis = step.axis
        else:
            params = meta_params(model, specs=specs, m=m)
            b = device_batch(multi_pod, shape.global_batch, sizes)
            if shape.mode == "prefill":
                inputs = {k: _shard(v, shape.global_batch // b) for k, v in
                          specs_lib.prefill_input_specs(cfg, shape).items()}
                fn = specs_lib.make_prefill_step(model, mesh)
                counts = trace(fn, params, inputs)[1]
            else:
                use_window = specs_lib.use_window_for(cfg, shape)
                fn = specs_lib.make_serve_step(model, use_window, mesh)
                inputs = specs_lib.decode_input_specs(
                    cfg, shape, model, use_window, batch=b, axis=fn.axis)
                counts = trace(fn, params, inputs["cache"],
                               inputs["token"])[1]
            axis = fn.axis
    counts.gathered = tuple(sorted(axis.gathered))
    return counts


def lower_one(arch: str, shape_name: str, multi_pod: bool,
              round_kind: str = "fedhap", partial_mode: str = "paper",
              local_steps: int = 1,
              mesh_shape: tuple[int, ...] | None = None) -> dict:
    """Trace one combination; returns the artifact dict."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    counts = trace_step(cfg, shape_name, multi_pod, round_kind,
                        partial_mode, local_steps, mesh_shape=mesh_shape)
    model = Transformer(cfg)
    default, names = MESHES[multi_pod]
    mesh_shape = tuple(mesh_shape or default)
    m = dict(zip(names, mesh_shape))["model"]
    specs = specs_lib.model_specs(model, dict(zip(names, mesh_shape)))
    train = shape.mode == "train"
    return {
        "arch": arch,
        "shape": shape_name,
        "mesh": "x".join(map(str, mesh_shape)),
        "mode": shape.mode,
        "round_kind": round_kind if train else None,
        "partial_mode": partial_mode if train else None,
        "devices": math.prod(mesh_shape),
        "lower_s": round(counts.seconds, 1),
        "compile_s": 0.0,
        "memory_analysis": counts.memory_analysis(),
        "cost_analysis": counts.cost_analysis(),
        "collectives": counts.collectives,
        "kernels": counts.kernels,
        "param_count": model.count_params(),
        "active_param_count": model.active_param_count(),
        "model_axis": "sharded",
        "sharding": {
            "specs": {k: list(s) for k, s in specs.items()},
            "local_shapes": {k: list(sharding.local_shape(d.shape, specs[k],
                                                          m))
                             for k, d in model.defs().items()},
            "gathered": list(counts.gathered),
        },
        "aten_ops": counts.ops,
        "hlo_lines": None,
    }


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list_configs())
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--round", dest="round_kind", default="fedhap",
                    choices=["fedhap", "fedhap_fused", "fedavg"])
    ap.add_argument("--partial-mode", default="paper",
                    choices=["paper", "exact"])
    ap.add_argument("--all", action="store_true",
                    help="run every (arch x shape) for the given mesh")
    ap.add_argument("--out", default="runs/dryrun_torch")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)

    outdir = pathlib.Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    if args.all:
        combos = [(a, s) for a in list_configs() for s in SHAPES]
    elif args.arch and args.shape:
        combos = [(args.arch, args.shape)]
    else:
        ap.error("give --arch and --shape, or --all")

    failures = []
    for arch, shape in combos:
        for multi_pod in meshes:
            mesh_tag = "multi" if multi_pod else "single"
            suffix = ("" if args.round_kind == "fedhap"
                      else f"_{args.round_kind}")
            name = f"{arch}_{shape}_{mesh_tag}{suffix}.json"
            path = outdir / name
            if args.skip_existing and path.exists():
                print(f"[skip] {name}")
                continue
            print(f"[dryrun] {arch} x {shape} x {mesh_tag} "
                  f"({args.round_kind}) ...", flush=True)
            try:
                art = lower_one(arch, shape, multi_pod,
                                round_kind=args.round_kind,
                                partial_mode=args.partial_mode)
            except Exception as e:    # one combination; the sweep goes on
                failures.append((arch, shape, mesh_tag, repr(e)))
                print(f"  FAILED: {e}\n{traceback.format_exc()}",
                      flush=True)
                continue
            path.write_text(json.dumps(art, indent=1))
            print(f"  ok: trace={art['lower_s']}s "
                  f"flops={art['cost_analysis']['flops']:.3e} "
                  f"coll={art['collectives']['total_bytes']:.3e}B "
                  f"mem={art['memory_analysis']}", flush=True)
    if failures:
        print("FAILURES:")
        for f in failures:
            print(" ", f)
        raise SystemExit(1)
    print("dry-run complete")


if __name__ == "__main__":
    main()
