"""Fused weighted multi-replica aggregation (the FedHAP fold) on Hopper.

``out[p] = Σ_s w[s]·x[s, p]`` over ``x`` of shape ``(S, P)`` (f32 or
bf16) and ``w`` of shape ``(S,)`` (f32), accumulated in f32, returned in
``x``'s dtype. The kernel is ``csrc/fedagg.cu`` (CUDA C++ for sm_90a;
its header has the bound and the design); it replaces the Pallas TPU
kernel ``fedagg`` of ``repro/kernels/fedagg.py:30``.

:func:`fedagg_leaves` folds a list of leaves, each its own ``(S, P_i)``
buffer, in one launch per :data:`MAX_LEAVES` leaves (one per fold of the
paper CNN's 8 leaves); :func:`fedagg` is its one-leaf case. Both check
their inputs and launch the kernel; they take CUDA tensors only. The
choice between kernel and plain version is made in
:mod:`repro_torch.kernels.ops`: CPU tensors go to :func:`fedagg_plain` /
:func:`fedagg_leaves_plain` — only because they lie on the CPU — and a
CUDA tensor never reaches the plain version. The kernel has no backward:
both raise when grad is enabled and an input requires grad
(``guard.autograd_guard``). ``fedagg.launches`` counts kernel launches
(of either entry point). :func:`fedagg_cost` is a fold's FLOP and bytes,
the bound's numerator; :func:`fedagg_leaves_meta` is the fold on meta
tensors, which reports that cost to the dry run's meter.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, meter
from repro_torch.kernels.guard import autograd_guard

_DTYPES = (torch.float32, torch.bfloat16)
MAX_LEAVES = 32            # leaves per launch (kMaxLeaves in fedagg.cu)
VEC_BYTES = 16             # the vector path's load and store width


class _Leaf(ctypes.Structure):
    """One leaf of a launch, as the C launcher takes it (``Leaf`` in
    fedagg.cu, which lays out the blocks)."""
    _fields_ = [("x", ctypes.c_void_p), ("out", ctypes.c_void_p),
                ("P", ctypes.c_int64), ("vec", ctypes.c_int32),
                ("pad", ctypes.c_int32)]


def fedagg_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel (the CPU path and the card-side
    reference of ``chip_smoke.py``)."""
    return (w[:, None] * x.float()).sum(0).to(x.dtype)


def fedagg_leaves_plain(xs: list[torch.Tensor],
                        w: torch.Tensor) -> list[torch.Tensor]:
    """Plain version of :func:`fedagg_leaves`: :func:`fedagg_plain` per
    leaf."""
    return [fedagg_plain(x, w) for x in xs]


def fedagg_cost(s: int, ps: list[int], dtype: torch.dtype
                ) -> tuple[int, int]:
    """(FLOP, bytes) of one fold of ``S`` rows over leaves of ``P_i``
    columns in ``dtype``: a multiply and an add per row and column, f32
    on the CUDA cores; each row read once, each output written once, the
    S f32 weights read once."""
    p = sum(ps)
    return 2 * s * p, (s + 1) * p * dtype.itemsize + 4 * s


def fedagg_leaves_meta(xs: list[torch.Tensor],
                       w: torch.Tensor) -> list[torch.Tensor]:
    """:func:`fedagg_leaves` on meta tensors: the same checks and the same
    outputs (views of one flat buffer at 16-byte aligned offsets), empty;
    reports :func:`fedagg_cost` to the installed meter."""
    if not xs:
        raise ValueError("fedagg_leaves: no leaves")
    for x in xs:
        check_inputs(x, w)
    dtype = xs[0].dtype
    ps = [x.shape[1] for x in xs]
    offsets, total = out_offsets(ps, xs[0].element_size())
    flat = torch.empty(total, dtype=dtype, device=w.device)
    meter.report_kernel("fedagg", *fedagg_cost(w.shape[0], ps, dtype),
                        tensor_cores=False)
    return [flat[o:o + p] for o, p in zip(offsets, ps)]


def out_offsets(ps: list[int], elem_size: int) -> tuple[list[int], int]:
    """Where each leaf's output starts in the flat output buffer (in
    elements), every offset a multiple of 16 bytes so that the vector path
    can store to it, and the buffer's length."""
    align = VEC_BYTES // elem_size
    offsets, total = [], 0
    for p in ps:
        offsets.append(total)
        total += -(-p // align) * align
    return offsets, total


def plan_launches(leaves: list[tuple[int, int, int]],
                  elem_size: int) -> list[list[dict]]:
    """The leaf tables of a fold: ``leaves`` is ``(x_ptr, out_ptr, P)``
    per leaf; returns one list of entries per launch, at most
    :data:`MAX_LEAVES` each, in leaf order. An entry holds the leaf's
    index, pointers, P and whether it folds 16 bytes per thread (P a
    multiple of 4 in f32 or 8 in bf16, x and out 16-byte aligned; the C
    launcher refuses a flag the leaf does not allow and lays out the
    blocks). Leaves with P = 0 have no entry; no leaves, no launch."""
    per = VEC_BYTES // elem_size
    entries = [dict(leaf=i, x=x_ptr, out=out_ptr, P=p,
                    vec=(p % per == 0 and x_ptr % VEC_BYTES == 0
                         and out_ptr % VEC_BYTES == 0))
               for i, (x_ptr, out_ptr, p) in enumerate(leaves) if p]
    return [entries[i:i + MAX_LEAVES]
            for i in range(0, len(entries), MAX_LEAVES)]


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built library with its C signatures declared (first call)."""
    lib = build.load("fedagg")
    for fn in (lib.fedagg_multi_f32, lib.fedagg_multi_bf16):
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def check_inputs(x: torch.Tensor, w: torch.Tensor) -> None:
    if x.dim() != 2 or w.dim() != 1:
        raise ValueError(f"fedagg wants x (S, P) and w (S,); got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if x.shape[0] != w.shape[0] or x.shape[0] < 1:
        raise ValueError(f"fedagg: S={x.shape[0]} rows but {w.shape[0]} "
                         f"weights (S must be >= 1 and equal)")
    if x.dtype not in _DTYPES:
        raise TypeError(f"fedagg: x dtype {x.dtype} not in {_DTYPES}")
    if w.dtype != torch.float32:
        raise TypeError(f"fedagg: weights must be float32, got {w.dtype}")
    if x.device != w.device:
        raise ValueError(f"fedagg: x on {x.device}, w on {w.device}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("fedagg: x and w must be contiguous")


def fedagg_leaves(xs: list[torch.Tensor],
                  w: torch.Tensor) -> list[torch.Tensor]:
    """The kernel on CUDA tensors: ``Σ_s w[s]·x[s]`` for every ``(S, P_i)``
    leaf of ``xs`` (one dtype), in one launch per :data:`MAX_LEAVES`
    leaves. Returns ``(P_i,)`` views of one flat output buffer, each leaf's
    at a 16-byte aligned offset. Raises on any other device."""
    autograd_guard("fedagg", *xs, w)
    if not xs:
        raise ValueError("fedagg_leaves: no leaves")
    for x in xs:
        check_inputs(x, w)
    if len({x.dtype for x in xs}) != 1:
        raise TypeError(f"fedagg_leaves: leaves of dtypes "
                        f"{sorted({str(x.dtype) for x in xs})}; want one")
    if w.device.type != "cuda":
        raise ValueError(f"fedagg: the kernel takes CUDA tensors, got "
                         f"{w.device} (ops.fedagg_op and ops.fedagg_tree "
                         f"run the plain version on the CPU)")
    dtype, elem = xs[0].dtype, xs[0].element_size()
    offsets, total = out_offsets([x.shape[1] for x in xs], elem)
    flat = torch.empty(total, dtype=dtype, device=w.device)
    outs = [flat[o:o + x.shape[1]] for o, x in zip(offsets, xs)]
    lib = _lib()
    fn = lib.fedagg_multi_f32 if dtype == torch.float32 else \
        lib.fedagg_multi_bf16
    tables = plan_launches([(x.data_ptr(), o.data_ptr(), x.shape[1])
                            for x, o in zip(xs, outs)], elem)
    with torch.cuda.device(w.device):
        stream = torch.cuda.current_stream().cuda_stream
        for table in tables:
            leaves = (_Leaf * len(table))(*(
                _Leaf(e["x"], e["out"], e["P"], int(e["vec"]), 0)
                for e in table))
            err = fn(leaves, len(table), w.data_ptr(), w.shape[0], stream)
            if err != 0:
                raise RuntimeError(f"fedagg kernel launch failed: cudaError "
                                   f"{err}")
            fedagg.launches += 1
    return outs


def fedagg(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Weighted sum over the replica axis of one ``(S, P)`` CUDA tensor ->
    ``(P,)`` in x.dtype: the one-leaf case of :func:`fedagg_leaves`.
    Raises on any other device."""
    return fedagg_leaves([x], w)[0]


fedagg.launches = 0
