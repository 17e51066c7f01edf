"""Fused weighted multi-replica aggregation (the FedHAP fold) on Hopper.

``out[p] = Σ_s w[s]·x[s, p]`` over ``x`` of shape ``(S, P)`` (f32 or
bf16) and ``w`` of shape ``(S,)`` (f32), accumulated in f32, returned in
``x``'s dtype. The kernel is ``csrc/fedagg.cu`` (CUDA C++ for sm_90a;
its header has the bound and the design); it replaces the Pallas TPU
kernel ``fedagg`` of ``repro/kernels/fedagg.py:30``.

:func:`fedagg` checks its inputs, then launches the kernel for CUDA
tensors, or runs :func:`fedagg_plain` for CPU tensors — only because
they lie on the CPU. A CUDA tensor never reaches the plain version.
``fedagg.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

_DTYPES = (torch.float32, torch.bfloat16)


def fedagg_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel (the CPU path and the card-side
    reference of ``chip_smoke.py``)."""
    return (w[:, None] * x.float()).sum(0).to(x.dtype)


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built library with its C signatures declared (first call)."""
    lib = build.load("fedagg")
    for fn in (lib.fedagg_f32, lib.fedagg_bf16):
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int64, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _check(x: torch.Tensor, w: torch.Tensor) -> None:
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


def fedagg(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Weighted sum over the replica axis; returns ``(P,)`` in x.dtype."""
    _check(x, w)
    if x.device.type == "cpu":
        return fedagg_plain(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"fedagg: unsupported device {x.device}")
    s, p = x.shape
    out = torch.empty(p, dtype=x.dtype, device=x.device)
    if p == 0:
        return out
    lib = _lib()
    fn = lib.fedagg_f32 if x.dtype == torch.float32 else lib.fedagg_bf16
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), s, p, stream)
    if err != 0:
        raise RuntimeError(f"fedagg kernel launch failed: cudaError {err}")
    fedagg.launches += 1
    return out


fedagg.launches = 0
