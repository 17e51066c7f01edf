"""RWKV-6 WKV recurrence (prefill) on Hopper.

Per (batch, head), with an N x N f32 state S that starts at zero::

    y_t = r_tᵀ (S + diag(u) k_t v_tᵀ)
    S  ← diag(w_t) S + k_t v_tᵀ

r, k, v and w are ``(B, H, S, N)``, u is ``(H, N)`` f32, and y comes
back ``(B, H, S, N)`` in r's dtype. r, k and v share one dtype, f32 or
bf16; w is f32 or r's dtype (the model passes its decay in f32, see
``csrc/rwkv6_wkv.cu``).

The kernel is ``csrc/rwkv6_wkv.cu`` (CUDA C++ for sm_90a; its header has
the bound at the prefill shape and the design); it replaces the Pallas
TPU kernel ``rwkv6_wkv`` of ``repro/kernels/rwkv6_wkv.py:47``.

:func:`rwkv6_wkv` checks its inputs and launches the kernel; it takes
CUDA tensors only. The choice between kernel and plain version is made
in one place, :func:`repro_torch.kernels.ops.rwkv6_wkv_op`: CPU tensors
go to :func:`rwkv6_wkv_plain` — only because they lie on the CPU — and a
CUDA tensor never reaches the plain version. The kernel has no backward
yet: the wrapper raises when grad is enabled and an input requires grad
(``guard.autograd_guard``). Any (b, h, s) strides are
taken as long as N has unit stride, so the model's ``(B, S, H, N)``
projections go in as transposed views; the output is laid out like r.
The kernel stages its tiles by TMA, whose boxes need a base and strides
in multiples of 16 bytes (8 bytes for N = 4 in bf16, which copies by
cp.async): the wrapper copies any other view into a dense tensor first.
``rwkv6_wkv.launches`` counts kernel launches, ``rwkv6_wkv.copies`` the
inputs copied so.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.guard import autograd_guard

HEAD_SIZES = (4, 8, 16, 32, 64)
_DTYPES = (torch.float32, torch.bfloat16)


def rwkv6_wkv_plain(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    w: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel (the CPU path and the card-side
    reference of ``chip_smoke.py``), as ``ref.rwkv6_wkv_ref`` of the JAX
    package: a loop over the sequence, vectorised over (B, H, N, N), the
    state in f32 from zero, the output cast to r's dtype."""
    b, h, s, n = r.shape
    rf, kf, vf, wf = (a.float() for a in (r, k, v, w))
    uu = u.float()[None, :, :, None]
    state = torch.zeros(b, h, n, n, dtype=torch.float32, device=r.device)
    ys = []
    for t in range(s):
        kv = kf[:, :, t, :, None] * vf[:, :, t, None, :]
        ys.append(torch.einsum("bhn,bhnm->bhm", rf[:, :, t],
                               state + uu * kv))
        state = wf[:, :, t, :, None] * state + kv
    return torch.stack(ys, dim=2).to(r.dtype)


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built library with its C signatures declared (first call)."""
    lib = build.load("rwkv6_wkv")
    for fn in (lib.rwkv6_wkv_f32, lib.rwkv6_wkv_bf16,
               lib.rwkv6_wkv_bf16_wbf16):
        fn.argtypes = ([ctypes.c_void_p] * 6
                       + [ctypes.POINTER(ctypes.c_int64)]
                       + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def check_inputs(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 w: torch.Tensor, u: torch.Tensor) -> None:
    if any(t.dim() != 4 for t in (r, k, v, w)) or u.dim() != 2:
        raise ValueError(f"rwkv6_wkv wants r, k, v, w (B,H,S,N) and u "
                         f"(H,N); got ranks {r.dim()}, {k.dim()}, {v.dim()}, "
                         f"{w.dim()}, {u.dim()}")
    if r.dtype not in _DTYPES or k.dtype != r.dtype or v.dtype != r.dtype \
            or w.dtype not in (torch.float32, r.dtype) \
            or u.dtype != torch.float32:
        raise TypeError(f"rwkv6_wkv: dtypes r {r.dtype}, k {k.dtype}, v "
                        f"{v.dtype}, w {w.dtype}, u {u.dtype}; want r, k, v "
                        f"of one of {_DTYPES}, w f32 or r's dtype, u f32")
    if not (r.device == k.device == v.device == w.device == u.device):
        raise ValueError(f"rwkv6_wkv: r, k, v, w, u on {r.device}, "
                         f"{k.device}, {v.device}, {w.device}, {u.device}")
    b, h, s, n = r.shape
    if not (k.shape == v.shape == w.shape == r.shape) \
            or tuple(u.shape) != (h, n):
        raise ValueError(f"rwkv6_wkv: r {tuple(r.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, w "
                         f"{tuple(w.shape)}, u {tuple(u.shape)} disagree")
    if min(b, h, s) < 1:
        raise ValueError(f"rwkv6_wkv: no size may be 0, got "
                         f"{tuple(r.shape)}")
    if n not in HEAD_SIZES:
        raise ValueError(f"rwkv6_wkv: head size {n} not in {HEAD_SIZES}")
    if any(t.stride(3) != 1 for t in (r, k, v, w)):
        raise ValueError("rwkv6_wkv: the head axis N of r, k, v and w must "
                         "have unit stride")


def addressable(t: torch.Tensor, n: int) -> bool:
    """Whether the kernel's tile copies can address view ``t`` as it
    is: its base, and the (b, h, s) stride of every axis longer than 1,
    positive multiples of ``min(16, n * element size)`` bytes (16 for a
    TMA box; 8 for N = 4 in bf16)."""
    e = t.element_size()
    g = min(16, n * e)
    return t.data_ptr() % g == 0 and all(
        size == 1 or (st > 0 and st * e % g == 0)
        for size, st in zip(t.shape[:3], t.stride()[:3]))


def rwkv6_wkv(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              w: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """The kernel on CUDA tensors -> ``(B, H, S, N)`` in r's dtype, laid out
    like r. Raises on any other device."""
    autograd_guard("rwkv6_wkv", r, k, v, w, u)
    check_inputs(r, k, v, w, u)
    if r.device.type != "cuda":
        raise ValueError(f"rwkv6_wkv: the kernel takes CUDA tensors, got "
                         f"{r.device} (ops.rwkv6_wkv_op runs the plain "
                         f"version on the CPU)")
    b, h, s, n = r.shape
    u = u.contiguous()
    y = torch.empty_like(r)
    ins = []
    for t in (r, k, v, w):
        if not addressable(t, n):
            t = t.clone(memory_format=torch.contiguous_format)
            rwkv6_wkv.copies += 1
        ins.append(t)
    r, k, v, w = ins
    strides = (ctypes.c_int64 * 15)(*(
        st for t in (r, k, v, w, y) for st in t.stride()[:3]))
    lib = _lib()
    if r.dtype == torch.float32:
        fn = lib.rwkv6_wkv_f32
    elif w.dtype == torch.float32:
        fn = lib.rwkv6_wkv_bf16
    else:
        fn = lib.rwkv6_wkv_bf16_wbf16
    stream = torch.cuda.current_stream(r.device).cuda_stream
    with torch.cuda.device(r.device):
        err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                 u.data_ptr(), y.data_ptr(), strides, b, h, s, n, stream)
    if err != 0:
        raise RuntimeError(f"rwkv6_wkv kernel launch failed: cudaError {err}")
    rwkv6_wkv.launches += 1
    return y


rwkv6_wkv.launches = 0
rwkv6_wkv.copies = 0
