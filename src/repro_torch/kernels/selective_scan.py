"""Mamba selective scan (prefill) on Hopper.

Per (batch, channel d), with an N-vector f32 state h that starts at
zero::

    h_t = abar_t ⊙ h_{t-1} + bx_t
    y_t = Σ_n h_t[n] · c_t[n]

abar and bx are ``(B, S, D, N)``, c is ``(B, S, N)``, and y comes back
``(B, S, D)`` in bx's dtype. Three dtype combinations: all f32, all bf16
(the JAX kernel sweep's bf16 case), and abar f32 with bx and c bf16 (the
model's path, see ``csrc/selective_scan.cu``). In every uniform case bx's
dtype is the Pallas kernel's ``abar.dtype``; in the mixed case it is the
JAX model scan's ``out_dtype`` (``repro/models/ssm.py:55``).

The kernel is ``csrc/selective_scan.cu`` (CUDA C++ for sm_90a; its header
has the bound at the jamba prefill shape and the design); it replaces the
Pallas TPU kernel ``selective_scan`` of
``repro/kernels/selective_scan.py:42``.

:func:`selective_scan` checks its inputs and launches the kernel; it
takes CUDA tensors only. The choice between kernel and plain version is
made in one place, :func:`repro_torch.kernels.ops.selective_scan_op`: CPU
tensors go to :func:`selective_scan_plain` — only because they lie on the
CPU — and a CUDA tensor never reaches the plain version. The kernel has
no backward yet: the wrapper raises when grad is enabled and an input
requires grad (``guard.autograd_guard``). abar and bx must
be contiguous; c may be a strided view (the model's split of ``x_proj``'s
output) as long as N has unit stride. ``selective_scan.launches`` counts
kernel launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.guard import autograd_guard

STATE_SIZES = (4, 8, 16)
# (abar dtype, bx dtype); c takes bx's dtype, and so does y.
DTYPE_CASES = ((torch.float32, torch.float32),
               (torch.bfloat16, torch.bfloat16),
               (torch.float32, torch.bfloat16))


def selective_scan_plain(abar: torch.Tensor, bx: torch.Tensor,
                         c: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel (the CPU path and the card-side
    reference of ``chip_smoke.py``), as ``ref.selective_scan_ref`` of the
    JAX package: a loop over the sequence, vectorised over (B, D, N), the
    state in f32 from zero, the output cast to bx's dtype. Each step's
    slices are cast to f32 as they are used, so no f32 copy of the whole
    input is made."""
    b, s, d, n = abar.shape
    h = torch.zeros(b, d, n, dtype=torch.float32, device=abar.device)
    y = torch.empty(b, s, d, dtype=bx.dtype, device=abar.device)
    for t in range(s):
        h = abar[:, t].float() * h + bx[:, t].float()
        y[:, t] = torch.einsum("bdn,bn->bd", h, c[:, t].float())
    return y


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built library with its C signatures declared (first call)."""
    lib = build.load("selective_scan")
    for fn in (lib.selective_scan_f32, lib.selective_scan_bf16,
               lib.selective_scan_mixed):
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int64] * 2
                       + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def check_inputs(abar: torch.Tensor, bx: torch.Tensor,
                 c: torch.Tensor) -> None:
    if abar.dim() != 4 or bx.dim() != 4 or c.dim() != 3:
        raise ValueError(f"selective_scan wants abar, bx (B,S,D,N) and c "
                         f"(B,S,N); got ranks {abar.dim()}, {bx.dim()}, "
                         f"{c.dim()}")
    if (abar.dtype, bx.dtype) not in DTYPE_CASES or c.dtype != bx.dtype:
        raise TypeError(f"selective_scan: dtypes abar {abar.dtype}, bx "
                        f"{bx.dtype}, c {c.dtype}; want (abar, bx) one of "
                        f"{DTYPE_CASES} and c of bx's dtype")
    if not (abar.device == bx.device == c.device):
        raise ValueError(f"selective_scan: abar, bx, c on {abar.device}, "
                         f"{bx.device}, {c.device}")
    b, s, d, n = abar.shape
    if tuple(bx.shape) != (b, s, d, n) or tuple(c.shape) != (b, s, n):
        raise ValueError(f"selective_scan: abar {tuple(abar.shape)}, bx "
                         f"{tuple(bx.shape)}, c {tuple(c.shape)} disagree")
    if min(b, s, d) < 1:
        raise ValueError(f"selective_scan: no size may be 0, got "
                         f"{tuple(abar.shape)}")
    if n not in STATE_SIZES:
        raise ValueError(f"selective_scan: state size {n} not in "
                         f"{STATE_SIZES}")
    if not (abar.is_contiguous() and bx.is_contiguous()):
        raise ValueError("selective_scan: abar and bx must be contiguous")
    if c.stride(2) != 1:
        raise ValueError("selective_scan: the state axis N of c must have "
                         "unit stride")


def selective_scan(abar: torch.Tensor, bx: torch.Tensor,
                   c: torch.Tensor) -> torch.Tensor:
    """The kernel on CUDA tensors -> y ``(B, S, D)`` in bx's dtype,
    contiguous. Raises on any other device."""
    autograd_guard("selective_scan", abar, bx, c)
    check_inputs(abar, bx, c)
    if abar.device.type != "cuda":
        raise ValueError(f"selective_scan: the kernel takes CUDA tensors, "
                         f"got {abar.device} (ops.selective_scan_op runs "
                         f"the plain version on the CPU)")
    if abar.data_ptr() % 16 or bx.data_ptr() % 16:
        raise ValueError("selective_scan: abar and bx must be 16-byte "
                         "aligned (the kernel loads 16 and 8 bytes at a "
                         "time)")
    b, s, d, n = abar.shape
    y = torch.empty((b, s, d), dtype=bx.dtype, device=abar.device)
    lib = _lib()
    if bx.dtype == torch.float32:
        fn = lib.selective_scan_f32
    elif abar.dtype == torch.bfloat16:
        fn = lib.selective_scan_bf16
    else:
        fn = lib.selective_scan_mixed
    stream = torch.cuda.current_stream(abar.device).cuda_stream
    with torch.cuda.device(abar.device):
        err = fn(abar.data_ptr(), bx.data_ptr(), c.data_ptr(), y.data_ptr(),
                 c.stride(0), c.stride(1), b, s, d, n, stream)
    if err != 0:
        raise RuntimeError(f"selective_scan kernel launch failed: "
                           f"cudaError {err}")
    selective_scan.launches += 1
    return y


selective_scan.launches = 0
