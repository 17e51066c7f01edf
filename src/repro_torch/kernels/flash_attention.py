"""Causal / sliding-window GQA flash attention (forward) on Hopper.

``O = softmax(Q·Kᵀ/√D + mask)·V`` per (batch, query head), with q of
shape ``(B, H, Sq, D)``, k and v ``(B, Hkv, Sk, D)`` and the output
``(B, H, Sq, D)`` in q's dtype (f32 or bf16; scores, running max and
sums in f32). Query head ``h`` reads KV head ``h // (H/Hkv)``. Masks:
``k_pos < Sk``, causal ``q_pos >= k_pos``, optional window
``q_pos - k_pos < W``; masked scores are -1e30, as in the TPU kernel.

The kernels are in ``csrc/flash_attention.cu`` (CUDA C++ for sm_90a; its
header has the bound at the prefill shape and the designs); they replace
the Pallas TPU kernel ``flash_attention`` of
``repro/kernels/flash_attention.py:87``. It holds two hand-written
kernels, and the C launcher dispatches between them by dtype and D
(:func:`kernel_variant` is its Python mirror; the wrapper raises if the
two disagree):

- ``"tc"``, bf16 with D in {16, 32, 64, 128}: TMA loads and ``wgmma`` on
  the tensor cores, the serving path's kernel. Its one rounding beyond
  the plain version's is P in bf16 before P·V, made exact to ~2^-17 on
  the tiles that cross a mask edge (where a row may hold few keys).
- ``"simt"``, f32 (on the tensor cores it would be TF32) and D = 8
  (below wgmma's k16 depth): f32 FMAs on the CUDA cores.

This is a dispatch, not a fallback: a failed build or launch of either
raises. TMA addresses a tensor only from a 16-byte aligned base with
strides that are multiples of 16 bytes; for the tensor-core kernel the
wrapper copies a q, k or v view that misses that to a contiguous tensor
first, so such a call still runs on the tensor cores.

:func:`flash_attention` checks its inputs and launches the kernel; it
takes CUDA tensors only. The choice between kernel and plain version is
made in one place, :func:`repro_torch.kernels.ops.flash_attention_op`:
CPU tensors go to :func:`flash_attention_plain` — only because they lie
on the CPU — and a CUDA tensor never reaches the plain version. The
kernel has no backward yet: the wrapper raises when grad is enabled and
an input requires grad (``guard.autograd_guard``). Any
(b, h, s) strides are taken as long as D has unit stride, so the
model's ``(B, S, H, D)`` projections go in as transposed views; the
output is laid out like q. ``flash_attention.launches`` counts kernel
launches, ``flash_attention.launches_tc`` and ``.launches_simt`` those
of each variant.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.guard import autograd_guard

NEG_INF = -1e30
HEAD_DIMS = (8, 16, 32, 64, 128)
_DTYPES = (torch.float32, torch.bfloat16)
TMA_ALIGN = 16          # bytes: TMA's base and stride granule


def kernel_variant(dtype: torch.dtype, d: int) -> str:
    """Which kernel a CUDA call runs: ``"tc"`` (tensor cores) for bf16 at
    D >= 16, ``"simt"`` for f32 and D = 8. Mirrors ``variant_for`` in
    ``csrc/flash_attention.cu``, which makes the choice."""
    return "tc" if dtype == torch.bfloat16 and d >= 16 else "simt"


def tma_addressable(t: torch.Tensor) -> bool:
    """Whether TMA can address ``t``: a 16-byte aligned base, and every
    (b, h, s) stride of an axis longer than 1 a multiple of 16 bytes."""
    size = t.element_size()
    return t.data_ptr() % TMA_ALIGN == 0 and all(
        n == 1 or (st * size) % TMA_ALIGN == 0
        for n, st in zip(t.shape[:3], t.stride()[:3]))


def _mask(sq: int, sk: int, causal: bool, window: int | None,
          device: torch.device) -> torch.Tensor:
    qpos = torch.arange(sq, device=device)[:, None]
    kpos = torch.arange(sk, device=device)[None, :]
    ok = torch.ones(sq, sk, dtype=torch.bool, device=device)
    if causal:
        ok &= qpos >= kpos
    if window is not None:
        ok &= (qpos - kpos) < window
    return ok


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True,
                          window: int | None = None) -> torch.Tensor:
    """Plain PyTorch version of the kernel (the CPU path and the card-side
    reference of ``chip_smoke.py``): dense f32 scores, the -1e30 mask,
    softmax, ``P·V`` in f32, cast to q's dtype."""
    group = q.shape[1] // k.shape[1]
    kq = k.repeat_interleave(group, dim=1).float()
    vq = v.repeat_interleave(group, dim=1).float()
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kq) * (
        1.0 / math.sqrt(q.shape[-1]))
    ok = _mask(q.shape[2], k.shape[2], causal, window, q.device)
    s = torch.where(ok, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, vq).to(q.dtype)


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built library with its C signatures declared (first call)."""
    lib = build.load("flash_attention")
    for fn in (lib.flash_attention_f32, lib.flash_attention_bf16):
        fn.argtypes = ([ctypes.c_void_p] * 4
                       + [ctypes.POINTER(ctypes.c_int64)]
                       + [ctypes.c_int] * 8
                       + [ctypes.POINTER(ctypes.c_int), ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def check_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           window: int | None) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"flash_attention wants q (B,H,Sq,D), k/v "
                         f"(B,Hkv,Sk,D); got ranks {q.dim()}, {k.dim()}, "
                         f"{v.dim()}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: dtypes {q.dtype}, {k.dtype}, "
                        f"{v.dtype}; want one of {_DTYPES} for all three")
    if not (q.device == k.device == v.device):
        raise ValueError(f"flash_attention: q on {q.device}, k on "
                         f"{k.device}, v on {v.device}")
    b, h, sq, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} disagree")
    hkv, sk = k.shape[1], k.shape[2]
    if min(b, h, hkv, sq, sk) < 1 or h % hkv != 0:
        raise ValueError(f"flash_attention: H={h} must be a multiple of "
                         f"Hkv={hkv}, and no size may be 0")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {d} not in "
                         f"{HEAD_DIMS}")
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("flash_attention: the head dim of q, k and v "
                         "must have unit stride")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window must be >= 1, got "
                         f"{window}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True,
                    window: int | None = None) -> torch.Tensor:
    """The kernel on CUDA tensors -> ``(B, H, Sq, D)`` in q's dtype, laid
    out like q. Raises on any other device."""
    autograd_guard("flash_attention", q, k, v)
    check_inputs(q, k, v, window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: the kernel takes CUDA tensors, "
                         f"got {q.device} (ops.flash_attention_op runs "
                         f"the plain version on the CPU)")
    b, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    variant = kernel_variant(q.dtype, d)
    if variant == "tc":
        # A fresh allocation: .contiguous() would return a contiguous view
        # at a misaligned offset as it is.
        q, k, v = (t if tma_addressable(t)
                   else t.clone(memory_format=torch.contiguous_format)
                   for t in (q, k, v))
    strides = (ctypes.c_int64 * 12)(*(
        s for t in (q, k, v, out) for s in t.stride()[:3]))
    lib = _lib()
    bf16 = q.dtype == torch.bfloat16
    fn = lib.flash_attention_bf16 if bf16 else lib.flash_attention_f32
    launched = ctypes.c_int(-1)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 strides, b, h, hkv, sq, sk, d, int(causal),
                 0 if window is None else int(window),
                 ctypes.byref(launched), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel ({variant}) launch "
                           f"failed: cudaError {err}")
    if {1: "tc", 0: "simt"}.get(launched.value) != variant:
        raise RuntimeError(f"flash_attention: the launcher ran variant "
                           f"{launched.value}, kernel_variant says "
                           f"{variant!r}")
    flash_attention.launches += 1
    if variant == "tc":
        flash_attention.launches_tc += 1
    else:
        flash_attention.launches_simt += 1
    return out


flash_attention.launches = 0
flash_attention.launches_tc = 0
flash_attention.launches_simt = 0
