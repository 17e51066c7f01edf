"""Causal / sliding-window GQA flash attention on Hopper: the forward and
its backward.

``O = softmax(Q·Kᵀ/√D + mask)·V`` per (batch, query head), with q of
shape ``(B, H, Sq, D)``, k ``(B, Hkv, Sk, D)``, v ``(B, Hkv, Sk, Dv)``
and the output ``(B, H, Sq, Dv)`` in q's dtype (f32 or bf16; scores,
running max and sums in f32). Query head ``h`` reads KV head
``h // (H/Hkv)``. Masks: ``k_pos < Sk``, causal ``q_pos >= k_pos``,
optional window ``q_pos - k_pos < W``; masked scores are -1e30, as in
the TPU kernel. The kernels take the head-dim pairs ``(D, Dv)`` of
:data:`KERNEL_DIMS`: ``D == Dv`` in :data:`HEAD_DIMS`, (96, 64), MLA's
(minicpm3-4b), and (24, 16), the reduced MLA's, forward and backward
alike; the wrapper also counts their launches in
``flash_attention.launches_split`` and ``.launches_bwd_split``. The
plain version takes any pair.

The forward kernels are in ``csrc/flash_attention.cu`` (CUDA C++ for
sm_90a; its header has the bound at the prefill shape and the designs);
they replace the Pallas TPU kernel ``flash_attention`` of
``repro/kernels/flash_attention.py:87``. It holds two hand-written
kernels, both on the tensor cores, and the C launcher dispatches between
them by dtype and D (:func:`kernel_variant` is its Python mirror; the
wrapper raises if the two disagree):

- ``"tc"``, bf16 with D a multiple of wgmma's k16 depth (16, 32, 64,
  96, 128): TMA loads and ``wgmma``, the serving path's kernel. Its one
  rounding beyond the plain version's is P in bf16 before P·V, made exact
  to ~2^-17 on the tiles that cross a mask edge (where a row may hold few
  keys).
- ``"mma"``, f32 at every D and bf16 at D in {8, 24} (no multiple of
  k16): warp-level ``mma.sync`` with cp.async loads (``csrc/
  mma_common.cuh``). f32 runs as 3xTF32: each operand split into TF32
  parts hi + lo, three products (lo·hi + hi·lo + hi·hi) with f32 sums,
  the plain f32 version to ~2^-21 of each term. bf16 zero-pads D to 16 or
  32 columns and takes P as two bf16 parts, as ``"tc"`` does.

This is a dispatch, not a fallback: a failed build or launch of either
raises. TMA and cp.async read rows from a 16-byte aligned base with
strides that are multiples of 16 bytes; the wrapper copies a q, k or v
view that misses that to a contiguous tensor first, so such a call still
runs its kernel.

The backward is ``csrc/flash_attention_bwd.cu``
(:func:`flash_attention_bwd`, f32 and bf16, every pair of the forward):
from q, k, v, the output o, the forward's per-row log-sum-exp ``lse``
(``(B, H, Sq)`` f32, which the forward kernels store only when asked) and
the output's gradient dO it computes dQ, dK and dV, dK and dV summed over
the query heads of each KV head. Its C launcher chooses between two
variants by the forward's rule (:func:`kernel_variant` again):

- ``"tc"``, bf16 with D in {16, 32, 64, 96, 128}: TMA and ``wgmma``, a
  dK/dV kernel per key tile and a dQ kernel per query tile (the training
  path's; at (96, 64) q and k sit in shared memory as three 32-column
  chunks in the 64-byte swizzle, so dK and dQ are n96 products with no
  column of zeros, as the forward's Q·Kᵀ is, and the pair has a schedule
  of its own: 128-key dK/dV blocks, the blocks of one head launched side
  by side, the two consumer groups taking turns on the tensor cores).
  The products take P and dS
  as two bf16 parts each (hi and the remainder lo), so its only rounding
  beyond the plain version's is ~2^-17 of each term; the wrapper copies a
  q, k, v, o or dO view that TMA cannot address first, as the forward
  does.
- ``"mma"``, f32 and D in {8, 24}: ``mma.sync`` in the forward's
  arithmetic, two kernels: dQ, whose prologue writes Δ = rowsum(dO ⊙ O),
  then dK/dV; each splits its walk over keys or query rows four ways
  across the warps of a block where its blocks of 64 would not fill the
  SMs, and adds the warps' partial sums in a fixed order.

The backward's bound is operations: 6D + 4Dv FLOP per visible (q, k)
pair (the forward's is 2(D + Dv)), 0.0353 ms at MLA's training shape
(B=2, H=40, S=1024, (96, 64), causal) on the card's 989 TFLOP/s.

Both are deterministic: every gradient element has one writer, and sums
split across warps meet in a fixed order (no float atomics). The JAX
package has no backward kernel (it takes this gradient by autodiff of its
blockwise jnp analogue); the port's forward is a kernel, so its gradient
is one too. :class:`FlashAttentionFn` ties the two together for autograd.

:func:`flash_attention` checks its inputs and dispatches: with grad
enabled and an input that requires grad it applies
:class:`FlashAttentionFn` (the forward kernel with ``lse``, then
``flash_attention_bwd``); otherwise it launches the forward with no
``lse``, as the serving path always does. The launchers take CUDA
tensors only. The choice between kernel and plain version is made in
one place, :func:`repro_torch.kernels.ops.flash_attention_op`: CPU
tensors go to :func:`flash_attention_plain` — only because they lie on
the CPU — and a CUDA tensor never reaches the plain version. Any
(b, h, s) strides are taken as long as D has unit stride, so the
model's ``(B, S, H, D)`` projections go in as transposed views; the
output and the gradients are laid out like their inputs.
``flash_attention.launches`` counts forward launches,
``flash_attention.launches_tc`` and ``.launches_mma`` those of each
variant, ``.launches_split`` those with ``D != Dv`` (also counted in
their kernel's), ``flash_attention.launches_bwd`` backward calls (each
enqueues the backward's kernels: tc a pre-pass for Δ, dK/dV, dQ; mma dQ
with Δ, then dK/dV), ``.launches_bwd_tc`` / ``.launches_bwd_mma`` those
of each variant and ``.launches_bwd_split`` those with ``D != Dv``.

:func:`flash_attention_cost` and :func:`flash_attention_bwd_cost` are a
call's FLOP and bytes, the bounds' numerators, from its visible (q, k)
pairs (:func:`visible_pairs`). On meta tensors
(:func:`flash_attention_meta`, which ``ops.flash_attention_op`` calls
for them) nothing launches: the output comes back empty, and the call
reports its cost to the dry run's meter (``kernels/meter.py``), under
grad through :class:`FlashAttentionMetaFn`, whose backward reports the
backward kernels' cost.
"""
from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from repro_torch.kernels import build, meter

NEG_INF = -1e30
HEAD_DIMS = (8, 16, 32, 64, 128)
# (D of q and k, Dv of v) pairs the kernels are built for: MLA's
# (minicpm3-4b) and the reduced MLA's beside D == Dv.
KERNEL_DIMS = tuple((d, d) for d in HEAD_DIMS) + ((96, 64), (24, 16))
_DTYPES = (torch.float32, torch.bfloat16)
TMA_ALIGN = 16          # bytes: TMA's base and stride granule
BWD_ROW_PAD = 128       # the tc backward's scratch rows: Sq rounded up


def kernel_variant(dtype: torch.dtype, d: int) -> str:
    """Which kernels a CUDA call runs, forward and backward alike: ``"tc"``
    (``wgmma``) for bf16 with D a multiple of wgmma's k16 depth, ``"mma"``
    (``mma.sync``) for f32 and D in {8, 24} (D of q and k). Mirrors
    ``variant_for`` in ``csrc/flash_attention.cu`` and
    ``csrc/flash_attention_bwd.cu``, which make the choice."""
    return "tc" if dtype == torch.bfloat16 and d % 16 == 0 else "mma"


def bwd_scratch_floats(b: int, h: int, sq: int) -> int:
    """Floats of f32 scratch a backward call takes: lse·log2(e) and Δ of
    every (b, h) row, rows padded to ``BWD_ROW_PAD`` (the tc variant's
    need, which covers the mma one's Δ). Mirrors ``tc::scratch_floats``
    in ``csrc/flash_attention_bwd.cu``, whose launcher refuses less."""
    return 2 * b * h * (-(-sq // BWD_ROW_PAD) * BWD_ROW_PAD)


def _check_variant(name: str, launched: int, variant: str) -> None:
    """Raise unless the C launcher ran the variant kernel_variant names
    (it reports 1 for tc, 0 for mma)."""
    if {1: "tc", 0: "mma"}.get(launched) != variant:
        raise RuntimeError(f"{name}: the launcher ran variant {launched}, "
                           f"kernel_variant says {variant!r}")


def tma_addressable(t: torch.Tensor) -> bool:
    """Whether TMA (and cp.async's 16-byte copies) can address ``t``: a
    16-byte aligned base, and every (b, h, s) stride of an axis longer
    than 1 a multiple of 16 bytes."""
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


def _scores(q: torch.Tensor, k: torch.Tensor, causal: bool,
            window: int | None) -> tuple[torch.Tensor, torch.Tensor]:
    """The f32 scaled scores ``(B, H, Sq, Sk)`` with masked entries at
    -1e30, and the boolean ``(Sq, Sk)`` mask."""
    group = q.shape[1] // k.shape[1]
    kq = k.repeat_interleave(group, dim=1).float()
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kq) * (
        1.0 / math.sqrt(q.shape[-1]))
    ok = _mask(q.shape[2], k.shape[2], causal, window, q.device)
    return torch.where(ok, s, torch.full_like(s, NEG_INF)), ok


@functools.lru_cache(maxsize=256)
def visible_pairs(sq: int, sk: int, causal: bool = True,
                  window: int | None = None) -> int:
    """The (q, k) pairs a query head attends to under the kernels' masks:
    ``k_pos < Sk``, causal ``k_pos <= q_pos``, window ``q_pos - k_pos <
    W``, positions counted from 0 in q and in k. Causal at Sq = Sk it is
    S(S+1)/2."""
    q = np.arange(sq, dtype=np.int64)
    hi = np.minimum(q, sk - 1) if causal else np.full_like(q, sk - 1)
    lo = np.maximum(q - window + 1, 0) if window else np.zeros_like(q)
    return int(np.maximum(hi - lo + 1, 0).sum())


def flash_attention_cost(q_shape: tuple, k_shape: tuple, v_shape: tuple,
                         dtype: torch.dtype, causal: bool = True,
                         window: int | None = None,
                         with_lse: bool = False) -> tuple[int, int]:
    """(FLOP, bytes) of one forward call: 2D + 2Dv FLOP a visible pair
    (Q·Kᵀ and P·V, a multiply and an add each); q, k and v read once, the
    output written once, and with ``with_lse`` the f32 log-sum-exp."""
    b, h, sq, d = q_shape
    sk, dv = k_shape[2], v_shape[3]
    flops = b * h * visible_pairs(sq, sk, causal, window) * 2 * (d + dv)
    nbytes = dtype.itemsize * (math.prod(q_shape) + math.prod(k_shape)
                               + math.prod(v_shape) + b * h * sq * dv)
    return flops, nbytes + (4 * b * h * sq if with_lse else 0)


def flash_attention_bwd_cost(q_shape: tuple, k_shape: tuple, v_shape: tuple,
                             dtype: torch.dtype, causal: bool = True,
                             window: int | None = None) -> tuple[int, int]:
    """(FLOP, bytes) of one backward call: 6D + 4Dv FLOP a visible pair
    (Q·Kᵀ again, dP = dO·Vᵀ, dV = Pᵀ·dO, dQ = dS·K, dK = dSᵀ·Q); q, k, v,
    o, dO and the f32 lse read once, dq, dk and dv written once."""
    b, h, sq, d = q_shape
    sk, dv = k_shape[2], v_shape[3]
    flops = b * h * visible_pairs(sq, sk, causal, window) * (6 * d + 4 * dv)
    nbytes = dtype.itemsize * 2 * (math.prod(q_shape) + math.prod(k_shape)
                                   + math.prod(v_shape) + b * h * sq * dv)
    return flops, nbytes + 4 * b * h * sq


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True,
                          window: int | None = None) -> torch.Tensor:
    """Plain PyTorch version of the kernel (the CPU path and the card-side
    reference of ``chip_smoke.py``): dense f32 scores, the -1e30 mask,
    softmax, ``P·V`` in f32, cast to q's dtype. Differentiable: its
    autograd is the CPU path's gradient."""
    group = q.shape[1] // k.shape[1]
    vq = v.repeat_interleave(group, dim=1).float()
    s, _ = _scores(q, k, causal, window)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, vq).to(q.dtype)


def flash_attention_lse_plain(q: torch.Tensor, k: torch.Tensor,
                              causal: bool = True,
                              window: int | None = None) -> torch.Tensor:
    """Plain version of the ``lse`` the forward kernels store: each row's
    log-sum-exp of its scaled scores under the -1e30 mask, ``(B, H, Sq)``
    f32."""
    s, _ = _scores(q, k, causal, window)
    return torch.logsumexp(s, dim=-1)


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, o: torch.Tensor,
                              lse: torch.Tensor, do: torch.Tensor,
                              causal: bool = True, window: int | None = None
                              ) -> tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """Plain version of :func:`flash_attention_bwd` (the tests' and
    ``chip_smoke.py``'s reference), the kernel's formulas in f32:
    ``P = exp(S·scale − lse)`` (0 where masked), ``dV = Pᵀ·dO``,
    ``dP = dO·Vᵀ``, ``Δ = rowsum(dO ⊙ O)``, ``dS = P ⊙ (dP − Δ)``,
    ``dQ = scale·dS·K``, ``dK = scale·dSᵀ·Q``; dK and dV summed over each
    KV head's query heads. Returns (dq, dk, dv) in the inputs' dtype."""
    b, h, sq, d = q.shape
    hkv, sk, d_v = k.shape[1], k.shape[2], v.shape[3]
    group = h // hkv
    scale = 1.0 / math.sqrt(d)
    kq = k.repeat_interleave(group, dim=1).float()
    vq = v.repeat_interleave(group, dim=1).float()
    s, ok = _scores(q, k, causal, window)
    p = torch.where(ok, torch.exp(s - lse.float()[..., None]),
                    torch.zeros_like(s))
    del s
    dof = do.float()
    dv = torch.einsum("bhqk,bhqd->bhkd", p, dof)
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, vq)
    delta = (dof * o.float()).sum(-1, keepdim=True)
    ds = p * (dp - delta)
    del p, dp
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kq) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float()) * scale
    dk = dk.view(b, hkv, group, sk, d).sum(2)
    dv = dv.view(b, hkv, group, sk, d_v).sum(2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built library with its C signatures declared (first call)."""
    lib = build.load("flash_attention")
    for fn in (lib.flash_attention_f32, lib.flash_attention_bf16):
        fn.argtypes = ([ctypes.c_void_p] * 5
                       + [ctypes.POINTER(ctypes.c_int64)]
                       + [ctypes.c_int] * 9
                       + [ctypes.POINTER(ctypes.c_int), ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


@functools.cache
def _lib_bwd() -> ctypes.CDLL:
    """The backward's library with its C signatures declared."""
    lib = build.load("flash_attention_bwd")
    for fn in (lib.flash_attention_bwd_f32, lib.flash_attention_bwd_bf16):
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int64]
                       + [ctypes.c_void_p] * 3
                       + [ctypes.POINTER(ctypes.c_int64)]
                       + [ctypes.c_int] * 9
                       + [ctypes.POINTER(ctypes.c_int), ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def tc_smem_bytes(d: int, dv: int) -> dict:
    """Dynamic shared memory a block of each tensor-core kernel takes at
    the pair ``(d, dv)``, as its launcher requests it (the libraries'
    layouts; builds them, launches nothing): ``{"flash_fwd_tc": bytes,
    "flash_bwd_dkdv_tc": bytes, "flash_bwd_dq_tc": bytes}``."""
    out = {"flash_fwd_tc": _lib().flash_attention_tc_smem(d, dv)}
    for kernel, name in enumerate(("flash_bwd_dkdv_tc", "flash_bwd_dq_tc")):
        out[name] = _lib_bwd().flash_attention_bwd_tc_smem(d, dv, kernel)
    if min(out.values()) < 0:
        raise ValueError(f"({d}, {dv}) is not a pair of the tc kernels")
    return out


def check_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           window: int | None) -> None:
    """q (B,H,Sq,D), k (B,Hkv,Sk,D) and v (B,Hkv,Sk,Dv), one dtype and
    device, unit stride on the head dims; on a CUDA device ``(D, Dv)``
    must be a pair of :data:`KERNEL_DIMS` (the plain version takes any)."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"flash_attention wants q (B,H,Sq,D), k "
                         f"(B,Hkv,Sk,D), v (B,Hkv,Sk,Dv); got ranks "
                         f"{q.dim()}, {k.dim()}, {v.dim()}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: dtypes {q.dtype}, {k.dtype}, "
                        f"{v.dtype}; want one of {_DTYPES} for all three")
    if not (q.device == k.device == v.device):
        raise ValueError(f"flash_attention: q on {q.device}, k on "
                         f"{k.device}, v on {v.device}")
    b, h, sq, d = q.shape
    if (k.shape[:3] != v.shape[:3] or k.shape[0] != b
            or k.shape[3] != d):
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} disagree")
    hkv, sk, dv = k.shape[1], k.shape[2], v.shape[3]
    if min(b, h, hkv, sq, sk, d, dv) < 1 or h % hkv != 0:
        raise ValueError(f"flash_attention: H={h} must be a multiple of "
                         f"Hkv={hkv}, and no size may be 0")
    if q.device.type == "cuda" and (d, dv) not in KERNEL_DIMS:
        raise ValueError(f"flash_attention: head dims (D, Dv) = "
                         f"{(d, dv)} not in the kernels' {KERNEL_DIMS}")
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("flash_attention: the head dim of q, k and v "
                         "must have unit stride")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window must be >= 1, got "
                         f"{window}")


def _require_cuda(name: str, t: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name}: the kernel takes CUDA tensors, got "
                         f"{t.device} (ops.flash_attention_op runs the "
                         f"plain version on the CPU)")


def _out_like(q: torch.Tensor, dv: int) -> torch.Tensor:
    """An empty ``(B, H, Sq, Dv)`` tensor in q's dtype whose (b, h, s)
    axes are laid out in q's stride order, D innermost: for the model's
    transposed ``(B, S, H, D)`` views, a ``(B, S, H, Dv)`` storage."""
    if dv == q.shape[3]:
        return torch.empty_like(q)
    order = sorted(range(3), key=lambda i: -q.stride(i)) + [3]
    shape = (*q.shape[:3], dv)
    buf = q.new_empty([shape[i] for i in order])
    return buf.permute([order.index(i) for i in range(4)])


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, window: int | None = None,
                        with_lse: bool = False
                        ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """One launch of the forward kernel on CUDA tensors -> ``(out,
    lse)``: out ``(B, H, Sq, Dv)`` in q's dtype, laid out like q; ``lse``
    the ``(B, H, Sq)`` f32 log-sum-exp of each row when ``with_lse``,
    else None (the kernel is passed null). Raises on any other device.
    Counts the launch."""
    check_inputs(q, k, v, window)
    _require_cuda("flash_attention", q)
    b, h, sq, d = q.shape
    hkv, sk, dv = k.shape[1], k.shape[2], v.shape[3]
    out = _out_like(q, dv)
    lse = (torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    variant = kernel_variant(q.dtype, d)
    # A fresh allocation: .contiguous() would return a contiguous view at a
    # misaligned offset as it is.
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
                 None if lse is None else lse.data_ptr(),
                 strides, b, h, hkv, sq, sk, d, dv, int(causal),
                 0 if window is None else int(window),
                 ctypes.byref(launched), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel ({variant}) launch "
                           f"failed: cudaError {err}")
    _check_variant("flash_attention", launched.value, variant)
    flash_attention.launches += 1
    flash_attention.launches_split += d != dv
    if variant == "tc":
        flash_attention.launches_tc += 1
    else:
        flash_attention.launches_mma += 1
    return out, lse


def check_bwd_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                     window: int | None) -> None:
    """The backward's inputs: q, k, v as the forward takes them; o and do
    the output's ``(B, H, Sq, Dv)`` in q's dtype on q's device, with unit
    stride on Dv; lse a contiguous f32 ``(B, H, Sq)`` on q's device."""
    check_inputs(q, k, v, window)
    want = (*q.shape[:3], v.shape[3])
    for name, t in (("o", o), ("do", do)):
        if (tuple(t.shape) != want or t.dtype != q.dtype
                or t.device != q.device):
            raise ValueError(f"flash_attention_bwd: {name} is "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}; "
                             f"want {want} {q.dtype} on {q.device}")
        if t.stride(3) != 1:
            raise ValueError(f"flash_attention_bwd: the head dim of {name} "
                             f"must have unit stride")
    if (lse.shape != q.shape[:3] or lse.dtype != torch.float32
            or lse.device != q.device or not lse.is_contiguous()):
        raise ValueError(f"flash_attention_bwd: lse is {tuple(lse.shape)} "
                         f"{lse.dtype}; want a contiguous float32 "
                         f"{tuple(q.shape[:3])} on {q.device}")


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                        causal: bool = True, window: int | None = None
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernels on CUDA tensors -> (dq, dk, dv) in the inputs'
    dtype, each laid out like its input. ``o`` and ``lse`` are the
    forward's output and log-sum-exp, ``do`` the output's gradient.
    Raises on any other device. Counts the call and its variant."""
    check_bwd_inputs(q, k, v, o, lse, do, window)
    _require_cuda("flash_attention_bwd", q)
    b, h, sq, d = q.shape
    hkv, sk, d_v = k.shape[1], k.shape[2], v.shape[3]
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    variant = kernel_variant(q.dtype, d)
    # TMA or cp.async reads q, k, v and dO (autograd's dO is often a view
    # it cannot address); the tc pre-pass reads rows of o and dO 8 bytes at
    # a time, so o must be as aligned.
    q, k, v, o, do = (t if tma_addressable(t)
                      else t.clone(memory_format=torch.contiguous_format)
                      for t in (q, k, v, o, do))
    n_scratch = bwd_scratch_floats(b, h, sq)
    scratch = torch.empty(n_scratch, dtype=torch.float32, device=q.device)
    strides = (ctypes.c_int64 * 24)(*(
        s for t in (q, k, v, o, do, dq, dk, dv) for s in t.stride()[:3]))
    lib = _lib_bwd()
    fn = (lib.flash_attention_bwd_bf16 if q.dtype == torch.bfloat16
          else lib.flash_attention_bwd_f32)
    launched = ctypes.c_int(-1)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 do.data_ptr(), lse.data_ptr(), scratch.data_ptr(),
                 n_scratch, dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                 strides, b, h, hkv, sq, sk, d, d_v, int(causal),
                 0 if window is None else int(window),
                 ctypes.byref(launched), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd kernels ({variant}) "
                           f"launch failed: cudaError {err}")
    _check_variant("flash_attention_bwd", launched.value, variant)
    flash_attention.launches_bwd += 1
    flash_attention.launches_bwd_split += d != d_v
    if variant == "tc":
        flash_attention.launches_bwd_tc += 1
    else:
        flash_attention.launches_bwd_mma += 1
    return dq, dk, dv


class FlashAttentionFn(torch.autograd.Function):
    """Attention with a kernel on both sides: the forward kernel with
    ``lse`` (saving q, k, v, o and lse), the backward kernel for dq, dk
    and dv, at every pair of :data:`KERNEL_DIMS`. CUDA tensors only (the
    launchers raise otherwise)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        out, lse = flash_attention_fwd(q, k, v, causal, window,
                                       with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        if do.stride(3) != 1:
            do = do.contiguous()
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, do, ctx.causal,
                                         ctx.window)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True,
                    window: int | None = None) -> torch.Tensor:
    """The kernel on CUDA tensors -> ``(B, H, Sq, Dv)`` in q's dtype, laid
    out like q. With grad enabled and an input that requires grad, through
    :class:`FlashAttentionFn` (the output carries the kernel backward's
    autograd node); otherwise one forward launch with no ``lse``. Raises
    on any other device (the launchers check the inputs)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttentionFn.apply(q, k, v, causal, window)
    return flash_attention_fwd(q, k, v, causal, window)[0]


class FlashAttentionMetaFn(torch.autograd.Function):
    """:class:`FlashAttentionFn` on meta tensors: the forward reports the
    forward kernel's cost (with lse) and saves what the kernel's Function
    saves, the backward reports the backward kernels' cost and returns
    empty gradients (with the backward's f32 scratch allocated, as the
    launcher does)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        out = _meta_forward(q, k, v, causal, window, with_lse=True)
        lse = q.new_empty(q.shape[:3], dtype=torch.float32)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        b, h, sq, d = q.shape
        q.new_empty(bwd_scratch_floats(b, h, sq), dtype=torch.float32)
        meter.report_kernel(
            "flash_attention_bwd",
            *flash_attention_bwd_cost(tuple(q.shape), tuple(k.shape),
                                      tuple(v.shape), q.dtype, ctx.causal,
                                      ctx.window),
            tensor_cores=True, f32=q.dtype == torch.float32)
        return (torch.empty_like(q), torch.empty_like(k),
                torch.empty_like(v), None, None)


def _meta_forward(q, k, v, causal, window, with_lse: bool) -> torch.Tensor:
    meter.report_kernel(
        "flash_attention",
        *flash_attention_cost(tuple(q.shape), tuple(k.shape), tuple(v.shape),
                              q.dtype, causal, window, with_lse),
        tensor_cores=True, f32=q.dtype == torch.float32)
    return _out_like(q, v.shape[3])


def flash_attention_meta(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True,
                         window: int | None = None) -> torch.Tensor:
    """The kernels on meta tensors, launching nothing: the empty output
    laid out as :func:`flash_attention` lays it out, the call's cost
    reported to the installed meter; under grad through
    :class:`FlashAttentionMetaFn`, as :func:`flash_attention` goes
    through :class:`FlashAttentionFn`. The kernels' table of ``(D,
    Dv)`` pairs binds as on CUDA tensors."""
    check_inputs(q, k, v, window)
    if (q.shape[3], v.shape[3]) not in KERNEL_DIMS:
        raise ValueError(f"flash_attention: head dims (D, Dv) = "
                         f"{(q.shape[3], v.shape[3])} not in the kernels' "
                         f"{KERNEL_DIMS}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttentionMetaFn.apply(q, k, v, causal, window)
    return _meta_forward(q, k, v, causal, window, with_lse=False)


flash_attention.launches = 0
flash_attention.launches_tc = 0
flash_attention.launches_mma = 0
flash_attention.launches_split = 0
flash_attention.launches_bwd = 0
flash_attention.launches_bwd_tc = 0
flash_attention.launches_bwd_mma = 0
flash_attention.launches_bwd_split = 0
