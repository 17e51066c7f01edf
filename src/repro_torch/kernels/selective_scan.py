"""Mamba selective scan (prefill and training) on Hopper.

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

The forward kernel is ``csrc/selective_scan.cu`` (CUDA C++ for sm_90a;
its header has the bound at the jamba prefill shape and the design); it
replaces the Pallas TPU kernel ``selective_scan`` of
``repro/kernels/selective_scan.py:42``. Under grad the same kernel also
stores the state before every 8 steps (:func:`selective_scan_fwd_ckpt`),
and the backward kernel ``csrc/selective_scan_bwd.cu`` reads them: one
reverse sweep of the state's adjoint, the states rebuilt from the
checkpoints (its header has the bound at jamba's training shape and the
scratch it needs). The JAX package has no backward kernel, it
differentiates jnp.

:func:`selective_scan` checks its inputs and launches the kernels; it
takes CUDA tensors only. The choice between kernel and plain version is
made in one place, :func:`repro_torch.kernels.ops.selective_scan_op`: CPU
tensors go to :func:`selective_scan_plain` — only because they lie on the
CPU — and a CUDA tensor never reaches the plain version. With grad
enabled and an input that requires grad, the wrapper applies
:class:`SelectiveScanFn` (the checkpointing forward kernel, then
:func:`selective_scan_bwd` on its checkpoints in the backward);
otherwise it launches the forward alone, without the checkpoints, as
serving does. abar and bx must be contiguous; c may be a strided view
(the model's split of ``x_proj``'s output) as long as N has unit stride,
and its gradient comes back ``(B, S, N)`` contiguous.
``selective_scan.launches`` counts forward launches,
``selective_scan.launches_ckpt`` those of them that stored checkpoints,
``selective_scan.launches_bwd`` backward launches (one call, two
kernels). :func:`selective_scan_cost` and :func:`selective_scan_bwd_cost`
are a call's FLOP and bytes, the bounds' numerators; on meta tensors
(:func:`selective_scan_meta`, which ``ops.selective_scan_op`` calls for
them) nothing launches, and the call reports that cost to the dry run's
meter (``kernels/meter.py``), under grad through
:class:`SelectiveScanMetaFn`.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import build, meter

STATE_SIZES = (4, 8, 16)
# (abar dtype, bx dtype); c takes bx's dtype, and so does y.
DTYPE_CASES = ((torch.float32, torch.float32),
               (torch.bfloat16, torch.bfloat16),
               (torch.float32, torch.bfloat16))
# Steps between the backward's checkpoints (the kernels' kChunk).
CKPT_STEPS = 8


def ckpt_shape(b: int, s: int, d: int, n: int) -> tuple:
    """Shape of the checkpoints the forward stores under grad (f32): the
    state before every CKPT_STEPS steps, ``(B, ceil(S/8), D, N)``."""
    return (b, -(-s // CKPT_STEPS), d, n)


def selective_scan_cost(abar_shape: tuple, abar_dtype: torch.dtype,
                        bx_dtype: torch.dtype, ckpt: bool = False
                        ) -> tuple[int, int]:
    """(FLOP, bytes) of one forward call over abar ``(B, S, D, N)``: an
    FMA of the update and one of y a state element a step, 4BSDN; abar,
    bx and c read once, y written once (c and y in bx's dtype), and with
    ``ckpt`` the f32 checkpoints stored."""
    b, s, d, n = abar_shape
    e = bx_dtype.itemsize
    nbytes = (b * s * d * n * (abar_dtype.itemsize + e) + b * s * n * e
              + b * s * d * e)
    if ckpt:
        nbytes += 4 * math.prod(ckpt_shape(b, s, d, n))
    return 4 * b * s * d * n, nbytes


def selective_scan_bwd_cost(abar_shape: tuple, abar_dtype: torch.dtype,
                            bx_dtype: torch.dtype) -> tuple[int, int]:
    """(FLOP, bytes) of one backward call: 8BSDN (the adjoint's FMA, d
    abar, dc's FMA and the state rebuilt, a state element a step); abar,
    bx, c and dy read once, d abar, d bx and dc written once (the
    checkpoints are the forward's output, not counted)."""
    b, s, d, n = abar_shape
    e = bx_dtype.itemsize
    nbytes = (2 * b * s * d * n * (abar_dtype.itemsize + e)
              + 2 * b * s * n * e + b * s * d * e)
    return 8 * b * s * d * n, nbytes


def _plain_forward(abar, bx, c, keep: bool):
    """The plain forward loop; with ``keep`` also the state before every
    CKPT_STEPS steps."""
    b, s, d, n = abar.shape
    h = torch.zeros(b, d, n, dtype=torch.float32, device=abar.device)
    y = torch.empty(b, s, d, dtype=bx.dtype, device=abar.device)
    ckpt = (torch.empty(ckpt_shape(b, s, d, n), dtype=torch.float32,
                        device=abar.device) if keep else None)
    for t in range(s):
        if keep and t % CKPT_STEPS == 0:
            ckpt[:, t // CKPT_STEPS] = h
        h = abar[:, t].float() * h + bx[:, t].float()
        y[:, t] = torch.einsum("bdn,bn->bd", h, c[:, t].float())
    return y, ckpt


def selective_scan_plain(abar: torch.Tensor, bx: torch.Tensor,
                         c: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel (the CPU path and the card-side
    reference of ``chip_smoke.py``), as ``ref.selective_scan_ref`` of the
    JAX package: a loop over the sequence, vectorised over (B, D, N), the
    state in f32 from zero, the output cast to bx's dtype. Each step's
    slices are cast to f32 as they are used, so no f32 copy of the whole
    input is made."""
    return _plain_forward(abar, bx, c, keep=False)[0]


def selective_scan_ckpt_plain(abar: torch.Tensor, bx: torch.Tensor,
                              c: torch.Tensor
                              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the checkpointing forward kernel -> (y, ckpt): y
    as :func:`selective_scan_plain` (the same loop), ckpt the f32 state
    before steps 0, 8, 16, ... ``(B, ceil(S/8), D, N)``."""
    return _plain_forward(abar, bx, c, keep=True)


def selective_scan_bwd_plain(abar: torch.Tensor, bx: torch.Tensor,
                             c: torch.Tensor, dy: torch.Tensor
                             ) -> tuple[torch.Tensor, ...]:
    """Plain PyTorch version of the backward kernel (the tests' and
    ``chip_smoke.py``'s reference): the gradients of
    :func:`selective_scan_plain` for the output cotangent ``dy`` (B, S,
    D) -> (d abar, d bx, dc) in abar's, bx's and c's dtypes, dc ``(B, S,
    N)``.

    One loop forward keeps every state h_t; one loop backward carries the
    adjoint G_t = ∂L/∂h_t (the output's own step included), all in f32::

        G_t      = c_t dy_t + abar_{t+1} ⊙ G_{t+1}     (G_S = 0)
        d abar_t = G_t ⊙ h_{t-1},   d bx_t = G_t
        dc_t     = Σ_d h_t[d] dy_t[d]
    """
    b, s, d, n = abar.shape
    states = torch.empty(s, b, d, n, dtype=torch.float32, device=abar.device)
    h = torch.zeros(b, d, n, dtype=torch.float32, device=abar.device)
    for t in range(s):
        h = abar[:, t].float() * h + bx[:, t].float()
        states[t] = h
    dabar = torch.empty_like(abar)
    dbx = torch.empty_like(bx)
    dc = torch.empty((b, s, n), dtype=c.dtype, device=abar.device)
    g = torch.zeros_like(h)
    a_next = torch.zeros_like(h)
    for t in reversed(range(s)):
        dyt = dy[:, t].float()
        g = a_next * g + c[:, t].float()[:, None, :] * dyt[:, :, None]
        dbx[:, t] = g
        dabar[:, t] = g * states[t - 1] if t else 0.0
        dc[:, t] = torch.einsum("bdn,bd->bn", states[t], dyt)
        a_next = abar[:, t].float()
    return dabar, dbx, dc


def selective_scan_bwd_ckpt_plain(abar: torch.Tensor, bx: torch.Tensor,
                                  c: torch.Tensor, dy: torch.Tensor,
                                  ckpt: torch.Tensor
                                  ) -> tuple[torch.Tensor, ...]:
    """Plain version of the backward kernel's algorithm, on the forward's
    checkpoints (:func:`selective_scan_ckpt_plain`): interval by interval
    from the end, the states rebuilt from the interval's checkpoint, then
    the adjoint walked back through them, dc_t from the rebuilt h_t (at an
    interval's last step the state after the interval). The gradients of
    :func:`selective_scan_bwd_plain`, in its dtypes."""
    check_ckpt(abar, ckpt)
    b, s, d, n = abar.shape
    dabar = torch.empty_like(abar)
    dbx = torch.empty_like(bx)
    dc = torch.empty((b, s, n), dtype=c.dtype, device=abar.device)
    g = torch.zeros(b, d, n, dtype=torch.float32, device=abar.device)
    a_next = torch.zeros_like(g)
    for ci in reversed(range(ckpt.shape[1])):
        t0, t1 = ci * CKPT_STEPS, min(s, (ci + 1) * CKPT_STEPS)
        states = [ckpt[:, ci]]                  # h_{t-1} for t = t0, ...
        for t in range(t0, t1):
            states.append(abar[:, t].float() * states[-1] + bx[:, t].float())
        for t in reversed(range(t0, t1)):
            dyt = dy[:, t].float()
            g = a_next * g + c[:, t].float()[:, None, :] * dyt[:, :, None]
            dbx[:, t] = g
            dabar[:, t] = g * states[t - t0]
            dc[:, t] = torch.einsum("bdn,bd->bn", states[t - t0 + 1], dyt)
            a_next = abar[:, t].float()
    return dabar, dbx, dc


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built library with its C signatures declared (first call)."""
    lib = build.load("selective_scan")
    for fn in (lib.selective_scan_f32, lib.selective_scan_bf16,
               lib.selective_scan_mixed):
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int64] * 2
                       + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


@functools.cache
def _lib_bwd() -> ctypes.CDLL:
    """The built backward library with its C signatures declared."""
    lib = build.load("selective_scan_bwd")
    for fn in (lib.selective_scan_bwd_f32, lib.selective_scan_bwd_bf16,
               lib.selective_scan_bwd_mixed):
        fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int64] * 5
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


def check_bwd_inputs(abar: torch.Tensor, bx: torch.Tensor, c: torch.Tensor,
                     dy: torch.Tensor) -> None:
    """The forward's checks, and dy ``(B, S, D)`` in bx's dtype on its
    device with unit stride on D."""
    check_inputs(abar, bx, c)
    b, s, d, _ = abar.shape
    if tuple(dy.shape) != (b, s, d) or dy.dtype != bx.dtype \
            or dy.device != bx.device:
        raise ValueError(f"selective_scan_bwd: dy is {tuple(dy.shape)} "
                         f"{dy.dtype} on {dy.device}; want {(b, s, d)} "
                         f"{bx.dtype} on {bx.device}")
    if dy.stride(2) != 1:
        raise ValueError("selective_scan_bwd: the channel axis D of dy "
                         "must have unit stride")


def check_ckpt(abar: torch.Tensor, ckpt: torch.Tensor) -> None:
    """The checkpoints of a forward over abar: f32, contiguous, on
    abar's device, of :func:`ckpt_shape`."""
    want = ckpt_shape(*abar.shape)
    if tuple(ckpt.shape) != want or ckpt.dtype != torch.float32 \
            or ckpt.device != abar.device or not ckpt.is_contiguous():
        raise ValueError(f"selective_scan_bwd: ckpt is {tuple(ckpt.shape)} "
                         f"{ckpt.dtype} on {ckpt.device} (contiguous: "
                         f"{ckpt.is_contiguous()}); want {want} f32 "
                         f"contiguous on {abar.device}")


def _require_cuda(name: str, abar: torch.Tensor, bx: torch.Tensor) -> None:
    if abar.device.type != "cuda":
        raise ValueError(f"{name}: the kernel takes CUDA tensors, got "
                         f"{abar.device} (ops.selective_scan_op runs the "
                         f"plain version on the CPU)")
    if abar.data_ptr() % 16 or bx.data_ptr() % 16:
        raise ValueError(f"{name}: abar and bx must be 16-byte aligned (the "
                         f"kernel loads 16 and 8 bytes at a time)")


def _pick(lib, prefix: str, abar: torch.Tensor, bx: torch.Tensor):
    if bx.dtype == torch.float32:
        return getattr(lib, prefix + "_f32")
    if abar.dtype == torch.bfloat16:
        return getattr(lib, prefix + "_bf16")
    return getattr(lib, prefix + "_mixed")


def _launch_fwd(abar, bx, c, ckpt) -> torch.Tensor:
    """One forward launch; ``ckpt`` None (serving) or the checkpoint
    buffer the kernel fills."""
    check_inputs(abar, bx, c)
    _require_cuda("selective_scan", abar, bx)
    b, s, d, n = abar.shape
    y = torch.empty((b, s, d), dtype=bx.dtype, device=abar.device)
    fn = _pick(_lib(), "selective_scan", abar, bx)
    stream = torch.cuda.current_stream(abar.device).cuda_stream
    with torch.cuda.device(abar.device):
        err = fn(abar.data_ptr(), bx.data_ptr(), c.data_ptr(), y.data_ptr(),
                 None if ckpt is None else ckpt.data_ptr(), c.stride(0),
                 c.stride(1), b, s, d, n, stream)
    if err != 0:
        raise RuntimeError(f"selective_scan kernel launch failed: "
                           f"cudaError {err}")
    selective_scan.launches += 1
    return y


def selective_scan_fwd(abar: torch.Tensor, bx: torch.Tensor,
                       c: torch.Tensor) -> torch.Tensor:
    """The forward kernel on CUDA tensors, as serving launches it -> y
    ``(B, S, D)`` in bx's dtype, contiguous. Raises on any other device.
    Counts the launch in ``selective_scan.launches``."""
    return _launch_fwd(abar, bx, c, None)


def selective_scan_fwd_ckpt(abar: torch.Tensor, bx: torch.Tensor,
                            c: torch.Tensor
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel with the backward's checkpoints -> (y, ckpt): y
    as :func:`selective_scan_fwd` (bit-equal), ckpt as
    :func:`selective_scan_ckpt_plain`. Counts the launch in
    ``selective_scan.launches`` and ``selective_scan.launches_ckpt``."""
    check_inputs(abar, bx, c)
    _require_cuda("selective_scan", abar, bx)
    ckpt = torch.empty(ckpt_shape(*abar.shape), dtype=torch.float32,
                       device=abar.device)
    y = _launch_fwd(abar, bx, c, ckpt)
    selective_scan.launches_ckpt += 1
    return y, ckpt


def bwd_scratch_floats(b: int, s: int, d: int, n: int) -> int:
    """f32 scratch of the backward kernel (``csrc/selective_scan_bwd.cu``):
    dc's partial per block of 128 / (N / 4) channels. (It also reads the
    forward's checkpoints, :func:`ckpt_shape`.)"""
    blocks = -(-d // (128 // (n // 4)))
    return b * blocks * s * n


def selective_scan_bwd(abar: torch.Tensor, bx: torch.Tensor, c: torch.Tensor,
                       dy: torch.Tensor, ckpt: torch.Tensor | None = None
                       ) -> tuple[torch.Tensor, ...]:
    """The backward kernel on CUDA tensors -> (d abar, d bx, dc): d abar
    and d bx contiguous in abar's and bx's dtypes, dc ``(B, S, N)``
    contiguous in c's. ``ckpt`` holds the checkpoints of
    :func:`selective_scan_fwd_ckpt` over the same inputs (training passes
    the forward's); without them it first runs that forward itself.
    Raises on any other device. Counts the call in
    ``selective_scan.launches_bwd``."""
    check_bwd_inputs(abar, bx, c, dy)
    _require_cuda("selective_scan_bwd", abar, bx)
    if ckpt is None:
        ckpt = selective_scan_fwd_ckpt(abar, bx, c)[1]
    check_ckpt(abar, ckpt)
    b, s, d, n = abar.shape
    dabar, dbx = torch.empty_like(abar), torch.empty_like(bx)
    dc = torch.empty((b, s, n), dtype=c.dtype, device=abar.device)
    n_scratch = bwd_scratch_floats(b, s, d, n)
    scratch = torch.empty(n_scratch, dtype=torch.float32, device=abar.device)
    fn = _pick(_lib_bwd(), "selective_scan_bwd", abar, bx)
    stream = torch.cuda.current_stream(abar.device).cuda_stream
    with torch.cuda.device(abar.device):
        err = fn(abar.data_ptr(), bx.data_ptr(), c.data_ptr(), dy.data_ptr(),
                 ckpt.data_ptr(), dabar.data_ptr(), dbx.data_ptr(),
                 dc.data_ptr(), scratch.data_ptr(), n_scratch, c.stride(0),
                 c.stride(1), dy.stride(0), dy.stride(1), b, s, d, n, stream)
    if err != 0:
        raise RuntimeError(f"selective_scan_bwd kernels launch failed: "
                           f"cudaError {err}")
    selective_scan.launches_bwd += 1
    return dabar, dbx, dc


class SelectiveScanFn(torch.autograd.Function):
    """The scan with a kernel on both sides: the checkpointing forward
    kernel (saving abar, bx, c and its checkpoints), the backward kernel
    on those checkpoints for all three gradients. CUDA tensors only (the
    launchers raise otherwise). Under non-reentrant
    ``torch.utils.checkpoint`` the forward runs twice and the backward
    reads the second run's checkpoints."""

    @staticmethod
    def forward(ctx, abar, bx, c):
        y, ckpt = selective_scan_fwd_ckpt(abar, bx, c)
        ctx.save_for_backward(abar, bx, c, ckpt)
        return y

    @staticmethod
    def backward(ctx, dy):
        abar, bx, c, ckpt = ctx.saved_tensors
        if dy.stride(2) != 1:
            dy = dy.contiguous()
        return selective_scan_bwd(abar, bx, c, dy, ckpt)


def selective_scan(abar: torch.Tensor, bx: torch.Tensor,
                   c: torch.Tensor) -> torch.Tensor:
    """The kernel on CUDA tensors -> y ``(B, S, D)`` in bx's dtype,
    contiguous. With grad enabled and an input that requires grad,
    through :class:`SelectiveScanFn` (the output carries the backward
    kernel's autograd node, its forward storing the checkpoints);
    otherwise one forward launch without them. Raises on any other device
    (the launchers check the inputs)."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (abar, bx, c)):
        return SelectiveScanFn.apply(abar, bx, c)
    return selective_scan_fwd(abar, bx, c)


class SelectiveScanMetaFn(torch.autograd.Function):
    """:class:`SelectiveScanFn` on meta tensors: the forward reports the
    checkpointing forward's cost and saves its checkpoints, the backward
    reports the backward kernel's cost and returns empty gradients (with
    its f32 scratch allocated, as the launcher does)."""

    @staticmethod
    def forward(ctx, abar, bx, c):
        y = _meta_forward(abar, bx, c, ckpt=True)
        ckpt = abar.new_empty(ckpt_shape(*abar.shape), dtype=torch.float32)
        ctx.save_for_backward(abar, bx, c, ckpt)
        return y

    @staticmethod
    def backward(ctx, dy):
        abar, bx, c, _ = ctx.saved_tensors
        b, s, d, n = abar.shape
        abar.new_empty(bwd_scratch_floats(b, s, d, n), dtype=torch.float32)
        meter.report_kernel(
            "selective_scan_bwd",
            *selective_scan_bwd_cost(tuple(abar.shape), abar.dtype,
                                     bx.dtype), tensor_cores=False)
        return (torch.empty_like(abar), torch.empty_like(bx),
                abar.new_empty((b, s, n), dtype=c.dtype))


def _meta_forward(abar, bx, c, ckpt: bool) -> torch.Tensor:
    b, s, d, _ = abar.shape
    meter.report_kernel(
        "selective_scan",
        *selective_scan_cost(tuple(abar.shape), abar.dtype, bx.dtype, ckpt),
        tensor_cores=False)
    return abar.new_empty((b, s, d), dtype=bx.dtype)


def selective_scan_meta(abar: torch.Tensor, bx: torch.Tensor,
                        c: torch.Tensor) -> torch.Tensor:
    """The kernels on meta tensors, launching nothing: y ``(B, S, D)``
    empty in bx's dtype, the call's cost reported to the installed
    meter; under grad through :class:`SelectiveScanMetaFn`, as
    :func:`selective_scan` goes through :class:`SelectiveScanFn`."""
    check_inputs(abar, bx, c)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (abar, bx, c)):
        return SelectiveScanMetaFn.apply(abar, bx, c)
    return _meta_forward(abar, bx, c, ckpt=False)


selective_scan.launches = 0
selective_scan.launches_ckpt = 0
selective_scan.launches_bwd = 0
