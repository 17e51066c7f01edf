"""RWKV-6 WKV recurrence (prefill and training) on Hopper.

Per (batch, head), with an N x N f32 state S that starts at zero::

    y_t = r_tᵀ (S + diag(u) k_t v_tᵀ)
    S  ← diag(w_t) S + k_t v_tᵀ

r, k, v and w are ``(B, H, S, N)``, u is ``(H, N)`` f32, and y comes
back ``(B, H, S, N)`` in r's dtype. r, k and v share one dtype, f32 or
bf16; w is f32 or r's dtype (the model passes its decay in f32, see
``csrc/rwkv6_wkv.cu``).

The forward kernel is ``csrc/rwkv6_wkv.cu`` (CUDA C++ for sm_90a; its
header has the bound at the prefill shape and the design); it replaces
the Pallas TPU kernel ``rwkv6_wkv`` of ``repro/kernels/rwkv6_wkv.py:47``.
The backward kernel is ``csrc/rwkv6_wkv_bwd.cu`` (the reverse recurrence
of the state's adjoint, with the state rebuilt from checkpoints; its
header has the bound at the training shape and the scratch it needs);
the JAX package has no backward kernel, it differentiates jnp. The
checkpoints come from the forward kernel: under grad it also stores the
state before every ``CKPT_STEPS`` = 16 steps and c_t = Σ_n r u k
(:func:`rwkv6_wkv_fwd_ckpt`), and the backward reads them.

:func:`rwkv6_wkv` checks its inputs and launches the kernels; it takes
CUDA tensors only. The choice between kernel and plain version is made
in one place, :func:`repro_torch.kernels.ops.rwkv6_wkv_op`: CPU tensors
go to :func:`rwkv6_wkv_plain` — only because they lie on the CPU — and a
CUDA tensor never reaches the plain version. With grad enabled and an
input that requires grad, the wrapper applies :class:`RwkvWkvFn` (the
checkpointing forward kernel, then :func:`rwkv6_wkv_bwd` on its
checkpoints in the backward); otherwise it launches the forward alone,
without the checkpoint stores, as serving does. Any (b, h, s) strides
are taken as long as N has unit stride, so the model's ``(B, S, H, N)``
projections go in as transposed views; the output is laid out like r.
The forward kernel stages its tiles by TMA, whose boxes need a base and
strides in multiples of 16 bytes (8 bytes for N = 4 in bf16, which
copies by cp.async): the forward launcher copies any other view into a
dense tensor first. The backward kernel copies rows by cp.async under
the same rule (16 bytes, 8 for N = 4 in bf16), and its launcher copies
dy or an input likewise; its gradients are laid out like their inputs.
``rwkv6_wkv.launches`` counts forward launches,
``rwkv6_wkv.launches_ckpt`` those of them that stored checkpoints,
``rwkv6_wkv.launches_bwd`` backward launches (one call, two kernels),
``rwkv6_wkv.copies`` the inputs copied so. :func:`rwkv6_wkv_cost` and
:func:`rwkv6_wkv_bwd_cost` are a call's FLOP and bytes, the bounds'
numerators; on meta tensors (:func:`rwkv6_wkv_meta`, which
``ops.rwkv6_wkv_op`` calls for them) nothing launches, and the call
reports that cost to the dry run's meter (``kernels/meter.py``), under
grad through :class:`RwkvWkvMetaFn`.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import build, meter

HEAD_SIZES = (4, 8, 16, 32, 64)
_DTYPES = (torch.float32, torch.bfloat16)
# Steps between the backward's checkpoints: the forward kernel's tile.
CKPT_STEPS = 16


def ckpt_shapes(b: int, h: int, s: int, n: int) -> tuple[tuple, tuple]:
    """Shapes of the checkpoints the forward stores under grad (f32):
    the state before every CKPT_STEPS steps ``(B, H, ceil(S/16), N, N)``
    and c_t ``(B, H, S)``."""
    return (b, h, -(-s // CKPT_STEPS), n, n), (b, h, s)


def rwkv6_wkv_cost(shape: tuple, dtype: torch.dtype, w_dtype: torch.dtype,
                   ckpt: bool = False) -> tuple[int, int]:
    """(FLOP, bytes) of one forward call over r ``(B, H, S, N)``: per (b,
    h, step) y = rᵀS + (Σ_n r u k) v is 2N² + 5N and the update S = w ⊙ S
    + k vᵀ is 3N²; r, k, v, w and the f32 u read once, y written once,
    and with ``ckpt`` the f32 checkpoints and c_t stored."""
    b, h, s, n = shape
    rows = b * h * s * n
    nbytes = 4 * rows * dtype.itemsize + rows * w_dtype.itemsize + 4 * h * n
    if ckpt:
        nbytes += 4 * sum(math.prod(x) for x in ckpt_shapes(b, h, s, n))
    return b * h * s * (5 * n * n + 5 * n), nbytes


def rwkv6_wkv_bwd_cost(shape: tuple, dtype: torch.dtype,
                       w_dtype: torch.dtype) -> tuple[int, int]:
    """(FLOP, bytes) of one backward call: 14N² + 16N a (b, h, step);
    r, k, v, w, u and dy read once, dr, dk, dv, dw and the f32 du written
    once (the checkpoints are the forward's output, not counted)."""
    b, h, s, n = shape
    rows = b * h * s * n
    nbytes = (7 * rows * dtype.itemsize + 2 * rows * w_dtype.itemsize
              + 8 * h * n)
    return b * h * s * (14 * n * n + 16 * n), nbytes


def _plain_forward(r, k, v, w, u, keep: bool):
    """The plain forward loop; with ``keep`` also the state before every
    CKPT_STEPS steps."""
    b, h, s, n = r.shape
    rf, kf, vf, wf = (a.float() for a in (r, k, v, w))
    uu = u.float()[None, :, :, None]
    state = torch.zeros(b, h, n, n, dtype=torch.float32, device=r.device)
    ckpt = (torch.empty(ckpt_shapes(b, h, s, n)[0], dtype=torch.float32,
                        device=r.device) if keep else None)
    ys = []
    for t in range(s):
        if keep and t % CKPT_STEPS == 0:
            ckpt[:, :, t // CKPT_STEPS] = state
        kv = kf[:, :, t, :, None] * vf[:, :, t, None, :]
        ys.append(torch.einsum("bhn,bhnm->bhm", rf[:, :, t],
                               state + uu * kv))
        state = wf[:, :, t, :, None] * state + kv
    return torch.stack(ys, dim=2).to(r.dtype), ckpt


def rwkv6_wkv_plain(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    w: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel (the CPU path and the card-side
    reference of ``chip_smoke.py``), as ``ref.rwkv6_wkv_ref`` of the JAX
    package: a loop over the sequence, vectorised over (B, H, N, N), the
    state in f32 from zero, the output cast to r's dtype."""
    return _plain_forward(r, k, v, w, u, keep=False)[0]


def rwkv6_wkv_ckpt_plain(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         w: torch.Tensor, u: torch.Tensor
                         ) -> tuple[torch.Tensor, ...]:
    """Plain version of the checkpointing forward kernel -> (y, ckpt, c):
    y as :func:`rwkv6_wkv_plain` (the same loop), ckpt the f32 state
    before steps 0, 16, 32, ... ``(B, H, ceil(S/16), N, N)``, c the f32
    ``(B, H, S)`` c_t = Σ_n r_t u k_t."""
    y, ckpt = _plain_forward(r, k, v, w, u, keep=True)
    c = (r.float() * u.float()[None, :, None, :] * k.float()).sum(-1)
    return y, ckpt, c


def rwkv6_wkv_bwd_plain(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        w: torch.Tensor, u: torch.Tensor, dy: torch.Tensor
                        ) -> tuple[torch.Tensor, ...]:
    """Plain PyTorch version of the backward kernel (the tests' and
    ``chip_smoke.py``'s reference): the gradients of
    :func:`rwkv6_wkv_plain` for the output cotangent ``dy`` -> (dr, dk,
    dv, dw, du), dr, dk, dv in r's dtype, dw in w's, du ``(H, N)`` f32.

    One loop forward keeps every state S_{t-1}; one loop backward carries
    the adjoint G_t of the state after step t (G_{S-1} = 0,
    G_{t-1} = diag(w_t) G_t + r_t dy_tᵀ), all in f32::

        dr_t = S_{t-1} dy_t + u ⊙ k_t (v_t · dy_t)
        dk_t = G_t v_t      + u ⊙ r_t (v_t · dy_t)
        dv_t = G_tᵀ k_t     + (Σ_n r_t u k_t) dy_t
        dw_t = Σ_m G_t ⊙ S_{t-1}
        du   = Σ_{b,t} r_t ⊙ k_t (v_t · dy_t)
    """
    b, h, s, n = r.shape
    rf, kf, vf, wf, dyf = (a.float() for a in (r, k, v, w, dy))
    uu = u.float()[None, :, :]
    states = torch.empty(s, b, h, n, n, dtype=torch.float32,
                         device=r.device)
    state = torch.zeros(b, h, n, n, dtype=torch.float32, device=r.device)
    for t in range(s):
        states[t] = state
        state = (wf[:, :, t, :, None] * state
                 + kf[:, :, t, :, None] * vf[:, :, t, None, :])
    vdy = (vf * dyf).sum(-1, keepdim=True)                   # (B, H, S, 1)
    bonus = (rf * uu[:, :, None] * kf).sum(-1, keepdim=True)
    grads = [torch.empty(b, h, s, n, dtype=torch.float32, device=r.device)
             for _ in range(4)]
    dr, dk, dv, dw = grads
    g = torch.zeros_like(state)
    for t in reversed(range(s)):
        prev, dyt = states[t], dyf[:, :, t]
        dr[:, :, t] = (torch.einsum("bhnm,bhm->bhn", prev, dyt)
                       + uu * kf[:, :, t] * vdy[:, :, t])
        dk[:, :, t] = (torch.einsum("bhnm,bhm->bhn", g, vf[:, :, t])
                       + uu * rf[:, :, t] * vdy[:, :, t])
        dv[:, :, t] = (torch.einsum("bhnm,bhn->bhm", g, kf[:, :, t])
                       + bonus[:, :, t] * dyt)
        dw[:, :, t] = (g * prev).sum(-1)
        g = (wf[:, :, t, :, None] * g
             + rf[:, :, t, :, None] * dyt[:, :, None, :])
    du = (rf * kf * vdy).sum((0, 2))
    return (dr.to(r.dtype), dk.to(k.dtype), dv.to(v.dtype), dw.to(w.dtype),
            du)


def rwkv6_wkv_bwd_ckpt_plain(r: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, w: torch.Tensor,
                             u: torch.Tensor, dy: torch.Tensor,
                             ckpt: torch.Tensor, c: torch.Tensor
                             ) -> tuple[torch.Tensor, ...]:
    """Plain version of the backward kernel's algorithm, on the forward's
    checkpoints (:func:`rwkv6_wkv_ckpt_plain`): interval by interval from
    the end, the states S_{t-1} rebuilt from the interval's checkpoint,
    then the adjoint walked back through them; dv's bonus from ``c``.
    The gradients of :func:`rwkv6_wkv_bwd_plain`, in its dtypes."""
    check_ckpt(r, ckpt, c)
    b, h, s, n = r.shape
    rf, kf, vf, wf, dyf = (a.float() for a in (r, k, v, w, dy))
    uu = u.float()[None, :, :]
    vdy = (vf * dyf).sum(-1, keepdim=True)                   # (B, H, S, 1)
    dr, dk, dv, dw = (torch.empty(b, h, s, n, dtype=torch.float32,
                                  device=r.device) for _ in range(4))
    g = torch.zeros(b, h, n, n, dtype=torch.float32, device=r.device)
    for ci in reversed(range(ckpt.shape[2])):
        t0, t1 = ci * CKPT_STEPS, min(s, (ci + 1) * CKPT_STEPS)
        state, prevs = ckpt[:, :, ci], []
        for t in range(t0, t1):
            prevs.append(state)
            state = (wf[:, :, t, :, None] * state
                     + kf[:, :, t, :, None] * vf[:, :, t, None, :])
        for t in reversed(range(t0, t1)):
            prev, dyt = prevs[t - t0], dyf[:, :, t]
            dr[:, :, t] = (torch.einsum("bhnm,bhm->bhn", prev, dyt)
                           + uu * kf[:, :, t] * vdy[:, :, t])
            dk[:, :, t] = (torch.einsum("bhnm,bhm->bhn", g, vf[:, :, t])
                           + uu * rf[:, :, t] * vdy[:, :, t])
            dv[:, :, t] = (torch.einsum("bhnm,bhn->bhm", g, kf[:, :, t])
                           + c[:, :, t, None] * dyt)
            dw[:, :, t] = (g * prev).sum(-1)
            g = (wf[:, :, t, :, None] * g
                 + rf[:, :, t, :, None] * dyt[:, :, None, :])
    du = (rf * kf * vdy).sum((0, 2))
    return (dr.to(r.dtype), dk.to(k.dtype), dv.to(v.dtype), dw.to(w.dtype),
            du)


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built library with its C signatures declared (first call)."""
    lib = build.load("rwkv6_wkv")
    for fn in (lib.rwkv6_wkv_f32, lib.rwkv6_wkv_bf16,
               lib.rwkv6_wkv_bf16_wbf16):
        fn.argtypes = ([ctypes.c_void_p] * 8
                       + [ctypes.POINTER(ctypes.c_int64)]
                       + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


@functools.cache
def _lib_bwd() -> ctypes.CDLL:
    """The built backward library with its C signatures declared."""
    lib = build.load("rwkv6_wkv_bwd")
    for fn in (lib.rwkv6_wkv_bwd_f32, lib.rwkv6_wkv_bwd_bf16,
               lib.rwkv6_wkv_bwd_bf16_wbf16):
        fn.argtypes = ([ctypes.c_void_p] * 14 + [ctypes.c_int64]
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


def check_bwd_inputs(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     w: torch.Tensor, u: torch.Tensor,
                     dy: torch.Tensor) -> None:
    """The forward's checks, and dy of r's shape, dtype and device with
    unit stride on N."""
    check_inputs(r, k, v, w, u)
    if dy.shape != r.shape or dy.dtype != r.dtype or dy.device != r.device:
        raise ValueError(f"rwkv6_wkv_bwd: dy is {tuple(dy.shape)} "
                         f"{dy.dtype} on {dy.device}; want r's "
                         f"{tuple(r.shape)} {r.dtype} on {r.device}")
    if dy.stride(3) != 1:
        raise ValueError("rwkv6_wkv_bwd: the head axis N of dy must have "
                         "unit stride")


def check_ckpt(r: torch.Tensor, ckpt: torch.Tensor, c: torch.Tensor
               ) -> None:
    """The checkpoints of a forward over r: f32, contiguous, on r's
    device, of :func:`ckpt_shapes`."""
    want = ckpt_shapes(*r.shape)
    for name, t, shape in (("ckpt", ckpt, want[0]), ("c", c, want[1])):
        if tuple(t.shape) != shape or t.dtype != torch.float32 \
                or t.device != r.device or not t.is_contiguous():
            raise ValueError(f"rwkv6_wkv_bwd: {name} is {tuple(t.shape)} "
                             f"{t.dtype} on {t.device} (contiguous: "
                             f"{t.is_contiguous()}); want {shape} f32 "
                             f"contiguous on {r.device}")


def _require_cuda(name: str, t: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name}: the kernel takes CUDA tensors, got "
                         f"{t.device} (ops.rwkv6_wkv_op runs the plain "
                         f"version on the CPU)")


def _addressable_copy(t: torch.Tensor, n: int) -> torch.Tensor:
    """``t`` itself if the kernels' row copies can address it, else a
    dense copy (counted in ``rwkv6_wkv.copies``)."""
    if addressable(t, n):
        return t
    rwkv6_wkv.copies += 1
    return t.clone(memory_format=torch.contiguous_format)


def _launch_fwd(r, k, v, w, u, ckpt, cs) -> torch.Tensor:
    """One forward launch; ``ckpt`` and ``cs`` both None (serving) or
    the checkpoint buffers the kernel fills."""
    check_inputs(r, k, v, w, u)
    _require_cuda("rwkv6_wkv", r)
    b, h, s, n = r.shape
    u = u.contiguous()
    y = torch.empty_like(r)
    r, k, v, w = (_addressable_copy(t, n) for t in (r, k, v, w))
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
                 u.data_ptr(), y.data_ptr(),
                 None if ckpt is None else ckpt.data_ptr(),
                 None if cs is None else cs.data_ptr(), strides, b, h, s, n,
                 stream)
    if err != 0:
        raise RuntimeError(f"rwkv6_wkv kernel launch failed: cudaError {err}")
    rwkv6_wkv.launches += 1
    return y


def rwkv6_wkv_fwd(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  w: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """The forward kernel on CUDA tensors, as serving launches it ->
    ``(B, H, S, N)`` in r's dtype, laid out like r. Raises on any other
    device. Counts the launch in ``rwkv6_wkv.launches``."""
    return _launch_fwd(r, k, v, w, u, None, None)


def rwkv6_wkv_fwd_ckpt(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       w: torch.Tensor, u: torch.Tensor
                       ) -> tuple[torch.Tensor, ...]:
    """The forward kernel with the backward's checkpoints -> (y, ckpt, c):
    y as :func:`rwkv6_wkv_fwd` (bit-equal), ckpt and c as
    :func:`rwkv6_wkv_ckpt_plain`. Counts the launch in
    ``rwkv6_wkv.launches`` and ``rwkv6_wkv.launches_ckpt``."""
    check_inputs(r, k, v, w, u)
    _require_cuda("rwkv6_wkv", r)
    shape_ck, shape_c = ckpt_shapes(*r.shape)
    ckpt = torch.empty(shape_ck, dtype=torch.float32, device=r.device)
    c = torch.empty(shape_c, dtype=torch.float32, device=r.device)
    y = _launch_fwd(r, k, v, w, u, ckpt, c)
    rwkv6_wkv.launches_ckpt += 1
    return y, ckpt, c


def bwd_scratch_floats(b: int, h: int, s: int, n: int) -> int:
    """f32 the backward kernel (``csrc/rwkv6_wkv_bwd.cu``) reads and
    writes beyond its inputs and outputs: the forward's checkpoints (the
    state before every 16 steps) and c_t, and du's per-(b, h) partials
    (the wrapper's scratch)."""
    shape_ck, shape_c = ckpt_shapes(b, h, s, n)
    return math.prod(shape_ck) + math.prod(shape_c) + b * h * n


def rwkv6_wkv_bwd(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  w: torch.Tensor, u: torch.Tensor, dy: torch.Tensor,
                  ckpt: torch.Tensor | None = None,
                  c: torch.Tensor | None = None
                  ) -> tuple[torch.Tensor, ...]:
    """The backward kernel on CUDA tensors -> (dr, dk, dv, dw, du): dr,
    dk, dv in r's dtype and dw in w's, each laid out like its input; du
    ``(H, N)`` f32. ``ckpt`` and ``c`` are the checkpoints of
    :func:`rwkv6_wkv_fwd_ckpt` over the same inputs (training passes the
    forward's); without them it first runs that forward itself. Raises on
    any other device. Counts the call in ``rwkv6_wkv.launches_bwd``."""
    check_bwd_inputs(r, k, v, w, u, dy)
    if (ckpt is None) != (c is None):
        raise ValueError("rwkv6_wkv_bwd: give both ckpt and c, or neither")
    _require_cuda("rwkv6_wkv_bwd", r)
    if ckpt is None:
        _, ckpt, c = rwkv6_wkv_fwd_ckpt(r, k, v, w, u)
    check_ckpt(r, ckpt, c)
    b, h, s, n = r.shape
    u = u.contiguous()
    dr, dk, dv, dw = (torch.empty_like(t) for t in (r, k, v, w))
    du = torch.empty((h, n), dtype=torch.float32, device=r.device)
    r, k, v, w, dy = (_addressable_copy(t, n) for t in (r, k, v, w, dy))
    n_scratch = b * h * n
    scratch = torch.empty(n_scratch, dtype=torch.float32, device=r.device)
    strides = (ctypes.c_int64 * 27)(*(
        st for t in (r, k, v, w, dy, dr, dk, dv, dw)
        for st in t.stride()[:3]))
    lib = _lib_bwd()
    if r.dtype == torch.float32:
        fn = lib.rwkv6_wkv_bwd_f32
    elif w.dtype == torch.float32:
        fn = lib.rwkv6_wkv_bwd_bf16
    else:
        fn = lib.rwkv6_wkv_bwd_bf16_wbf16
    stream = torch.cuda.current_stream(r.device).cuda_stream
    with torch.cuda.device(r.device):
        err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                 u.data_ptr(), dy.data_ptr(), ckpt.data_ptr(), c.data_ptr(),
                 dr.data_ptr(), dk.data_ptr(), dv.data_ptr(), dw.data_ptr(),
                 du.data_ptr(), scratch.data_ptr(), n_scratch, strides, b,
                 h, s, n, stream)
    if err != 0:
        raise RuntimeError(f"rwkv6_wkv_bwd kernels launch failed: "
                           f"cudaError {err}")
    rwkv6_wkv.launches_bwd += 1
    return dr, dk, dv, dw, du


class RwkvWkvFn(torch.autograd.Function):
    """The WKV recurrence with a kernel on both sides: the checkpointing
    forward kernel (saving r, k, v, w, u and its checkpoints), the
    backward kernel on those checkpoints for all five gradients. CUDA
    tensors only (the launchers raise otherwise). Under non-reentrant
    ``torch.utils.checkpoint`` the forward runs twice and the backward
    reads the second run's checkpoints."""

    @staticmethod
    def forward(ctx, r, k, v, w, u):
        y, ckpt, c = rwkv6_wkv_fwd_ckpt(r, k, v, w, u)
        ctx.save_for_backward(r, k, v, w, u, ckpt, c)
        return y

    @staticmethod
    def backward(ctx, dy):
        r, k, v, w, u, ckpt, c = ctx.saved_tensors
        if dy.stride(3) != 1:
            dy = dy.contiguous()
        return rwkv6_wkv_bwd(r, k, v, w, u, dy, ckpt, c)


def rwkv6_wkv(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              w: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """The kernel on CUDA tensors -> ``(B, H, S, N)`` in r's dtype, laid
    out like r. With grad enabled and an input that requires grad,
    through :class:`RwkvWkvFn` (the output carries the backward kernel's
    autograd node, its forward storing the checkpoints); otherwise one
    forward launch without them. Raises on any other device (the
    launchers check the inputs)."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (r, k, v, w, u)):
        return RwkvWkvFn.apply(r, k, v, w, u)
    return rwkv6_wkv_fwd(r, k, v, w, u)


class RwkvWkvMetaFn(torch.autograd.Function):
    """:class:`RwkvWkvFn` on meta tensors: the forward reports the
    checkpointing forward's cost and saves its checkpoints, the backward
    reports the backward kernel's cost and returns empty gradients (with
    du's scratch allocated, as the launcher does)."""

    @staticmethod
    def forward(ctx, r, k, v, w, u):
        y = _meta_forward(r, k, v, w, ckpt=True)
        shape_ck, shape_c = ckpt_shapes(*r.shape)
        ckpt = r.new_empty(shape_ck, dtype=torch.float32)
        c = r.new_empty(shape_c, dtype=torch.float32)
        ctx.save_for_backward(r, k, v, w, u, ckpt, c)
        return y

    @staticmethod
    def backward(ctx, dy):
        r, k, v, w, u, _, _ = ctx.saved_tensors
        b, h, _, n = r.shape
        r.new_empty(b * h * n, dtype=torch.float32)
        meter.report_kernel(
            "rwkv6_wkv_bwd",
            *rwkv6_wkv_bwd_cost(tuple(r.shape), r.dtype, w.dtype),
            tensor_cores=False)
        return (torch.empty_like(r), torch.empty_like(k),
                torch.empty_like(v), torch.empty_like(w),
                u.new_empty((h, n), dtype=torch.float32))


def _meta_forward(r, k, v, w, ckpt: bool) -> torch.Tensor:
    meter.report_kernel("rwkv6_wkv",
                        *rwkv6_wkv_cost(tuple(r.shape), r.dtype, w.dtype,
                                        ckpt), tensor_cores=False)
    return torch.empty_like(r)


def rwkv6_wkv_meta(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   w: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """The kernels on meta tensors, launching nothing: y laid out like r,
    empty, the call's cost reported to the installed meter; under grad
    through :class:`RwkvWkvMetaFn`, as :func:`rwkv6_wkv` goes through
    :class:`RwkvWkvFn`."""
    check_inputs(r, k, v, w, u)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (r, k, v, w, u)):
        return RwkvWkvMetaFn.apply(r, k, v, w, u)
    return _meta_forward(r, k, v, w, ckpt=False)


rwkv6_wkv.launches = 0
rwkv6_wkv.launches_ckpt = 0
rwkv6_wkv.launches_bwd = 0
rwkv6_wkv.copies = 0
