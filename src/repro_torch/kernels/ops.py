"""Wrappers around the port's kernels (port of ``repro.kernels.ops``:
the fold, attention, selective-scan and WKV parts).

Each wrapper dispatches on the device of the tensors it is given: CUDA
tensors go through the hand-written kernel (``fedagg``,
``flash_attention``, ``selective_scan``, ``rwkv6_wkv``), CPU tensors
through its plain version (for the simulator's fold, the per-leaf
:func:`repro_torch.core.treeops.tree_combine` — as the JAX dispatcher
picks the einsum on CPU, ``repro/kernels/ops.py:99-103``). There is no
override and no fallback: a CUDA tensor goes
through the kernel or the call raises. ``flash_attention``,
``selective_scan`` and ``rwkv6_wkv`` have backward kernels: on CUDA
inputs that require grad (with grad enabled) their wrappers go through
an autograd Function (``FlashAttentionFn``, ``SelectiveScanFn``,
``RwkvWkvFn``: the forward kernel, then the backward kernel), and
otherwise launch the forward alone, as serving does. The fold has no
backward: on CUDA inputs that require grad its wrapper raises
(``guard.autograd_guard``). On CPU tensors the plain versions' autograd
is the gradient.

Meta tensors take a branch of their own: the kernel's ``*_meta``
function returns the output empty, of the kernel's shape, dtype and
layout, and reports the kernel's cost (its module's cost function) to
the meter the dry run installs (``kernels/meter.py``); under grad the
meta autograd Function's backward does the same for the backward
kernel. It is a device of its own, not a fallback: a CUDA tensor never
reaches it, and a CPU tensor still goes to the plain version.
"""
from __future__ import annotations

from typing import Any, Mapping

import torch

from repro_torch.core.treeops import tree_combine
from repro_torch.kernels import fedagg as _fedagg
from repro_torch.kernels import rwkv6_wkv as _wkv
from repro_torch.kernels import selective_scan as _scan
from repro_torch.kernels.flash_attention import (
    check_inputs, flash_attention, flash_attention_meta,
    flash_attention_plain)


def _weights(weights: Any, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(weights, dtype=torch.float32,
                           device=device).contiguous()


def fedagg_op(stacked: torch.Tensor, weights: Any) -> torch.Tensor:
    """``Σ_s w[s]·stacked[s]`` over a flat ``(S, P)`` tensor: the
    ``fedagg`` kernel on a CUDA tensor, :func:`~repro_torch.kernels.fedagg
    .fedagg_plain` on a CPU tensor (inputs checked the same way on both);
    weights are cast to f32 on ``stacked``'s device."""
    w = _weights(weights, stacked.device)
    if stacked.device.type == "cuda":
        return _fedagg.fedagg(stacked, w)
    if stacked.device.type == "cpu":
        _fedagg.check_inputs(stacked, w)
        return _fedagg.fedagg_plain(stacked, w)
    if stacked.device.type == "meta":
        return _fedagg.fedagg_leaves_meta([stacked], w)[0]
    raise ValueError(f"fedagg_op: unsupported device {stacked.device}")


def fedagg_tree(params_stacked: Mapping[str, torch.Tensor],
                weights: Any) -> dict:
    """The fold of a replica-stacked param dict: each ``(S, *shape)`` leaf
    is folded as its contiguous ``(S, P_leaf)`` view (no concatenation
    into one flat buffer, which would cost an extra pass over the whole
    stack). CUDA leaves go through one ``fedagg_leaves`` call (one kernel
    launch for up to ``MAX_LEAVES`` leaves), CPU leaves through
    ``fedagg_leaves_plain``, meta leaves through ``fedagg_leaves_meta``."""
    keys = list(params_stacked)
    xs = [params_stacked[k] for k in keys]
    w = _weights(weights, xs[0].device)
    flat = [x.reshape(x.shape[0], -1) for x in xs]
    if w.device.type == "cuda":
        folded = _fedagg.fedagg_leaves(flat, w)
    elif w.device.type == "cpu":
        for x in flat:
            _fedagg.check_inputs(x, w)
        folded = _fedagg.fedagg_leaves_plain(flat, w)
    elif w.device.type == "meta":
        folded = _fedagg.fedagg_leaves_meta(flat, w)
    else:
        raise ValueError(f"fedagg_tree: unsupported device {w.device}")
    return {k: y.view(x.shape[1:]) for k, x, y in zip(keys, xs, folded)}


def pad_stacked_rows(params_stacked: Mapping[str, torch.Tensor],
                     weights: Any, multiple: int):
    """Pad the replica axis of a stacked dict and its weights up to the
    next multiple of ``multiple`` with zero rows and zero weights. A
    padded row is ``0.0 * 0.0`` in both fold backends, so it adds exactly
    zero: the padded fold equals the unpadded one."""
    if multiple < 1:
        raise ValueError(f"pad multiple must be >= 1, got {multiple}")
    first = next(iter(params_stacked.values()))
    w = _weights(weights, first.device)
    pad = (-first.shape[0]) % multiple
    if not pad:
        return dict(params_stacked), w
    padded = {k: torch.cat([x, x.new_zeros((pad,) + x.shape[1:])])
              for k, x in params_stacked.items()}
    return padded, torch.cat([w, w.new_zeros(pad)])


def fold_stacked_tree(params_stacked: Mapping[str, torch.Tensor],
                      weights: Any) -> dict:
    """The simulator's weighted model fold: Σ_s weights[s]·stacked[s].

    On CUDA leaves it runs the ``fedagg`` kernel, one launch for the
    whole tree (:func:`fedagg_tree`, which on meta leaves reports that
    launch's cost instead); on CPU leaves the plain per-leaf fold
    (:func:`tree_combine`)."""
    first = next(iter(params_stacked.values()))
    if first.device.type in ("cuda", "meta"):
        return fedagg_tree(params_stacked, weights)
    if first.device.type == "cpu":
        return tree_combine(params_stacked, weights)
    raise ValueError(f"fold: unsupported device {first.device}")


def flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       causal: bool = True,
                       window: int | None = None) -> torch.Tensor:
    """Causal / windowed GQA attention, q ``(B,H,Sq,D)``, k
    ``(B,Hkv,Sk,D)``, v ``(B,Hkv,Sk,Dv)`` -> ``(B,H,Sq,Dv)``: the
    ``flash_attention`` kernel on CUDA tensors, :func:`~repro_torch
    .kernels.flash_attention.flash_attention_plain` on CPU tensors; the
    inputs are checked the same way on both, but for the kernels' table
    of ``(D, Dv)`` pairs, which binds only CUDA tensors. On CUDA tensors with grad enabled and an input that
    requires grad, the wrapper applies ``FlashAttentionFn`` (forward
    kernel with the log-sum-exp saved, backward kernel); otherwise it
    launches the forward with no log-sum-exp, so the serving path is the
    forward kernel alone. On CPU tensors the plain version's autograd is
    the gradient. The JAX wrapper's block sizes are the TPU kernel's
    tiling and do not change the result; the CUDA kernel picks its
    own."""
    check_inputs(q, k, v, window)
    if q.device.type == "cuda":
        return flash_attention(q, k, v, causal=causal, window=window)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal, window)
    if q.device.type == "meta":
        return flash_attention_meta(q, k, v, causal, window)
    raise ValueError(f"flash_attention_op: unsupported device {q.device}")


def selective_scan_op(abar: torch.Tensor, bx: torch.Tensor, c: torch.Tensor,
                      chunk: int = 64, block_d: int = 256) -> torch.Tensor:
    """The Mamba selective scan, abar/bx ``(B,S,D,N)``, c ``(B,S,N)`` ->
    y ``(B,S,D)`` in bx's dtype: the ``selective_scan`` kernel on CUDA
    tensors, :func:`~repro_torch.kernels.selective_scan
    .selective_scan_plain` on CPU tensors; the inputs are checked the same
    way on both. On CUDA tensors with grad enabled and an input that
    requires grad, the wrapper applies ``SelectiveScanFn`` (the forward
    kernel storing the backward's checkpoints, then the backward kernel
    ``csrc/selective_scan_bwd.cu`` on them); otherwise it launches the
    forward alone, without the checkpoints. On CPU tensors the plain
    version's autograd is the gradient. ``chunk`` and ``block_d`` are the
    JAX wrapper's arguments, kept for its signature: they are the TPU
    kernel's tiling of S and D (there divisors of them) and do not change
    the result; the CUDA kernel keeps the state in registers over any S
    and D and does not read them."""
    del chunk, block_d
    _scan.check_inputs(abar, bx, c)
    if abar.device.type == "cuda":
        return _scan.selective_scan(abar, bx, c)
    if abar.device.type == "cpu":
        return _scan.selective_scan_plain(abar, bx, c)
    if abar.device.type == "meta":
        return _scan.selective_scan_meta(abar, bx, c)
    raise ValueError(f"selective_scan_op: unsupported device {abar.device}")


def rwkv6_wkv_op(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 w: torch.Tensor, u: torch.Tensor,
                 chunk: int = 64) -> torch.Tensor:
    """The RWKV-6 WKV recurrence, r/k/v/w ``(B,H,S,N)``, u ``(H,N)`` f32 ->
    y ``(B,H,S,N)`` in r's dtype: the ``rwkv6_wkv`` kernel on CUDA
    tensors, :func:`~repro_torch.kernels.rwkv6_wkv.rwkv6_wkv_plain` on CPU
    tensors; the inputs are checked the same way on both. On CUDA
    tensors with grad enabled and an input that requires grad, the
    wrapper applies ``RwkvWkvFn`` (the forward kernel storing the
    backward's checkpoints, then the backward kernel
    ``csrc/rwkv6_wkv_bwd.cu``); otherwise it launches the forward alone. On CPU tensors the plain version's autograd is the gradient.
    ``chunk`` is the JAX wrapper's argument, kept for its signature: it
    is the TPU kernel's tiling of S (there a divisor of S) and does not
    change the result; the CUDA kernel keeps the state in registers over
    any S and does not read it."""
    del chunk
    _wkv.check_inputs(r, k, v, w, u)
    if r.device.type == "cuda":
        return _wkv.rwkv6_wkv(r, k, v, w, u)
    if r.device.type == "cpu":
        return _wkv.rwkv6_wkv_plain(r, k, v, w, u)
    if r.device.type == "meta":
        return _wkv.rwkv6_wkv_meta(r, k, v, w, u)
    raise ValueError(f"rwkv6_wkv_op: unsupported device {r.device}")
