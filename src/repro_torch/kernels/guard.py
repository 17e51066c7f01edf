"""The kernel wrappers' refusal to drop gradients.

``fedagg`` (and ``fedagg_leaves``), ``rwkv6_wkv`` and ``selective_scan``
are forward only: a wrapper writes into a fresh tensor through ctypes,
so an input's gradient path would end there without an error. Each of
those wrappers calls :func:`autograd_guard` first; the plain versions,
which the ``ops`` dispatchers run on CPU tensors, stay differentiable.
``flash_attention`` no longer calls it: it has a backward kernel, and
its wrapper applies ``FlashAttentionFn`` when an input requires grad.
Backward kernels for ``rwkv6_wkv`` and ``selective_scan`` (ROADMAP Queue
B) will replace the guard there; the fold is applied under no grad.
"""
from __future__ import annotations

import torch


def autograd_guard(name: str, *tensors: torch.Tensor) -> None:
    """Raise ``RuntimeError`` when grad is enabled and any of ``tensors``
    requires grad: kernel ``name`` has no backward yet."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: an input requires grad, but the kernel has no "
            f"backward yet (ROADMAP Queue B), so its gradient would be "
            f"dropped silently; call it under torch.no_grad() or on "
            f"detached inputs")
