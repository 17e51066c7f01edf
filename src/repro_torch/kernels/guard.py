"""The fold's refusal to drop gradients.

``fedagg`` (and ``fedagg_leaves``) is forward only: its wrapper writes
into a fresh tensor through ctypes, so an input's gradient path would end
there without an error. The wrapper calls :func:`autograd_guard` first;
the plain version, which the ``ops`` dispatchers run on CPU tensors,
stays differentiable. The fold is applied under no grad. The other
kernels (``flash_attention``, ``rwkv6_wkv``, ``selective_scan``) have
backward kernels: their wrappers apply an autograd Function when an input
requires grad, and do not call the guard.
"""
from __future__ import annotations

import torch


def autograd_guard(name: str, *tensors: torch.Tensor) -> None:
    """Raise ``RuntimeError`` when grad is enabled and any of ``tensors``
    requires grad: kernel ``name`` has no backward."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: an input requires grad, but the kernel has no "
            f"backward, so its gradient would be dropped silently; call it "
            f"under torch.no_grad() or on detached inputs")
