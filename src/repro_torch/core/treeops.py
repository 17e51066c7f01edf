"""Tensor-dict arithmetic for the execute phase (port of
``repro.core.treeops`` without ``tree_weighted_sum``, which nothing in
the port calls).

Param trees are flat ``dict[str, Tensor]``; a *stacked* tree carries a
leading replica (satellite) axis on every leaf.
"""
from __future__ import annotations

from typing import Any, Mapping

import torch


def tree_scale(tree: Mapping[str, torch.Tensor], s: Any) -> dict:
    """Every leaf times the scalar ``s``."""
    return {k: x * s for k, x in tree.items()}


def tree_add(a: Mapping[str, torch.Tensor],
             b: Mapping[str, torch.Tensor]) -> dict:
    """Leafwise ``a + b`` of two trees with the same keys."""
    return {k: x + b[k] for k, x in a.items()}


def tree_sub(a: Mapping[str, torch.Tensor],
             b: Mapping[str, torch.Tensor]) -> dict:
    """Leafwise ``a - b`` of two trees with the same keys."""
    return {k: x - b[k] for k, x in a.items()}


def tree_combine(stacked: Mapping[str, torch.Tensor],
                 weights: Any) -> dict:
    """Σ_s weights[s] · stacked[s] per leaf — the plain fold: f32
    products summed over the leading axis (the reference's ``einsum``).
    Weights are cast to f32 on the leaves' device.

    Written as multiply-then-sum rather than a BLAS contraction: the sum
    over the leading axis adds the rows in order, so appending
    zero-weight zero rows leaves the result bit-equal (the padding
    contract of ``kernels.ops.pad_stacked_rows``), which a BLAS gemv
    does not promise."""
    out = {}
    for k, x in stacked.items():
        w = torch.as_tensor(weights, dtype=torch.float32, device=x.device)
        w = w.reshape(-1, *([1] * (x.dim() - 1)))
        out[k] = (w * x.to(torch.float32)).sum(0).to(x.dtype)
    return out


def tree_broadcast(tree: Mapping[str, torch.Tensor], n: int) -> dict:
    """Every leaf as a stacked ``(n, ...)`` replica view (no copy)."""
    return {k: x.unsqueeze(0).expand(n, *x.shape) for k, x in tree.items()}


def tree_row(stacked: Mapping[str, torch.Tensor], i: int) -> dict:
    """Row ``i`` of a stacked tree (views)."""
    return {k: x[i] for k, x in stacked.items()}


def tree_set_row(stacked: Mapping[str, torch.Tensor], i: int,
                 row: Mapping[str, torch.Tensor]) -> dict:
    """Row update of a stacked tree. Returns new leaves; the inputs are
    not written (the reference's functional ``.at[i].set``)."""
    out = {}
    for k, x in stacked.items():
        y = x.clone()
        y[i] = row[k]
        out[k] = y
    return out


__all__ = ["tree_scale", "tree_add", "tree_sub", "tree_combine",
           "tree_broadcast", "tree_row", "tree_set_row"]
