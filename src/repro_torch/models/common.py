"""Heads shared by the port's classifiers (cross-entropy, accuracy) and
the single-model form of a replica-stacked method."""
from __future__ import annotations

import torch


def logits_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean of ``logsumexp - gold`` over the batch axis (-2)."""
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None])[..., 0]
    return (logz - gold).mean(dim=-1)


def logits_accuracy(logits: torch.Tensor,
                    labels: torch.Tensor) -> torch.Tensor:
    return (torch.argmax(logits, dim=-1) == labels).float().mean(dim=-1)


def unstacked(fn):
    """The single-model form of a replica-stacked method (S=1)."""
    def single(self, p: dict, images: torch.Tensor, *rest):
        p1 = {k: v[None] for k, v in p.items()}
        return fn(self, p1, images[None], *(r[None] for r in rest))[0]
    single.__doc__ = f"Single-model form of ``{fn.__name__}``."
    return single
