"""Optimizers of the port (port of ``repro.optim``) on the port's flat
``dict[str, Tensor]`` params."""
from repro_torch.optim.optimizers import (
    OptState,
    Optimizer,
    adamw,
    apply_updates,
    clip_by_global_norm,
    sgd,
)

__all__ = ["OptState", "Optimizer", "adamw", "apply_updates",
           "clip_by_global_norm", "sgd"]
