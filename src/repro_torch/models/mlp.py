"""The paper's MLP (2-hidden-layer perceptron, McMahan's 2NN) on PyTorch
tensors. Params keep the JAX package's keys and ``(in, out)`` layout;
the forward runs S replicas at once as batched matmuls."""
from __future__ import annotations

import torch

from repro_torch.configs.paper_mlp import PaperMlpConfig
from repro_torch.models.common import (logits_accuracy, logits_loss,
                                       unstacked)
from repro_torch.models.params import ParamDef, init_params, param_count


class MLP:
    def __init__(self, cfg: PaperMlpConfig):
        self.cfg = cfg

    def defs(self) -> dict:
        c = self.cfg
        d: dict = {}
        dims = (c.input_dim,) + c.hidden + (c.num_classes,)
        for i, (a, b) in enumerate(zip(dims, dims[1:])):
            d[f"w{i}"] = ParamDef((a, b))
            d[f"b{i}"] = ParamDef((b,), "zeros")
        return d

    def init(self, gen: torch.Generator, device: torch.device | str,
             dtype: torch.dtype = torch.float32) -> dict:
        return init_params(self.defs(), gen, device, dtype)

    def count_params(self) -> int:
        return param_count(self.defs())

    def forward_stacked(self, p: dict, images: torch.Tensor) -> torch.Tensor:
        """images: (S, B, ...) -> logits (S, B, num_classes)."""
        x = images.reshape(images.shape[0], images.shape[1], -1)
        n = len(self.cfg.hidden)
        for i in range(n):
            x = torch.relu(torch.baddbmm(p[f"b{i}"][:, None], x, p[f"w{i}"]))
        return torch.baddbmm(p[f"b{n}"][:, None], x, p[f"w{n}"])

    def loss_stacked(self, p: dict, images: torch.Tensor,
                     labels: torch.Tensor) -> torch.Tensor:
        """(S,) per-replica mean cross-entropy."""
        return logits_loss(self.forward_stacked(p, images), labels)

    def accuracy_stacked(self, p: dict, images: torch.Tensor,
                         labels: torch.Tensor) -> torch.Tensor:
        return logits_accuracy(self.forward_stacked(p, images), labels)

    forward = unstacked(forward_stacked)
    loss = unstacked(loss_stacked)
    accuracy = unstacked(accuracy_stacked)
