"""The paper's CNN (McMahan-style FL-MNIST CNN) on PyTorch tensors.

conv5x5x32 -> maxpool2 -> conv5x5x64 -> maxpool2 -> fc512 -> fc10.

Params keep the JAX package's layout (conv weights HWIO, FC weights
``(in, out)``). The forward is written for a stack of S independent
replicas at once (``forward_stacked``): the convolutions run as one
grouped NCHW convolution with ``groups=S`` and the FC layers as batched
matmuls, so a round's local SGD over every satellite is one program.
The single-model forward is the S=1 case.

Layout hazard: the reference flattens the NHWC activation before
``fc1_w`` (``repro/models/cnn.py:55``), so the NCHW activation is
permuted back to NHWC before the flatten; otherwise the rows of
``fc1_w`` would be read in another order.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.paper_cnn import PaperCnnConfig
from repro_torch.models.common import (logits_accuracy, logits_loss,
                                       unstacked)
from repro_torch.models.params import ParamDef, init_params, param_count


def _hwio_to_grouped(w: torch.Tensor) -> torch.Tensor:
    """(S, kh, kw, Cin, Cout) stacked HWIO -> (S*Cout, Cin, kh, kw)."""
    s, kh, kw, ci, co = w.shape
    return w.permute(0, 4, 3, 1, 2).reshape(s * co, ci, kh, kw)


def _conv_relu_pool(x: torch.Tensor, w: torch.Tensor,
                    b: torch.Tensor) -> torch.Tensor:
    """SAME grouped conv + bias + ReLU + 2x2/2 VALID max-pool.

    x: (B, S*Cin, H, W); w: (S, k, k, Cin, Cout); b: (S, Cout)."""
    s = w.shape[0]
    x = F.conv2d(x, _hwio_to_grouped(w), padding="same", groups=s)
    x = torch.relu(x + b.reshape(-1)[None, :, None, None])
    return F.max_pool2d(x, kernel_size=2, stride=2)


class CNN:
    def __init__(self, cfg: PaperCnnConfig):
        self.cfg = cfg

    def defs(self) -> dict:
        c = self.cfg
        c1, c2 = c.channels
        k = c.kernel
        flat = (c.image_size // 4) ** 2 * c2
        return {
            "conv1_w": ParamDef((k, k, 1, c1), scale=0.1),
            "conv1_b": ParamDef((c1,), "zeros"),
            "conv2_w": ParamDef((k, k, c1, c2), scale=0.05),
            "conv2_b": ParamDef((c2,), "zeros"),
            "fc1_w": ParamDef((flat, c.hidden)),
            "fc1_b": ParamDef((c.hidden,), "zeros"),
            "fc2_w": ParamDef((c.hidden, c.num_classes)),
            "fc2_b": ParamDef((c.num_classes,), "zeros"),
        }

    def init(self, gen: torch.Generator, device: torch.device | str,
             dtype: torch.dtype = torch.float32) -> dict:
        return init_params(self.defs(), gen, device, dtype)

    def count_params(self) -> int:
        return param_count(self.defs())

    def forward_stacked(self, p: dict, images: torch.Tensor) -> torch.Tensor:
        """p: leaves with a leading replica axis S; images: (S, B, 28, 28)
        -> logits (S, B, 10)."""
        s, b = images.shape[:2]
        x = images.transpose(0, 1)                    # (B, S, H, W), Cin=1
        x = _conv_relu_pool(x, p["conv1_w"], p["conv1_b"])
        x = _conv_relu_pool(x, p["conv2_w"], p["conv2_b"])
        c2, h, w = x.shape[1] // s, x.shape[2], x.shape[3]
        # (B, S*C2, h, w) -> per-replica NHWC flatten (S, B, h*w*C2)
        x = x.reshape(b, s, c2, h, w).permute(1, 0, 3, 4, 2)
        x = x.reshape(s, b, h * w * c2)
        x = torch.relu(torch.baddbmm(p["fc1_b"][:, None], x, p["fc1_w"]))
        return torch.baddbmm(p["fc2_b"][:, None], x, p["fc2_w"])

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
