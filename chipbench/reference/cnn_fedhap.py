"""Plain-PyTorch reference of a FedHAP simulation with the paper's CNN:
the plan (``fedhap_plan``), every satellite's local SGD from the global
model, the Eq. 14-16 fold, and the accuracy on the held-out digits after
each round.

The CNN is written for one model (``F.conv2d`` in NCHW with SAME
padding, a 2x2 max-pool after each convolution, the NHWC flatten the
paper's layout implies, then two dense layers) and mapped over the
satellites with ``torch.func.vmap``. Float32 with TF32 off, as the
configuration states; ``tf32=True`` computes it in the precision below,
the control. Imports nothing of the program.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch.func import grad, vmap

from chipbench.reference.fedhap_plan import Plan


def cnn_forward(p: dict, x: torch.Tensor) -> torch.Tensor:
    """Logits of one model; ``x`` (B, 28, 28); conv weights HWIO."""
    h = x[:, None]
    for w, b in (("conv1_w", "conv1_b"), ("conv2_w", "conv2_b")):
        h = F.conv2d(h, p[w].permute(3, 2, 0, 1), padding="same")
        h = F.max_pool2d(torch.relu(h + p[b][None, :, None, None]), 2, 2)
    h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)
    h = torch.relu(h @ p["fc1_w"] + p["fc1_b"])
    return h @ p["fc2_w"] + p["fc2_b"]


def _loss(p: dict, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    logits = cnn_forward(p, x)
    return (torch.logsumexp(logits, -1)
            - logits.gather(-1, y[:, None])[:, 0]).mean()


_sat_grad = vmap(grad(_loss))


def accuracy(p: dict, x: torch.Tensor, y: torch.Tensor,
             chunk: int = 1000) -> float:
    with torch.no_grad():
        hits = sum(int((cnn_forward(p, x[i:i + chunk]).argmax(-1)
                        == y[i:i + chunk]).sum())
                   for i in range(0, len(x), chunk))
    return hits / len(x)


def simulate(sim: dict, init: dict, images: np.ndarray, labels: np.ndarray,
             device, tf32: bool = False):
    """The run of ``sim`` (SimConfig's fields) from ``init`` (numpy
    leaves) on the digits ``images``/``labels``. Returns ``(history,
    params, first)``: ``(hours, round, accuracy)`` after each evaluated
    round, as the program records it, the final global model, and the
    global model after the first round."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        return _simulate(sim, init, images, labels, device)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def _simulate(sim, init, images, labels, device):
    n_params = sum(int(np.prod(v.shape)) for v in init.values())
    plan = Plan(sim, labels, n_params)
    n_eval, bs = sim["eval_samples"], sim["batch_size"]
    lr = sim["learning_rate"]
    x_all = torch.as_tensor(images[n_eval:], device=device)
    y_all = torch.as_tensor(labels[n_eval:].astype(np.int64), device=device)
    ex = torch.as_tensor(images[:n_eval], device=device)
    ey = torch.as_tensor(labels[:n_eval].astype(np.int64), device=device)
    g = {k: torch.as_tensor(v, device=device) for k, v in init.items()}
    history, events, first = [], 0, None
    for block in plan.blocks(sim["plan_block"], sim["max_rounds"]):
        accs = []
        for mu, t_next, idx in block:
            idx = torch.as_tensor(idx, device=device)
            n_sats = idx.shape[0]
            p = {k: v[None].expand(n_sats, *v.shape).clone()
                 for k, v in g.items()}
            for s0 in range(0, idx.shape[1], bs):
                sel = idx[:, s0:s0 + bs]
                grads = _sat_grad(p, x_all[sel], y_all[sel])
                p = {k: p[k] - lr * grads[k] for k in p}
            w = torch.as_tensor(mu, dtype=torch.float32, device=device)
            g = {k: torch.einsum("s,s...->...", w, v) for k, v in p.items()}
            first = g if first is None else first
            events += 1
            due = (events - 1) % sim["eval_every_rounds"] == 0
            accs.append((t_next, events, accuracy(g, ex, ey) if due
                         else None))
        for t_next, ev, acc in accs:
            if acc is not None:
                history.append((t_next / 3600.0, ev, acc))
                if acc >= sim["target_accuracy"]:
                    return history, g, first
    return history, g, first
