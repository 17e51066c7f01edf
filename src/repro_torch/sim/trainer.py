"""Local training for the timeline simulator (port of
``repro.sim.trainer``).

A round's local SGD runs S satellite replicas at once: the model's
``loss_stacked`` evaluates every replica on its own mini-batch (grouped
convolutions and batched matmuls over the replica axis), and one
backward of ``Σ_s loss_s`` gives each replica its own gradient, since
the replicas share no parameters. The index sampler is the reference's
numpy code, unchanged, so index tables stay bit-equal to the JAX
package's.
"""
from __future__ import annotations

from typing import Any, Sequence

import numpy as np
import torch

from repro_torch.data.loader import FederatedData
from repro_torch.debug.sanitize import to_device, to_host


class LocalTrainer:
    """Wraps a CNN/MLP model with replica-stacked local SGD on
    ``device``."""

    def __init__(self, model: Any, learning_rate: float = 0.01,
                 batch_size: int = 32, device: torch.device | str = "cuda"):
        self.model = model
        self.lr = learning_rate
        self.batch_size = batch_size
        self.device = torch.device(device)

    def init(self, seed: int = 0) -> dict:
        """Fresh params from a CPU ``torch.Generator`` seeded with
        ``seed`` (the same weights on every device; not the JAX
        package's weights — see ``params_from_numpy``)."""
        gen = torch.Generator(device="cpu").manual_seed(seed)
        return self.model.init(gen, self.device)

    def multi_step(self, stacked: dict, images_steps: torch.Tensor,
                   labels_steps: torch.Tensor):
        """``n_steps`` SGD steps of S replicas.

        ``stacked``: leaves ``(S, ...)`` (broadcast views are fine: the
        first update makes fresh tensors); ``images_steps``:
        ``(S, n_steps, bs, ...)``; ``labels_steps``: ``(S, n_steps, bs)``
        int64. Returns ``(params, losses)`` with ``losses`` the
        ``(S, n_steps)`` per-step losses, left on the device.
        """
        keys = list(stacked)
        leaves = [stacked[k].detach() for k in keys]
        losses = []
        for t in range(images_steps.shape[1]):
            leaves = [p.requires_grad_() for p in leaves]
            loss = self.model.loss_stacked(dict(zip(keys, leaves)),
                                           images_steps[:, t],
                                           labels_steps[:, t])
            grads = torch.autograd.grad(loss.sum(), leaves)
            with torch.no_grad():
                leaves = [p - self.lr * g for p, g in zip(leaves, grads)]
            losses.append(loss.detach())
        return dict(zip(keys, leaves)), torch.stack(losses, dim=1)

    # ------------------------------------------------------------------
    def sample_client_indices(self, fd: FederatedData,
                              clients: Sequence[int], n_steps: int,
                              rng: np.random.Generator) -> np.ndarray:
        """Global dataset indices for MANY clients' mini-batch streams.

        Keeps the per-client reference semantics — sample WITHOUT
        replacement when the shard covers the burst, with replacement
        when it doesn't — but draws every participating client at once:
        shards >= ``n_steps*bs`` take the ``need`` smallest of per-row
        uniform sort keys (a batched distinct-uniform draw in random
        order), smaller shards take floor(uniform * size) indices.
        Local indices map to global ones through the cached padded
        table. Returns ``(C, n_steps * bs)`` int64 global indices.
        """
        clients = np.asarray(clients, dtype=np.int64)
        padded, sizes = fd.padded_indices()
        need = n_steps * self.batch_size
        szs = sizes[clients]
        if (szs == 0).any():
            raise ValueError(
                f"clients {clients[szs == 0].tolist()} have empty shards")
        local = np.empty((len(clients), need), dtype=np.int64)
        small = szs < need
        if small.any():
            r = rng.random((int(small.sum()), need))
            bound = szs[small][:, None]
            local[small] = np.minimum((r * bound).astype(np.int64),
                                      bound - 1)
        if (~small).any():
            keys = rng.random((int((~small).sum()), padded.shape[1]))
            valid = np.arange(padded.shape[1])[None, :] < szs[~small][:, None]
            local[~small] = np.argsort(
                np.where(valid, keys, np.inf), axis=1)[:, :need]
        return padded[clients[:, None], local]           # (C, need) global

    def gather_selection(self, fd: FederatedData, sel: np.ndarray):
        """``(C, need)`` global indices -> ``(C, n_steps, bs, ...)`` image
        and int64 label tensors on the trainer's device (one host gather,
        one upload each)."""
        n_clients, need = sel.shape
        n_steps = need // self.batch_size
        x = fd.images[sel].reshape(n_clients, n_steps, self.batch_size,
                                   *fd.images.shape[1:])
        y = fd.labels[sel].astype(np.int64).reshape(
            n_clients, n_steps, self.batch_size)
        return to_device(x, self.device), to_device(y, self.device)

    def train_selection(self, stacked_params: dict, fd: FederatedData,
                        sel: np.ndarray):
        """Train MANY satellites on a resolved ``(C, need)`` index table;
        returns the stacked params and the ``(C,)`` last-step losses."""
        x, y = self.gather_selection(fd, sel)
        new_params, losses = self.multi_step(stacked_params, x, y)
        return new_params, to_host(losses[:, -1])

    @staticmethod
    def stack(params_list: Sequence[dict]) -> dict:
        """Stack param dicts along a new leading replica axis."""
        return {k: torch.stack([p[k] for p in params_list])
                for k in params_list[0]}

    @staticmethod
    def unstack(stacked: dict, i: int) -> dict:
        """Replica ``i`` of a stacked param dict (views)."""
        return {k: x[i] for k, x in stacked.items()}

    def evaluate(self, params: dict, images: np.ndarray,
                 labels: np.ndarray, batch: int = 2048) -> float:
        """Chunked accuracy with ONE device->host transfer: per-chunk
        means stay on the device, come back stacked, and are averaged in
        float64 on the host weighted by chunk length (the reference's
        arithmetic). Both copies are explicit transfers, so the fused
        loops may call it under the sanitizer."""
        n = len(images)
        means, lens = [], []
        with torch.no_grad():
            for i in range(0, n, batch):
                x = to_device(images[i:i + batch], self.device)
                y = to_device(labels[i:i + batch], self.device, np.int64)
                means.append(self.model.accuracy(params, x, y))
                lens.append(len(x))
        host = to_host(torch.stack(means))               # ONE transfer
        return sum(float(m) * l for m, l in zip(host, lens)) / n
