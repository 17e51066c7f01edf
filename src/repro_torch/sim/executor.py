"""Fused on-device execution for the timeline simulator (port of
``repro.sim.executor.FusedExecutor.run_block``).

Strategies plan K rounds in pure numpy; :meth:`FusedExecutor.run_block`
executes them with the model, the dataset and the eval set resident on
the device:

- the plan tensors (sample indices ``(K, S, need)`` and weights
  ``mu (K, S)``) are uploaded once per block;
- each round gathers its mini-batches on the device, runs the
  replica-stacked local SGD of every satellite from the broadcast global
  model, folds the replicas with the planned weights
  (:func:`repro_torch.kernels.ops.fold_stacked_tree` — the ``fedagg``
  CUDA kernel on the card, the plain fold on CPU) and, when due,
  evaluates accuracy in fixed chunks on the device;
- accuracies stay device scalars and come back as ONE stacked transfer
  per block. Nothing in the loop reads a device value on the host.

The per-round ``valid`` and ``do_eval`` flags are host numpy, so the
reference's ``lax.cond``s are host ``if``s: an invalid round (padding or
an all-lost fault round) carries params through unchanged.

Not ported yet: the satellite-sharded mesh path, the cycle and tick
programs (ROADMAP Queue A items 7, 8 and 12).
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.core.treeops import tree_broadcast
from repro_torch.kernels.ops import fold_stacked_tree


class FusedExecutor:
    """Device-resident data + the block program for one engine.

    Precision: when built on CUDA it sets
    ``torch.backends.cudnn.allow_tf32 = False`` and
    ``torch.backends.cuda.matmul.allow_tf32 = False`` (process-wide), so
    convolutions and matmuls run in full f32 like the reference; cuDNN
    would otherwise run the f32 convolutions in TF32.
    """

    def __init__(self, trainer: Any, fd: Any, eval_images: np.ndarray,
                 eval_labels: np.ndarray, *, eval_chunk: int = 1024):
        self.trainer = trainer
        self.device = trainer.device
        if self.device.type == "cuda":
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        self._x = torch.from_numpy(np.asarray(fd.images)).to(self.device)
        self._y = torch.from_numpy(
            np.asarray(fd.labels, np.int64)).to(self.device)

        # Eval set, padded to whole chunks; pad labels are -1 so they
        # never match an argmax in [0, num_classes).
        n = len(eval_images)
        self._eval_n = n
        c = max(1, min(eval_chunk, n)) if n else 1
        pad = (-n) % c
        ex = np.asarray(eval_images)
        ey = np.asarray(eval_labels, np.int64)
        if pad:
            ex = np.concatenate(
                [ex, np.zeros((pad,) + ex.shape[1:], ex.dtype)])
            ey = np.concatenate([ey, np.full(pad, -1, ey.dtype)])
        self._ex = torch.from_numpy(
            ex.reshape(-1, c, *ex.shape[1:])).to(self.device)
        self._ey = torch.from_numpy(ey.reshape(-1, c)).to(self.device)

    def _device_acc(self, params: dict) -> torch.Tensor:
        """Fraction of the eval set classified correctly, as a device f32
        scalar (no host transfer)."""
        if self._eval_n == 0:
            return torch.zeros((), dtype=torch.float32, device=self.device)
        model = self.trainer.model
        correct = torch.zeros((), dtype=torch.float32, device=self.device)
        with torch.no_grad():
            for x, y in zip(self._ex, self._ey):
                pred = torch.argmax(model.forward(params, x), dim=-1)
                correct = correct + (pred == y).float().sum()
        return correct / self._eval_n

    def _train(self, base: dict, idx: torch.Tensor, n_rep: int,
               n_steps: int) -> dict:
        """Device gather of the sampled mini-batches + one replica-stacked
        SGD burst of ``n_rep`` replicas broadcast from ``base``."""
        bs = self.trainer.batch_size
        x = self._x[idx].reshape(n_rep, n_steps, bs, *self._x.shape[1:])
        y = self._y[idx].reshape(n_rep, n_steps, bs)
        trained, _ = self.trainer.multi_step(tree_broadcast(base, n_rep),
                                             x, y)
        return trained

    def run_block(self, params: dict, idx: np.ndarray, mu: np.ndarray,
                  do_eval: np.ndarray, valid: np.ndarray):
        """Execute K planned rounds.

        ``idx``: (K, S, n_steps*bs) sampled dataset indices; ``mu``:
        (K, S) planned global weights; ``do_eval``/``valid``: (K,) host
        flags. Returns ``(params, accs)`` — the device-resident global
        after the last valid round and a (K,) host array of accuracies
        (NaN where not evaluated): ONE transfer per block.
        """
        K, S, need = idx.shape
        n_steps = need // self.trainer.batch_size
        idx_d = torch.from_numpy(np.asarray(idx, np.int64)).to(self.device)
        mu_d = torch.from_numpy(np.asarray(mu, np.float32)).to(self.device)
        nan = torch.full((), float("nan"), dtype=torch.float32,
                         device=self.device)
        accs = []
        for k in range(K):
            if valid[k]:
                trained = self._train(params, idx_d[k], S, n_steps)
                params = fold_stacked_tree(trained, mu_d[k])
            accs.append(self._device_acc(params)
                        if do_eval[k] and valid[k] else nan)
        return params, torch.stack(accs).cpu().numpy()
