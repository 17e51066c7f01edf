"""Fused on-device execution for the timeline simulator (port of
``repro.sim.executor``: ``run_block`` for the round family,
``cycle_block`` for the routed cycle family, and their helpers).

Strategies plan K rounds (or cycle events) in pure numpy;
:meth:`FusedExecutor.run_block` executes K rounds with the model, the
dataset and the eval set resident on the device:

- the plan tensors (sample indices ``(K, S, need)`` and weights
  ``mu (K, S)``) are uploaded once per block;
- each round gathers its mini-batches on the device, runs the
  replica-stacked local SGD of every satellite from the broadcast global
  model, folds the replicas with the planned weights
  (:func:`repro_torch.kernels.ops.fold_stacked_tree` — the ``fedagg``
  CUDA kernel on the card, the plain fold on CPU) and, when due,
  evaluates accuracy in fixed chunks on the device;
- accuracies stay device scalars and come back as ONE stacked transfer
  per block. Nothing in the loop reads a device value on the host, and
  every copy between host and device goes through :meth:`FusedExecutor
  ._h2d` / :meth:`~FusedExecutor._d2h` (explicit transfers: the
  sanitizer, :mod:`repro_torch.debug.sanitize`, refuses any other).

The per-round ``valid`` and ``do_eval`` flags are host numpy, so the
reference's ``lax.cond``s are host ``if``s: an invalid round (padding or
an all-lost fault round) carries params through unchanged.

:meth:`FusedExecutor.cycle_block` executes K planned cycle events the
same way, carrying the global model, the per-orbit cycle bases and the
staleness buffer on the device: each valid event trains one orbit's
members from its base, folds them with the planned chain weights
(``fold_stacked_tree``: one ``fedagg`` launch per event on the card),
writes the orbit model to its buffer slot and, on a flush, applies
``keep·g + Σ_b rhos[b]·buf[b]`` (a plain einsum, as in the reference).
The event's orbit, slot and flags are host numpy from the plan, so the
loop branches on them with no device sync.

The tick baselines run one program per tick: :meth:`FusedExecutor
.fedsat_event` trains every member of the visited orbits from its
orbit's base and folds the orbits one after another (one
``fold_stacked_tree`` call each: one ``fedagg`` launch per orbit on the
card); :meth:`~FusedExecutor.fedspace_train` trains the fresh passes
from their bases and returns the deltas, and
:meth:`~FusedExecutor.fedspace_flush` folds the buffered deltas into the
global (one launch per flush). The reference pads V, N and B up to a
power of two only to bound jit's cache of programs; eager PyTorch has
no such cache, so these run at the true counts. The reference's pads
carry rho = 0 and zero weights, and (1 - 0)·g + 0·o = g for finite o,
so dropping them does not change the result (the tests hold the port
against the padded reference).

**Over several ranks** (``mesh=``, a ``DeviceMesh`` with a ``data``
axis: :func:`repro_torch.launch.mesh.make_sim_mesh` /
``make_debug_mesh``), ``run_block`` and ``cycle_block`` shard the
satellite (cycle-member) axis: every rank plans the same block in
numpy, uploads only its own ``S/D`` rows of the index and weight
tensors, trains them, folds them with the kernel, and the partial folds
meet in ONE all-reduce (:func:`repro_torch.core.mesh_round
.sharded_fold`, the mesh round's own tail: launch/ and sim/ share it).
The global model, the bases, the buffer and the eval set stay
replicated, so eval runs on every rank on the all-reduced global and the
block keeps its one transfer to the host. Satellite counts that do not
divide the rank count are padded with dead satellites (index rows 0,
weight 0.0), which add exactly zero. A 1-rank mesh is bit-equal to the
unsharded program; over D ranks the sum order of the all-reduce differs
from one fold by a few f32 ulps. The tick baselines (``fedsat_event``,
``fedspace_train``, ``fedspace_flush``) keep the single-device path on
every rank, as in the reference.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.core.mesh_round import sharded_fold
from repro_torch.core.treeops import tree_broadcast, tree_row
from repro_torch.debug.sanitize import to_device, to_host
from repro_torch.kernels.ops import fold_stacked_tree


def tree_combine_many(stacked: dict, weight_rows: Any) -> dict:
    """K weighted folds of one stacked tree: ``weight_rows`` is ``(K, S)``;
    returns a tree of ``(K, ...)`` leaves with row k equal to the fold of
    ``stacked`` with ``weight_rows[k]`` (one einsum per leaf, as the
    reference computes it outside the kernel)."""
    out = {}
    for k, x in stacked.items():
        w = torch.as_tensor(weight_rows, dtype=torch.float32,
                            device=x.device)
        out[k] = torch.einsum("ks,s...->k...", w, x)
    return out


class FusedExecutor:
    """Device-resident data + the block program for one engine.

    Precision and determinism: when built on CUDA it sets
    ``torch.backends.cudnn.allow_tf32 = False`` and
    ``torch.backends.cuda.matmul.allow_tf32 = False`` (process-wide), so
    convolutions and matmuls run in full f32 like the reference (cuDNN
    would otherwise run the f32 convolutions in TF32), and
    ``torch.backends.cudnn.deterministic = True`` (``benchmark`` stays
    False), so two runs of one config agree bit for bit and a resumed run
    equals an uninterrupted one, as the reference promises; cuDNN's
    default algorithms for the replica-grouped convolutions differ from
    run to run.
    """

    def __init__(self, trainer: Any, fd: Any, eval_images: np.ndarray,
                 eval_labels: np.ndarray, *, eval_chunk: int = 1024,
                 mesh: Any = None):
        self.trainer = trainer
        self.device = trainer.device
        self.mesh = mesh
        self.n_shards, self.shard = 1, 0
        if mesh is not None:
            names = tuple(mesh.mesh_dim_names or ())
            if "data" not in names:
                raise ValueError(
                    f"executor mesh needs a 'data' axis to shard the "
                    f"satellite dim over; got axes {names}")
            self.n_shards = int(mesh.shape[names.index("data")])
            self.shard = mesh.get_local_rank("data")
        if self.device.type == "cuda":
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.deterministic = True
        self._x = self._h2d(fd.images, None)
        self._y = self._h2d(fd.labels, np.int64)

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
        self._ex = self._h2d(ex.reshape(-1, c, *ex.shape[1:]), None)
        self._ey = self._h2d(ey.reshape(-1, c), None)

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

    def _train(self, rows: dict, idx: torch.Tensor) -> dict:
        """Device gather of the sampled mini-batches ``idx`` ``(n, need)``
        + one replica-stacked SGD burst of the ``n`` replicas ``rows``
        (a stacked tree; broadcast views are fine)."""
        n, need = idx.shape
        bs = self.trainer.batch_size
        n_steps = need // bs
        x = self._x[idx].reshape(n, n_steps, bs, *self._x.shape[1:])
        y = self._y[idx].reshape(n, n_steps, bs)
        trained, _ = self.trainer.multi_step(rows, x, y)
        return trained

    def broadcast_rows(self, params: dict, n: int) -> dict:
        """Materialized ``(n, ...)`` stacked copies of ``params`` on the
        device (per-orbit base-model tables)."""
        return {k: x.unsqueeze(0).repeat(n, *([1] * x.dim()))
                for k, x in params.items()}

    def zero_rows(self, params: dict, n: int) -> dict:
        """``(n, ...)`` zero-filled stacked tree matching ``params``."""
        return {k: x.new_zeros((n,) + tuple(x.shape))
                for k, x in params.items()}

    def _h2d(self, x: Any, dtype: Any) -> torch.Tensor:
        """Explicit upload of host data, cast in numpy first (``dtype``
        None keeps the array's)."""
        return to_device(x, self.device, dtype)

    @staticmethod
    def _d2h(x: torch.Tensor) -> np.ndarray:
        """Explicit download of a block's results."""
        return to_host(x)

    def run_block(self, params: dict, idx: np.ndarray, mu: np.ndarray,
                  do_eval: np.ndarray, valid: np.ndarray):
        """Execute K planned rounds.

        ``idx``: (K, S, n_steps*bs) sampled dataset indices; ``mu``:
        (K, S) planned global weights; ``do_eval``/``valid``: (K,) host
        flags. Returns ``(params, accs)`` — the device-resident global
        after the last valid round and a (K,) host array of accuracies
        (NaN where not evaluated): ONE transfer per block. With a mesh,
        this rank trains and folds only its own rows of ``idx`` / ``mu``
        (:meth:`_my_rows`), and the fold is :meth:`_fold`'s all-reduce.
        """
        if self.mesh is not None:
            shard = self._my_rows({"idx": idx, "mu": mu}, ("idx", "mu"))
            idx, mu = shard["idx"], shard["mu"]
        K, S, _ = idx.shape
        idx_d = self._h2d(idx, np.int64)
        mu_d = self._h2d(mu, np.float32)
        nan = torch.full((), float("nan"), dtype=torch.float32,
                         device=self.device)
        accs = []
        for k in range(K):
            if valid[k]:
                trained = self._train(tree_broadcast(params, S), idx_d[k])
                params = self._fold(trained, mu_d[k])
            accs.append(self._device_acc(params)
                        if do_eval[k] and valid[k] else nan)
        return params, self._d2h(torch.stack(accs))

    def _fold(self, stacked: dict, weights: torch.Tensor) -> dict:
        """The fold of a block: :func:`fold_stacked_tree` alone, or with a
        mesh this rank's rows through :func:`sharded_fold` (the kernel,
        then one all-reduce over ``data``)."""
        if self.mesh is None:
            return fold_stacked_tree(stacked, weights)
        return sharded_fold(stacked, weights, self.mesh, ("data",))

    @staticmethod
    def _pad_sat_axis(arrs: dict, names: Any, axis: int,
                      multiple: int) -> dict:
        """Pad each named array's satellite ``axis`` up to a multiple of
        the shard count with dead satellites: index arrays get row-0
        indices (finite training input), weight arrays 0.0 (their fold
        adds exactly zero: ``kernels.ops.pad_stacked_rows`` states the
        same contract on the device)."""
        out = dict(arrs)
        for name in names:
            a = np.asarray(out[name])
            pad = (-a.shape[axis]) % multiple
            if pad:
                width = [(0, 0)] * a.ndim
                width[axis] = (0, pad)
                a = np.pad(a, width)        # zero rows / zero weights
            out[name] = a
        return out

    def _my_rows(self, arrs: dict, names: Any) -> dict:
        """``arrs`` with each named array cut to this rank's contiguous
        shard of its axis 1 (padded first, see :meth:`_pad_sat_axis`)."""
        out = self._pad_sat_axis(arrs, names, 1, self.n_shards)
        for name in names:
            n = out[name].shape[1] // self.n_shards
            out[name] = out[name][:, self.shard * n:(self.shard + 1) * n]
        return out

    def fold_block(self, stacked: dict, weight_rows: np.ndarray) -> dict:
        """K planned folds of a fixed stacked tree (see
        :func:`tree_combine_many`)."""
        return tree_combine_many(stacked,
                                 self._h2d(weight_rows, np.float32))

    # ------------------------------------------------- routed event family
    @staticmethod
    def _absorb(g: dict, buf: dict, orbit_model: dict, slot: int,
                flush: bool, keep: float, rhos: torch.Tensor) -> dict:
        """One event's buffer write (in place) and, on a flush, the
        planned fold ``keep·g + Σ_b rhos[b]·buf[b]``; returns the
        global."""
        for k, x in buf.items():
            x[slot] = orbit_model[k]
        if not flush:
            return g
        return {k: keep * x + torch.einsum("s,s...->...", rhos, buf[k])
                for k, x in g.items()}

    def cycle_block(self, params: dict, bases: dict, buf: dict, ev: dict,
                    sat_axes: tuple = ("idx", "lam")):
        """Execute K planned cycle events.

        Carries ``(global, per-orbit cycle bases, staleness buffer)``:
        each valid event trains orbit ``l``'s members from the base the
        cycle launched against, folds them with the planned Eq.-14 chain
        weights (one ``fold_stacked_tree`` call: one ``fedagg`` launch on
        the card), writes the orbit model into its buffer slot, on flush
        events applies the planned staleness-discounted fold ``keep*g +
        rhos @ buffer``, and sets the orbit's base to the global. Event
        tensors (host numpy, leading dim K): ``l`` int, ``idx`` (K, k,
        need), ``lam`` (K, k), ``rhos`` (K, B), ``keep``, ``slot`` int,
        ``flush``, ``do_eval``, ``valid``. ``bases`` and ``buf`` are
        updated in place (the reference donates them). Returns
        ``(params, bases, buf, accs)`` with the (K,) accuracies (NaN
        where not evaluated) in ONE transfer.

        With a mesh, ``sat_axes`` names the event tensors whose axis 1 is
        the member dim: each rank trains and folds its shard of the
        members (:meth:`_fold`), and the buffer writes and flushes run
        replicated on the all-reduced orbit model.
        """
        if self.mesh is not None:
            ev = self._my_rows(ev, sat_axes)
        K, k, _ = ev["idx"].shape
        idx = self._h2d(ev["idx"], np.int64)
        lam = self._h2d(ev["lam"], np.float32)
        rhos = self._h2d(ev["rhos"], np.float32)
        keep = np.asarray(ev["keep"], np.float32)
        nan = torch.full((), float("nan"), dtype=torch.float32,
                         device=self.device)
        g, accs = params, []
        for i in range(K):
            if ev["valid"][i]:
                l = int(ev["l"][i])
                trained = self._train(tree_broadcast(tree_row(bases, l), k),
                                      idx[i])
                g = self._absorb(g, buf, self._fold(trained, lam[i]),
                                 int(ev["slot"][i]), bool(ev["flush"][i]),
                                 float(keep[i]), rhos[i])
                for name, x in bases.items():
                    x[l] = g[name]
            accs.append(self._device_acc(g)
                        if ev["do_eval"][i] and ev["valid"][i] else nan)
        return g, bases, buf, self._d2h(torch.stack(accs))

    def cycle_fold_block(self, params: dict, buf: dict, stacked_k: dict,
                         ev: dict):
        """:meth:`cycle_block`'s fold, buffer and flush arithmetic with the
        orbit model folded from a FIXED stacked member tree instead of
        freshly trained replicas (local SGD excluded). ``params`` and
        ``buf`` are not written (the reference does not donate them here).
        Returns ``(params, buf)``; no eval."""
        lam = self._h2d(ev["lam"], np.float32)
        rhos = self._h2d(ev["rhos"], np.float32)
        keep = np.asarray(ev["keep"], np.float32)
        g, buf = params, {k: x.clone() for k, x in buf.items()}
        for i in range(len(ev["l"])):
            if ev["valid"][i]:
                g = self._absorb(g, buf, fold_stacked_tree(stacked_k, lam[i]),
                                 int(ev["slot"][i]), bool(ev["flush"][i]),
                                 float(keep[i]), rhos[i])
        return g, buf

    # ------------------------------------------------ tick baselines
    def fedsat_event(self, params: dict, bases: dict, visited: np.ndarray,
                     idx: np.ndarray, lam_rows: np.ndarray,
                     rhos: np.ndarray):
        """One fedsat tick: train every member of the ``V`` visited orbits
        from its orbit's base in one replica-stacked burst, then the
        method's sequential per-orbit async folds: orbit ``j``'s members
        (rows ``j*k .. (j+1)*k`` of the burst, a contiguous slice) fold
        with ``lam_rows[j]`` (one ``fold_stacked_tree`` call), the global
        becomes ``(1 - rhos[j])·g + rhos[j]·orbit_model``, and orbit
        ``visited[j]``'s base is set to it. ``bases`` is written in place
        (the reference donates it). Returns ``(params, bases)``."""
        V, k = lam_rows.shape
        vis = self._h2d(visited, np.int64)
        rows = {n: b[vis].repeat_interleave(k, dim=0)
                for n, b in bases.items()}
        trained = self._train(rows, self._h2d(idx, np.int64))
        lam = self._h2d(lam_rows, np.float32)
        g = params
        for j in range(V):
            members = {n: x[j * k:(j + 1) * k] for n, x in trained.items()}
            orbit_model = fold_stacked_tree(members, lam[j])
            # rho and 1 - rho in f32, as the reference computes them
            rho = np.float32(rhos[j])
            keep = float(np.float32(1.0) - rho)
            g = {n: keep * x + float(rho) * orbit_model[n]
                 for n, x in g.items()}
            for n, b in bases.items():
                b[int(visited[j])] = g[n]
        return g, bases

    def fedspace_train(self, params: dict, bases: dict, sats: np.ndarray,
                       idx: np.ndarray):
        """One fedspace pass burst: train ``sats`` from their
        per-satellite bases, return the stacked deltas (trained minus
        base), and reset those base rows to the current global.
        ``bases`` is written in place (the reference donates it).
        Returns ``(deltas, bases)``."""
        rows_idx = self._h2d(sats, np.int64)
        rows = {n: b[rows_idx] for n, b in bases.items()}
        trained = self._train(rows, self._h2d(idx, np.int64))
        deltas = {n: x - rows[n] for n, x in trained.items()}
        for n, b in bases.items():
            b[rows_idx] = params[n]
        return deltas, bases

    def fedspace_flush(self, params: dict, stacked_deltas: dict,
                       wts: np.ndarray) -> dict:
        """Buffered flush: ``params + Σ_j wts[j]·delta_j``, the fold one
        ``fold_stacked_tree`` call (one ``fedagg`` launch on the card)."""
        upd = fold_stacked_tree(stacked_deltas,
                                self._h2d(wts, np.float32))
        return {n: x + upd[n] for n, x in params.items()}
