"""Composition: per-satellite local SGD + FedHAP aggregation (port of
``repro.core.fed_step``).

Satellites (a leading ``S`` axis on every param leaf) each run I local
mini-batch SGD steps on their own shard of the batch; then one FedHAP
round synchronises the replicas. :func:`build_fed_train_step` runs that
round as collectives over ``torch.distributed``, one rank per satellite
(:func:`repro_torch.core.mesh_round.build_round`);
``repro_torch.launch.train.single_device_round`` is the step of one
device that time-multiplexes the satellites. Both run the same
:func:`local_sgd`.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import torch

from repro_torch.core.mesh_round import FedRoundConfig, build_round, psum
from repro_torch.models.transformer import Transformer, cross_entropy_loss


@dataclasses.dataclass(frozen=True)
class FedTrainConfig:
    round_cfg: FedRoundConfig = FedRoundConfig()
    round_kind: str = "fedhap"       # fedhap | fedhap_fused | fedavg
    local_steps: int = 1             # I in Eq. 3
    learning_rate: float = 0.01      # paper's zeta


def satellite_loss(model: Transformer, params: Mapping[str, torch.Tensor],
                   batch: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """Loss of ONE satellite's replica on its local mini-batch."""
    aux_in = {}
    if "frames" in batch:
        aux_in["frames"] = batch["frames"]
    if "patches" in batch:
        aux_in["patches"] = batch["patches"]
    logits, aux = model.forward(params, batch["tokens"], aux_in or None)
    labels = batch["labels"]
    if model.cfg.vision_patches:
        logits = logits[:, -labels.shape[1]:]
    return cross_entropy_loss(logits, labels) + aux


def local_sgd(model: Transformer, params_S: dict,
              batch: Mapping[str, torch.Tensor], learning_rate: float,
              local_steps: int) -> torch.Tensor:
    """``local_steps`` SGD steps of every satellite of ``params_S``
    (leaves ``(S, ...)``, updated in place) on its own rows of ``batch``
    (leaves ``(S, batch, seq)``). For each step and each satellite s: a
    forward and backward of :func:`satellite_loss` on detached leaves
    ``params_S[k][s]``, then the reference's update ``p - lr *
    g.astype(p.dtype)`` with its two roundings (the product, then the
    difference), written into row s. A Python loop over satellites stands
    in for ``jax.vmap``: the attention kernels are ctypes launches with no
    batching rule. Returns the last step's mean loss over the S rows, a
    device scalar (nothing is read back)."""
    keys = list(params_S)
    n_sats = params_S[keys[0]].shape[0]
    loss = None
    for _ in range(local_steps):
        losses = []
        for s in range(n_sats):
            p = {k: params_S[k][s].detach().requires_grad_() for k in keys}
            sat_loss = satellite_loss(model, p,
                                      {k: v[s] for k, v in batch.items()})
            grads = torch.autograd.grad(sat_loss, [p[k] for k in keys])
            with torch.no_grad():
                for k, g in zip(keys, grads):
                    leaf = params_S[k][s]
                    leaf.copy_(leaf - learning_rate * g.to(leaf.dtype))
            losses.append(sat_loss.detach())
        loss = torch.stack(losses).mean()
    return loss


def build_fed_train_step(model: Transformer, fed_cfg: FedTrainConfig,
                         mesh: Any, model_specs: Any = None):
    """Returns ``step(params_local, batch_local, sizes_local,
    visible_local) -> (params_local, metrics)``, run by every rank of
    ``mesh`` (a ``DeviceMesh`` holding one rank per satellite on its
    ``data`` (and ``pod``) axes; a ``model`` axis replicates).

    ``params_local`` leaves are ``(1, ...)``: this rank's satellite
    replica, trained in place by :func:`local_sgd` (the paper's plain
    SGD) on ``batch_local`` (leaves ``(1, batch, seq)``); the step returns
    the round's new leaves (``fed_cfg.round_kind``, ``build_round``),
    which the next step trains in place in turn. ``sizes_local``
    and ``visible_local`` are the satellite's ``(1,)`` entries on the
    params' device. ``metrics`` are the reference's: ``local_loss`` (the
    last local step's mean over all satellites, one all-reduce) and the
    round's ``gate``, ``covered`` and ``upload_mass``, all 0-d device
    tensors. ``model_specs`` other than None (tensor parallelism over
    ``model``) raises: ROADMAP Queue A item 19."""
    round_fn = build_round(mesh, fed_cfg.round_cfg, model.defs(),
                           model_specs=model_specs,
                           kind=fed_cfg.round_kind)
    axes = (("pod", "data") if "pod" in mesh.mesh_dim_names
            else ("data",))
    n_sats = fed_cfg.round_cfg.cmap.total_sats

    def step(params_local: dict, batch_local: Mapping[str, torch.Tensor],
             sizes_local: torch.Tensor, visible_local: torch.Tensor):
        loss = local_sgd(model, params_local, batch_local,
                         fed_cfg.learning_rate, fed_cfg.local_steps)
        new, stats = round_fn(params_local, sizes_local, visible_local)
        with torch.no_grad():
            mean = psum(loss.to(torch.float32), mesh, axes) / n_sats
        return new, {"local_loss": mean, **stats}

    return step


def stack_params(params: Mapping[str, torch.Tensor],
                 n_sats: int) -> dict:
    """Replicate a single model into the satellite-stacked layout: real
    copies (the reference broadcasts; the port's trainer updates rows in
    place, so rows must not share storage)."""
    return {k: x.detach()[None].expand(n_sats, *x.shape).contiguous()
            for k, x in params.items()}


def unstack_params(params_S: Mapping[str, torch.Tensor],
                   index: int = 0) -> dict:
    return {k: x[index] for k, x in params_S.items()}
