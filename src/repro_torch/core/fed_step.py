"""Composition: per-satellite local SGD + FedHAP aggregation (port of
``repro.core.fed_step``).

Satellites (a leading ``S`` axis on every param leaf) each run I local
mini-batch SGD steps on their own shard of the batch; then one FedHAP
round synchronises the replicas. The reference's
``build_fed_train_step`` runs that round as mesh collectives, which wait
on ROADMAP Queue A item 12; on one device
``repro_torch.launch.train.single_device_round`` is the step.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import torch

from repro_torch.core.mesh_round import FedRoundConfig
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


def build_fed_train_step(model: Transformer, fed_cfg: FedTrainConfig,
                         mesh: Any, model_specs: Any = None):
    """Raises: the step's round is a mesh collective (ROADMAP Queue A
    item 12)."""
    raise NotImplementedError(
        "build_fed_train_step: the mesh rounds are not ported yet (ROADMAP "
        "Queue A item 12); on one device use "
        "repro_torch.launch.train.single_device_round")


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
