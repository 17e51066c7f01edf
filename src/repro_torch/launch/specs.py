"""Input specs and step builders for every (arch x shape) (port of the
input-spec half of ``repro.launch.specs``).

An input spec is an empty tensor on the meta device, the torch
counterpart of ``jax.ShapeDtypeStruct``: it has the input's shape and
dtype and holds no memory. The dry run (``launch/dryrun.py``) traces the
steps below against them.

Shape semantics (``configs.SHAPES``), as in the reference:
  train_4k     -> train step   (FedHAP round: local SGD + hierarchical agg)
  prefill_32k  -> prefill step (global model forward, batch over data)
  decode_32k   -> serve step   (1 token against a seq_len KV/state cache)
  long_500k    -> serve step   (sub-quadratic path: native state/latent or
                                sliding-window, by ``long_context_mode``)

The specs are the reference's global shapes; :func:`_lead` and
:func:`_dp` say which mesh axes shard the batch, and the dry run takes
one device's shard. The builders have no shardings: ``sanitize_specs``,
the ``model`` axis's partition specs and the shardings of the steps are
ROADMAP Queue A item 19, so ``model`` replicates (each device of a
``model`` group runs the whole model on its batch shard).
"""
from __future__ import annotations

from typing import Any, Mapping

import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.core.dissemination import ConstellationMeshMap
from repro_torch.core.fed_step import FedTrainConfig, build_fed_train_step
from repro_torch.core.mesh_round import FedRoundConfig
from repro_torch.launch.mesh import make_constellation_map
from repro_torch.launch.serve import prefill as serve_prefill
from repro_torch.models.transformer import Transformer

META = torch.device("meta")


def _spec(shape: tuple, dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def _lead(multi_pod: bool) -> tuple[str, ...]:
    """The mesh axes of the satellite (and training batch) dim."""
    return ("pod", "data") if multi_pod else ("data",)


def _dp(multi_pod: bool, batch: int,
        mesh_shape: Mapping[str, int]) -> tuple[str, ...] | None:
    """Batch-dim sharding for serving, from the mesh's axis sizes
    (``{"data": 16, "model": 16}``); None when the batch cannot shard."""
    axes = _lead(multi_pod)
    n = 1
    for a in axes:
        n *= mesh_shape[a]
    if batch % n == 0:
        return axes
    if batch % mesh_shape["data"] == 0:
        return ("data",)
    return None


# ------------------------------------------------------------- inputs
def train_input_specs(cfg: ArchConfig, shape: ShapeConfig,
                      cmap: ConstellationMeshMap) -> dict:
    """Satellite-stacked training batch for one FedHAP round."""
    s = cmap.total_sats
    if shape.global_batch % s:
        raise ValueError(f"global batch {shape.global_batch} does not "
                         f"split over {s} satellites")
    lb = shape.global_batch // s
    seq = shape.seq_len
    batch: dict[str, Any] = {}
    if cfg.vision_patches:
        text = seq - cfg.vision_patches
        batch["tokens"] = _spec((s, lb, text), torch.int32)
        batch["labels"] = _spec((s, lb, text), torch.int32)
        batch["patches"] = _spec((s, lb, cfg.vision_patches, cfg.d_model),
                                 torch.bfloat16)
    else:
        batch["tokens"] = _spec((s, lb, seq), torch.int32)
        batch["labels"] = _spec((s, lb, seq), torch.int32)
    if cfg.is_encdec:
        batch["frames"] = _spec((s, lb, cfg.encoder_seq, cfg.d_model),
                                torch.bfloat16)
    return {"batch": batch,
            "sizes": _spec((s,), torch.float32),
            "visible": _spec((s,), torch.bool)}


def prefill_input_specs(cfg: ArchConfig, shape: ShapeConfig) -> dict:
    b, seq = shape.global_batch, shape.seq_len
    out: dict[str, Any] = {}
    if cfg.vision_patches:
        out["tokens"] = _spec((b, seq - cfg.vision_patches), torch.int32)
        out["patches"] = _spec((b, cfg.vision_patches, cfg.d_model),
                               torch.bfloat16)
    else:
        out["tokens"] = _spec((b, seq), torch.int32)
    if cfg.is_encdec:
        out["frames"] = _spec((b, cfg.encoder_seq, cfg.d_model),
                              torch.bfloat16)
    return out


def decode_input_specs(cfg: ArchConfig, shape: ShapeConfig,
                       model: Transformer, use_window: bool,
                       batch: int | None = None) -> dict:
    """The token and the decode cache (``Transformer.init_cache`` on the
    meta device) for ``batch`` sequences (default: the shape's global
    batch) against a cache of the shape's length."""
    b = shape.global_batch if batch is None else batch
    return {"token": _spec((b,), torch.int32),
            "cache": model.init_cache(b, shape.seq_len,
                                      use_window=use_window, device=META)}


def use_window_for(cfg: ArchConfig, shape: ShapeConfig) -> bool:
    """long_500k decodes through SWA for archs without a native
    sub-quadratic path (``long_context_mode == "swa"``)."""
    return shape.name == "long_500k" and cfg.long_context_mode == "swa"


# ------------------------------------------------------------ builders
def make_train_step(model: Transformer, mesh: Any,
                    round_kind: str = "fedhap",
                    partial_mode: str = "paper",
                    hap_ring: bool = True,
                    ship_global_echo: bool = True,
                    local_steps: int = 1):
    """``(step, cmap)``: :func:`repro_torch.core.fed_step
    .build_fed_train_step` on ``mesh`` (a ``DeviceMesh`` over ``("data",
    "model")`` or ``("pod", "data", "model")``), ``model`` replicating,
    and the production constellation map of that mesh."""
    multi_pod = "pod" in mesh.mesh_dim_names
    cmap = make_constellation_map(multi_pod=multi_pod)
    fed_cfg = FedTrainConfig(
        round_cfg=FedRoundConfig(cmap=cmap, partial_mode=partial_mode,
                                 hap_ring=hap_ring,
                                 ship_global_echo=ship_global_echo),
        round_kind=round_kind, local_steps=local_steps)
    return build_fed_train_step(model, fed_cfg, mesh), cmap


def make_prefill_step(model: Transformer):
    """``prefill(params, inputs)``: the last position's logits (B, V), as
    ``launch/serve.py::prefill`` computes them (only that position is
    unembedded: what serving needs)."""

    def prefill(params: dict, inputs: Mapping[str, torch.Tensor]
                ) -> torch.Tensor:
        aux = {k: v for k, v in inputs.items()
               if k in ("frames", "patches")}
        return serve_prefill(model, params, inputs["tokens"], aux or None)

    return prefill


def make_serve_step(model: Transformer, use_window: bool):
    """``serve(params, cache, token) -> (next_token, cache)``: one
    ``decode_step`` (the cache updated in place) and the greedy argmax."""

    @torch.no_grad()
    def serve(params: dict, cache: dict, token: torch.Tensor):
        logits, cache = model.decode_step(params, cache, token,
                                          use_window=use_window)
        return torch.argmax(logits, dim=-1).to(torch.int32), cache

    return serve
