"""Input specs, partition specs and step builders for every (arch x
shape) (port of ``repro.launch.specs``).

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
one device's shard. The mesh half: :func:`sanitize_specs` (the
reference's rule: a dim sharded over ``model`` that the axis does not
divide moves its ``model`` to the first divisible unsharded dim, else
drops it), :func:`model_specs` (the model's sanitized trailing specs,
which shard the params over ``model``: ``models/sharding.py``), and the
placements of each step's tensors as tuples of axis names, the port's
``PartitionSpec``: :func:`make_train_step`'s params and inputs,
:func:`prefill_shardings` and :func:`serve_shardings` (params, batch,
cache and token). A step built on a mesh runs on this rank's shards.
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
from repro_torch.models.sharding import mesh_sizes, sanitize_specs
from repro_torch.models.transformer import Transformer

META = torch.device("meta")


def _spec(shape: tuple, dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def _lead(multi_pod: bool) -> tuple[str, ...]:
    """The mesh axes of the satellite (and training batch) dim."""
    return ("pod", "data") if multi_pod else ("data",)


def model_specs(model: Transformer, mesh: Any) -> dict:
    """The model's trailing partition specs sanitized for ``mesh``: how
    the params shard over ``model`` (``sharding.shard_params``)."""
    return sanitize_specs(model.defs(), model.specs(), mesh)


def _entry(axes: tuple[str, ...] | None):
    """A spec entry of ``axes``: one axis as its name (as
    ``PartitionSpec`` writes it), several as a tuple, none as None."""
    return axes[0] if axes and len(axes) == 1 else axes


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
                       batch: int | None = None, axis=None) -> dict:
    """The token and the decode cache (``Transformer.init_cache`` on the
    meta device) for ``batch`` sequences (default: the shape's global
    batch) against a cache of the shape's length; with ``axis``, one
    rank's cache over ``model``."""
    b = shape.global_batch if batch is None else batch
    return {"token": _spec((b,), torch.int32),
            "cache": model.init_cache(b, shape.seq_len,
                                      use_window=use_window, device=META,
                                      axis=axis)}


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
    """``(step, param_specs, shardings_for, cmap)``, as the reference's:
    :func:`repro_torch.core.fed_step.build_fed_train_step` on ``mesh`` (a
    ``DeviceMesh`` over ``("data", "model")`` or ``("pod", "data",
    "model")``) with the sanitized trailing specs (:func:`model_specs`),
    each satellite-stacked leaf's placement (the satellite dim over the
    lead axes, the trailing dims as sanitized), ``shardings_for(specs)``
    placing :func:`train_input_specs`' tensors, and the production
    constellation map of that mesh. The step runs on this rank's
    shards."""
    multi_pod = "pod" in mesh.mesh_dim_names
    cmap = make_constellation_map(multi_pod=multi_pod)
    fed_cfg = FedTrainConfig(
        round_cfg=FedRoundConfig(cmap=cmap, partial_mode=partial_mode,
                                 hap_ring=hap_ring,
                                 ship_global_echo=ship_global_echo),
        round_kind=round_kind, local_steps=local_steps)
    trailing = model_specs(model, mesh)
    step = build_fed_train_step(model, fed_cfg, mesh, model_specs=trailing)
    lead = _entry(_lead(multi_pod))
    param_specs = {k: (lead, *s) for k, s in trailing.items()}

    def shardings_for(specs: Mapping[str, Any]) -> dict:
        return {"batch": {k: (lead,) + (None,) * (len(x.shape) - 1)
                          for k, x in specs["batch"].items()},
                "sizes": (lead,), "visible": (lead,)}

    return step, param_specs, shardings_for, cmap


def prefill_shardings(model: Transformer, mesh: Any):
    """``(param_specs, shardings_for(specs, batch))``: the params'
    sanitized placement and that of :func:`prefill_input_specs`' tensors
    (the batch dim over :func:`_dp`'s axes)."""
    sizes = mesh_sizes(mesh)
    multi_pod = "pod" in sizes

    def shardings_for(specs: Mapping[str, Any], batch: int) -> dict:
        dp = _entry(_dp(multi_pod, batch, sizes))
        return {k: (dp,) + (None,) * (len(x.shape) - 1)
                for k, x in specs.items()}

    return model_specs(model, mesh), shardings_for


def serve_shardings(model: Transformer, mesh: Any, use_window: bool,
                    long_ctx: bool):
    """``(param_specs, cache_shardings(batch, cache_example),
    token_sharding(batch))``, the reference's placements: the cache's
    specs (:meth:`Transformer.cache_specs`) with their ``data`` batch dim
    replaced by :func:`_dp`'s axes, sanitized against the cache."""
    sizes = mesh_sizes(mesh)
    multi_pod = "pod" in sizes

    def cache_shardings(batch: int, cache_example: Mapping[str, Any]
                        ) -> dict:
        dp = _entry(_dp(multi_pod, batch, sizes))
        specs = {}
        for k, spec in model.cache_specs(use_window=use_window,
                                         long_ctx=long_ctx).items():
            parts = list(spec)
            # parts[0] is the stacked layer dim, parts[1] the batch where
            # the layout batch-shards.
            if len(parts) > 1 and parts[1] == "data":
                parts[1] = dp
            specs[k] = tuple(parts)
        return sanitize_specs(cache_example, specs, sizes)

    def token_sharding(batch: int) -> tuple:
        return (_entry(_dp(multi_pod, batch, sizes)),)

    return model_specs(model, mesh), cache_shardings, token_sharding


def _axis(model: Transformer, mesh: Any):
    return (None if mesh is None
            else model.model_axis(mesh, model_specs(model, mesh)))


def make_prefill_step(model: Transformer, mesh: Any = None):
    """``prefill(params, inputs)``: the last position's logits (B, V), as
    ``launch/serve.py::prefill`` computes them (only that position is
    unembedded: what serving needs). On ``mesh`` (a ``DeviceMesh``) the
    params are this rank's shards (:func:`prefill_shardings`)."""
    axis = _axis(model, mesh)

    def prefill(params: dict, inputs: Mapping[str, torch.Tensor]
                ) -> torch.Tensor:
        aux = {k: v for k, v in inputs.items()
               if k in ("frames", "patches")}
        return serve_prefill(model, params, inputs["tokens"], aux or None,
                             axis)

    prefill.axis = axis
    return prefill


def make_serve_step(model: Transformer, use_window: bool, mesh: Any = None):
    """``serve(params, cache, token) -> (next_token, cache)``: one
    ``decode_step`` (the cache updated in place) and the greedy argmax.
    On ``mesh`` the params are this rank's shards and the cache is
    ``init_cache(axis=serve.axis)``'s."""
    axis = _axis(model, mesh)

    @torch.no_grad()
    def serve(params: dict, cache: dict, token: torch.Tensor):
        logits, cache = model.decode_step(params, cache, token,
                                          use_window=use_window, axis=axis)
        return torch.argmax(logits, dim=-1).to(torch.int32), cache

    serve.axis = axis
    return serve
