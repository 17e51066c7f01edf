"""Transformer assembly of the LM zoo (port of
``repro.models.transformer``): dense attention stacks, RWKV-6 stacks and
jamba's hybrid period of Mamba and attention blocks with MoE FFNs.

Params are the port's flat ``dict[str, Tensor]``. The layers of one
period are stacked along a leading axis under ``layers/b{j}/...`` keys,
as the JAX package stacks them (``add_leading_axis``), so a key such as
``layers/b0/mixer/wq`` has shape ``(num_layers, d_model, H·D)``. The JAX
package's ``lax.scan`` over the stack becomes a Python loop over views
``params[key][i]``. ``cfg.remat`` is activation checkpointing for
training, as the JAX package's ``jax.checkpoint`` of its period body:
with grad enabled each period runs under ``torch.utils.checkpoint``
(non-reentrant), so only its input is kept and its forward is run again
in the backward; with grad disabled (serving) it changes nothing. The
JAX package's ``unroll`` (a cost-analysis knob for its scans) has no
counterpart.

Decode keeps per-layer caches stacked the same way over the periods
(an attention block's ``layers/b4/k`` of shape ``(num_periods, B, S_max,
H_kv, D)``; an RWKV block's ``layers/b0/s`` of ``(num_periods, B, H, N,
N)`` f32 and ``x_prev_tm``, ``x_prev_cm`` of ``(num_periods, B,
d_model)``; a Mamba block's ``h`` of ``(num_periods, B, d_inner, N)``
f32 and ``conv`` of ``(num_periods, B, d_conv, d_inner)``) and updates
them in place.

Not ported yet, each raising ``NotImplementedError``: MLA,
encoder-decoder stacks and vision patches (ROADMAP Queue A item 13), and
MoE's shard-local dispatch ``moe_dispatch_local`` (item 12).
"""
from __future__ import annotations

from typing import Any, Optional

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_lib
from repro_torch.models import rwkv as rwkv_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.layers import (
    apply_embed,
    apply_mlp,
    apply_norm,
    embed_def,
    mlp_def,
    norm_def,
    unembed,
)
from repro_torch.models.params import (
    ParamDef,
    add_leading_axis,
    flatten_defs,
    init_params,
    param_count,
)

_ITEM = "ROADMAP Queue A item 13"


def _check_supported(cfg: ArchConfig) -> None:
    missing = []
    if cfg.attention_kind != "gqa":
        missing.append(f"{cfg.attention_kind} attention")
    if cfg.is_encdec:
        missing.append("encoder-decoder stacks")
    if cfg.vision_patches:
        missing.append("vision patches")
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(missing)} not ported yet ({_ITEM})")
    if cfg.moe is not None and cfg.moe_dispatch_local:
        raise NotImplementedError(f"{cfg.name}: {moe_lib.LOCAL_DISPATCH}")


# ====================================================== block definitions
def _block_defs(cfg: ArchConfig, kind: str, is_moe: bool) -> dict:
    """ParamDef tree for one block: an attention or Mamba mixer with an
    MLP or MoE FFN, or an RWKV block (which carries its own FFN, the
    channel mix)."""
    d = {"norm1": norm_def(cfg.d_model, cfg.norm_kind),
         "norm2": norm_def(cfg.d_model, cfg.norm_kind)}
    if kind == "rwkv":
        d["mixer"] = rwkv_lib.rwkv_defs(cfg)
        d["cm"] = rwkv_lib.channel_mix_defs(cfg)
        return d
    if kind == "attn":
        d["mixer"] = attn.gqa_defs(cfg)
    elif kind == "mamba":
        d["mixer"] = ssm_lib.mamba_defs(cfg)
    else:
        raise ValueError(kind)
    if is_moe:
        d["moe"] = moe_lib.moe_defs(cfg)
    else:
        d["mlp"] = mlp_def(cfg.d_model, cfg.d_ff, cfg.act)
    return d


def _ffn(cfg: ArchConfig, is_moe: bool, p: dict,
         h2: torch.Tensor) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The block's FFN on the normed input: (y, MoE aux loss or None)."""
    if is_moe:
        return moe_lib.apply_moe(cfg, p["moe"], h2)
    return apply_mlp(p["mlp"], h2, cfg.act), None


def _apply_block(cfg: ArchConfig, kind: str, is_moe: bool, p: dict,
                 x: torch.Tensor, positions: torch.Tensor, *,
                 causal: bool = True, window: Optional[int] = None
                 ) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One block forward. Returns (x, the MoE aux loss, or None for a
    block without MoE, whose aux the JAX package counts as 0)."""
    if kind == "rwkv":
        x = x + rwkv_lib.rwkv_time_mix(
            cfg, p["mixer"], apply_norm(p["norm1"], x, cfg.norm_kind))
        return x + rwkv_lib.rwkv_channel_mix(
            cfg, p["cm"], apply_norm(p["norm2"], x, cfg.norm_kind)), None
    h = apply_norm(p["norm1"], x, cfg.norm_kind)
    if kind == "mamba":
        x = x + ssm_lib.mamba_forward(cfg, p["mixer"], h)
    else:
        x = x + attn.attention_forward(cfg, p["mixer"], h, positions,
                                       causal=causal, window=window)
    y, aux = _ffn(cfg, is_moe, p, apply_norm(p["norm2"], x, cfg.norm_kind))
    return x + y, aux


def _layer(params: dict, prefix: str, i: Optional[int] = None) -> dict:
    """Layer ``i`` of the stacked leaves under ``prefix`` as the nested
    dict the block functions read: ``{"mixer": {"wq": view}, ...}``; with
    no ``i``, the leaves themselves (``final_norm/``)."""
    out: dict[str, Any] = {}
    for key, leaf in params.items():
        if key.startswith(prefix):
            *path, name = key[len(prefix):].split("/")
            node = out
            for part in path:
                node = node.setdefault(part, {})
            node[name] = leaf if i is None else leaf[i]
    return out


# ============================================================ assembly
class Transformer:
    """Functional model wrapper bound to an ArchConfig."""

    def __init__(self, cfg: ArchConfig):
        _check_supported(cfg)
        self.cfg = cfg
        pat = cfg.block_pattern
        if cfg.num_layers % len(pat) != 0:
            raise ValueError(
                f"{cfg.name}: layers {cfg.num_layers} not a multiple of "
                f"pattern {pat}")
        self.num_periods = cfg.num_layers // len(pat)
        self.pattern = pat

    # ------------------------------------------------------------ defs
    def defs(self) -> dict:
        """Flat ParamDefs, keys ``/``-joined and in the JAX package's leaf
        order (sorted paths)."""
        cfg = self.cfg
        period = {f"b{j}": _block_defs(cfg, kind, cfg.layer_is_moe(j))
                  for j, kind in enumerate(self.pattern)}
        d: dict[str, Any] = {
            "embed": embed_def(cfg.vocab_size, cfg.d_model),
            "final_norm": norm_def(cfg.d_model, cfg.norm_kind),
            "layers": add_leading_axis(period, self.num_periods),
        }
        if not cfg.tie_embeddings:
            d["head"] = ParamDef((cfg.d_model, cfg.vocab_size), scale=0.02)
        return dict(sorted(flatten_defs(d).items()))

    def init(self, gen: torch.Generator, device: torch.device | str = "cuda",
             dtype: torch.dtype | None = None) -> dict:
        dtype = dtype or getattr(torch, self.cfg.param_dtype)
        return init_params(self.defs(), gen, device, dtype)

    def count_params(self) -> int:
        return param_count(self.defs())

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE counts top_k experts only)."""
        cfg = self.cfg
        total = param_count(self.defs())
        if cfg.moe is None:
            return total
        m = cfg.moe
        expert_p = 3 * cfg.d_model * m.d_ff_expert
        n_moe_layers = sum(1 for layer in range(cfg.num_layers)
                           if cfg.layer_is_moe(layer))
        total -= n_moe_layers * (m.num_experts - m.top_k) * expert_p
        return total

    # --------------------------------------------------------- forward
    def hidden_states(self, params: dict, tokens: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
        """The final-normed hidden states (B, S, d_model) of ``forward``,
        before the unembedding, and the summed MoE aux loss (f32 scalar,
        0 without MoE)."""
        cfg = self.cfg
        x = apply_embed({"table": params["embed/table"]},
                        tokens.long()).to(getattr(torch, cfg.act_dtype))
        positions = torch.arange(x.shape[1], dtype=torch.int32,
                                 device=x.device)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)

        def period(x: torch.Tensor, aux: torch.Tensor, i: int):
            for j, kind in enumerate(self.pattern):
                x, a = _apply_block(cfg, kind, cfg.layer_is_moe(j),
                                    _layer(params, f"layers/b{j}/", i), x,
                                    positions)
                if a is not None:
                    aux = aux + a
            return x, aux

        remat = cfg.remat and torch.is_grad_enabled()
        for i in range(self.num_periods):
            if remat:
                # The blocks draw no random numbers: no RNG state to keep.
                x, aux = torch.utils.checkpoint.checkpoint(
                    period, x, aux, i, use_reentrant=False,
                    preserve_rng_state=False)
            else:
                x, aux = period(x, aux, i)
        return apply_norm(_layer(params, "final_norm/"), x,
                          cfg.norm_kind), aux

    def logits(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        """Unembed hidden states: the tied table or the head."""
        if self.cfg.tie_embeddings:
            return unembed(params["embed/table"], x)
        return x @ params["head"]

    def forward(self, params: dict, tokens: torch.Tensor,
                aux_in: Optional[dict] = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
        """-> (logits (B, S, V), aux_loss: the MoE blocks' summed
        load-balance loss, an f32 scalar, 0 without MoE). ``aux_in`` is the
        reference's frames / patches stub inputs, for encoder-decoder and
        vision stacks, which are not ported yet (raises)."""
        if aux_in:
            raise NotImplementedError(
                f"{self.cfg.name}: aux inputs {sorted(aux_in)} (frames / "
                f"patches) are for encoder-decoder and vision stacks, not "
                f"ported yet ({_ITEM})")
        x, aux = self.hidden_states(params, tokens)
        return self.logits(params, x), aux

    # ----------------------------------------------------------- decode
    def init_cache(self, batch: int, max_len: int, use_window: bool = False,
                   device: torch.device | str = "cuda") -> dict:
        """Decode cache in the activation dtype: ``idx`` (a Python int,
        the next position) and per block ``layers/b{j}/{k,v,pos}`` (an
        attention block), ``layers/b{j}/{s,x_prev_tm,x_prev_cm}`` (an
        RWKV block) or ``layers/b{j}/{h,conv}`` (a Mamba block; the
        recurrent states are the same size for any ``max_len``), stacked
        over the periods."""
        cfg = self.cfg
        dtype = getattr(torch, cfg.act_dtype)
        window = cfg.sliding_window if use_window else None
        cache: dict[str, Any] = {"idx": 0}
        for j, kind in enumerate(self.pattern):
            if kind == "rwkv":
                one = rwkv_lib.init_rwkv_cache(cfg, batch, dtype, device)
            elif kind == "mamba":
                one = ssm_lib.init_mamba_cache(cfg, batch, dtype, device)
            else:
                one = attn.init_kv_cache(cfg, batch, max_len, window, dtype,
                                         device)
            for name, leaf in one.items():
                cache[f"layers/b{j}/{name}"] = leaf.expand(
                    self.num_periods, *leaf.shape).contiguous()
        return cache

    def decode_step(self, params: dict, cache: dict, token: torch.Tensor,
                    use_window: bool = False) -> tuple[torch.Tensor, dict]:
        """One token for the whole stack. token: (B,) int. Updates
        ``cache`` in place and returns (logits (B, V), cache)."""
        cfg = self.cfg
        idx = cache["idx"]
        x = apply_embed({"table": params["embed/table"]},
                        token.long()[:, None]).to(getattr(torch, cfg.act_dtype))
        window = cfg.sliding_window if use_window else None
        for i in range(self.num_periods):
            for j, kind in enumerate(self.pattern):
                p = _layer(params, f"layers/b{j}/", i)
                c = _layer(cache, f"layers/b{j}/", i)
                hin = apply_norm(p["norm1"], x, cfg.norm_kind)
                if kind == "rwkv":
                    y, _ = rwkv_lib.rwkv_decode(cfg, p["mixer"], hin, c)
                    x = x + y
                    h2 = apply_norm(p["norm2"], x, cfg.norm_kind)
                    x = x + rwkv_lib.rwkv_channel_mix_decode(
                        cfg, p["cm"], h2, c["x_prev_cm"])
                    c["x_prev_cm"].copy_(h2[:, 0])
                    continue
                if kind == "mamba":
                    y, _ = ssm_lib.mamba_decode(cfg, p["mixer"], hin, c)
                else:
                    y, _ = attn.attention_decode(cfg, p["mixer"], hin, c,
                                                 idx, window)
                x = x + y
                y, _ = _ffn(cfg, cfg.layer_is_moe(j), p,
                            apply_norm(p["norm2"], x, cfg.norm_kind))
                x = x + y
        cache["idx"] = idx + 1
        x = apply_norm(_layer(params, "final_norm/"), x, cfg.norm_kind)
        return self.logits(params, x)[:, 0], cache


# ============================================================== loss
def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean next-token CE. logits (B,S,V), labels (B,S) int."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.take_along_dim(logits, labels.long()[..., None],
                                dim=-1)[..., 0]
    nll = logz - gold
    if mask is not None:
        return (nll * mask).sum() / mask.sum().clamp(min=1.0)
    return nll.mean()
