"""Transformer assembly of the LM zoo (port of
``repro.models.transformer``): dense and MoE attention stacks (GQA or
MLA), RWKV-6 stacks, jamba's hybrid period of Mamba and attention blocks
with MoE FFNs, whisper's encoder-decoder stack and pixtral's vision
patches.

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

An encoder-decoder stack (``cfg.is_encdec``, whisper) has, as in the
JAX package, no period level: its decoder blocks, each with
cross-attention (``xattn``, ``norm_x``), are stacked under ``layers/``
(``layers/mixer/wq`` of shape ``(num_layers, d_model, H·D)``), its
bidirectional encoder blocks under ``encoder/layers/`` with the
encoder's ``encoder/final_norm/``. The encoder reads ``aux_in["frames"]``
``(B, encoder_seq, d_model)``, the stub frontend's frame embeddings. A
vision stack (``cfg.vision_patches``, pixtral) prepends
``aux_in["patches"]`` ``(B, P, d_model)`` to the token embeddings, and
the causal pass runs over all ``P + S`` positions.

Decode keeps per-layer caches stacked the same way over the periods
(an attention block's ``layers/b4/k`` of shape ``(num_periods, B, S_max,
H_kv, D)``; an MLA block's latents ``layers/b0/c_kv`` of ``(num_periods,
B, S_max, kv_lora)`` and ``k_rope`` of ``(num_periods, B, S_max,
rope)``; an RWKV block's ``layers/b0/s`` of ``(num_periods, B, H, N,
N)`` f32 and ``x_prev_tm``, ``x_prev_cm`` of ``(num_periods, B,
d_model)``; a Mamba block's ``h`` of ``(num_periods, B, d_inner, N)``
f32 and ``conv`` of ``(num_periods, B, d_conv, d_inner)``; an
encoder-decoder stack's self-attention cache ``self/{k,v,pos}`` and the
encoder's k/v ``cross/{k,v}`` of ``(num_layers, B, S_enc, H_kv, D)``,
which :meth:`Transformer.prime_encdec` fills) and updates them in place.

Not ported yet: MoE's shard-local dispatch ``moe_dispatch_local``
(ROADMAP Queue A item 19), which raises ``NotImplementedError``.
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


def _check_supported(cfg: ArchConfig) -> None:
    if cfg.moe is not None and cfg.moe_dispatch_local:
        raise NotImplementedError(f"{cfg.name}: {moe_lib.LOCAL_DISPATCH}")


# ====================================================== block definitions
def _block_defs(cfg: ArchConfig, kind: str, is_moe: bool,
                cross: bool = False) -> dict:
    """ParamDef tree for one block: an attention (GQA or MLA) or Mamba
    mixer with an MLP or MoE FFN, or an RWKV block (which carries its own
    FFN, the channel mix). ``cross`` adds a decoder block's
    cross-attention (``norm_x``, ``xattn``). An encoder block's params
    are those of any attention block (the JAX package's ``bidir`` flag
    changes nothing there: the mask is the caller's)."""
    d = {"norm1": norm_def(cfg.d_model, cfg.norm_kind),
         "norm2": norm_def(cfg.d_model, cfg.norm_kind)}
    if kind == "rwkv":
        d["mixer"] = rwkv_lib.rwkv_defs(cfg)
        d["cm"] = rwkv_lib.channel_mix_defs(cfg)
        return d
    if kind == "attn":
        d["mixer"] = (attn.mla_defs(cfg) if cfg.attention_kind == "mla"
                      else attn.gqa_defs(cfg))
    elif kind == "mamba":
        d["mixer"] = ssm_lib.mamba_defs(cfg)
    else:
        raise ValueError(kind)
    if cross:
        d["norm_x"] = norm_def(cfg.d_model, cfg.norm_kind)
        d["xattn"] = attn.gqa_defs(cfg, cross=True)
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
                 causal: bool = True, window: Optional[int] = None,
                 enc: Optional[torch.Tensor] = None
                 ) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One block forward; with ``enc`` (the encoder's states), a decoder
    block's cross-attention after its self-attention. Returns (x, the MoE
    aux loss, or None for a block without MoE, whose aux the JAX package
    counts as 0)."""
    if kind == "rwkv":
        x = x + rwkv_lib.rwkv_time_mix(
            cfg, p["mixer"], apply_norm(p["norm1"], x, cfg.norm_kind))
        return x + rwkv_lib.rwkv_channel_mix(
            cfg, p["cm"], apply_norm(p["norm2"], x, cfg.norm_kind)), None
    h = apply_norm(p["norm1"], x, cfg.norm_kind)
    if kind == "mamba":
        x = x + ssm_lib.mamba_forward(cfg, p["mixer"], h)
    elif cfg.attention_kind == "mla":
        x = x + attn.mla_forward(cfg, p["mixer"], h, positions)
    else:
        x = x + attn.attention_forward(cfg, p["mixer"], h, positions,
                                       causal=causal, window=window)
    if enc is not None:
        hx = apply_norm(p["norm_x"], x, cfg.norm_kind)
        x = x + attn.attention_forward(cfg, p["xattn"], hx, positions,
                                       causal=False, kv_x=enc)
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
        if cfg.is_encdec:
            # Decoder blocks gain cross-attention; no period level.
            layers = _block_defs(cfg, "attn", False, cross=True)
        else:
            layers = {f"b{j}": _block_defs(cfg, kind, cfg.layer_is_moe(j))
                      for j, kind in enumerate(self.pattern)}
        d: dict[str, Any] = {
            "embed": embed_def(cfg.vocab_size, cfg.d_model),
            "final_norm": norm_def(cfg.d_model, cfg.norm_kind),
            "layers": add_leading_axis(layers, self.num_periods),
        }
        if not cfg.tie_embeddings:
            d["head"] = ParamDef((cfg.d_model, cfg.vocab_size), scale=0.02)
        if cfg.is_encdec:
            d["encoder"] = {
                "layers": add_leading_axis(_block_defs(cfg, "attn", False),
                                           cfg.encoder_layers),
                "final_norm": norm_def(cfg.d_model, cfg.norm_kind),
            }
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
    def hidden_states(self, params: dict, tokens: torch.Tensor,
                      aux_in: Optional[dict] = None
                      ) -> tuple[torch.Tensor, torch.Tensor]:
        """The final-normed hidden states (B, S, d_model) of ``forward``,
        before the unembedding, and the summed MoE aux loss (f32 scalar,
        0 without MoE). ``aux_in`` as for :meth:`forward`."""
        cfg = self.cfg
        act_dtype = getattr(torch, cfg.act_dtype)
        x = apply_embed({"table": params["embed/table"]},
                        tokens.long()).to(act_dtype)
        if cfg.vision_patches and aux_in and "patches" in aux_in:
            x = torch.cat([aux_in["patches"].to(act_dtype), x], dim=1)
        positions = torch.arange(x.shape[1], dtype=torch.int32,
                                 device=x.device)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        enc = None
        if cfg.is_encdec:
            if not aux_in or "frames" not in aux_in:
                raise ValueError(f"{cfg.name}: an encoder-decoder stack "
                                 f"reads aux_in['frames']")
            enc = self._encode(params, aux_in["frames"])

        def period(x: torch.Tensor, aux: torch.Tensor, i: int):
            if cfg.is_encdec:
                x, _ = _apply_block(cfg, "attn", False,
                                    _layer(params, "layers/", i), x,
                                    positions, enc=enc)
                return x, aux
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

    def _encode(self, params: dict, frames: torch.Tensor) -> torch.Tensor:
        """The encoder over the stub frontend's frame embeddings
        (bidirectional: the flash kernel with the causal mask off),
        final-normed."""
        cfg = self.cfg
        x = frames.to(getattr(torch, cfg.act_dtype))
        positions = torch.arange(x.shape[1], dtype=torch.int32,
                                 device=x.device)
        for i in range(cfg.encoder_layers):
            x, _ = _apply_block(cfg, "attn", False,
                                _layer(params, "encoder/layers/", i), x,
                                positions, causal=False)
        return apply_norm(_layer(params, "encoder/final_norm/"), x,
                          cfg.norm_kind)

    def logits(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        """Unembed hidden states: the tied table or the head."""
        if self.cfg.tie_embeddings:
            return unembed(params["embed/table"], x)
        return x @ params["head"]

    def forward(self, params: dict, tokens: torch.Tensor,
                aux_in: Optional[dict] = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
        """-> (logits (B, S, V), aux_loss: the MoE blocks' summed
        load-balance loss, an f32 scalar, 0 without MoE). ``aux_in`` holds
        the stub frontends' inputs, as the JAX package's ``aux_inputs``:
        ``"frames"`` (B, S_enc, d_model), which an encoder-decoder stack
        requires, and ``"patches"`` (B, P, d_model), which a vision stack
        prepends (its logits then cover ``P + S`` positions); a stack
        without the feature ignores them."""
        x, aux = self.hidden_states(params, tokens, aux_in)
        return self.logits(params, x), aux

    # ----------------------------------------------------------- decode
    def init_cache(self, batch: int, max_len: int, use_window: bool = False,
                   device: torch.device | str = "cuda") -> dict:
        """Decode cache in the activation dtype: ``idx`` (a Python int,
        the next position) and per block ``layers/b{j}/{k,v,pos}`` (an
        attention block), ``layers/b{j}/{c_kv,k_rope,pos}`` (an MLA
        block), ``layers/b{j}/{s,x_prev_tm,x_prev_cm}`` (an RWKV block)
        or ``layers/b{j}/{h,conv}`` (a Mamba block; the recurrent states
        are the same size for any ``max_len``), stacked over the periods;
        for an encoder-decoder stack ``self/{k,v,pos}`` and zeroed
        ``cross/{k,v}`` (filled by :meth:`prime_encdec`), stacked over the
        decoder's layers."""
        cfg = self.cfg
        dtype = getattr(torch, cfg.act_dtype)
        window = cfg.sliding_window if use_window else None
        cache: dict[str, Any] = {"idx": 0}

        def stack(prefix: str, one: dict) -> None:
            for name, leaf in one.items():
                cache[f"{prefix}{name}"] = leaf.expand(
                    self.num_periods, *leaf.shape).contiguous()
        if cfg.is_encdec:
            stack("self/", attn.init_kv_cache(cfg, batch, max_len, window,
                                              dtype, device))
            shape = (cfg.num_layers, batch, cfg.encoder_seq,
                     cfg.num_kv_heads, cfg.head_dim)
            for name in ("k", "v"):
                cache[f"cross/{name}"] = torch.zeros(shape, dtype=dtype,
                                                     device=device)
            return cache
        for j, kind in enumerate(self.pattern):
            if kind == "rwkv":
                one = rwkv_lib.init_rwkv_cache(cfg, batch, dtype, device)
            elif kind == "mamba":
                one = ssm_lib.init_mamba_cache(cfg, batch, dtype, device)
            elif cfg.attention_kind == "mla":
                one = attn.init_mla_cache(cfg, batch, max_len, dtype, device)
            else:
                one = attn.init_kv_cache(cfg, batch, max_len, window, dtype,
                                         device)
            stack(f"layers/b{j}/", one)
        return cache

    def prime_encdec(self, params: dict, cache: dict,
                     frames: torch.Tensor) -> dict:
        """Run the encoder over ``frames`` (B, S_enc, d_model) and fill the
        cross-attention caches (``cross/k``, ``cross/v``, replaced by the
        encoder's k/v of every decoder layer). Returns ``cache``."""
        cfg = self.cfg
        enc = self._encode(params, frames)
        xcs = [attn.cross_attention_cache(
            cfg, _layer(params, "layers/", i)["xattn"], enc)
            for i in range(cfg.num_layers)]
        for name in ("k", "v"):
            cache[f"cross/{name}"] = torch.stack([xc[name] for xc in xcs])
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
        if cfg.is_encdec:
            for i in range(cfg.num_layers):
                p = _layer(params, "layers/", i)
                hin = apply_norm(p["norm1"], x, cfg.norm_kind)
                y, _ = attn.attention_decode(
                    cfg, p["mixer"], hin, _layer(cache, "self/", i), idx,
                    window)
                x = x + y
                hx = apply_norm(p["norm_x"], x, cfg.norm_kind)
                x = x + attn.cross_attention_decode(
                    cfg, p["xattn"], hx, _layer(cache, "cross/", i))
                x = x + apply_mlp(p["mlp"], apply_norm(p["norm2"], x,
                                                       cfg.norm_kind),
                                  cfg.act)
            return self._decoded(params, cache, x)
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
                elif cfg.attention_kind == "mla":
                    y, _ = attn.mla_decode(cfg, p["mixer"], hin, c, idx)
                else:
                    y, _ = attn.attention_decode(cfg, p["mixer"], hin, c,
                                                 idx, window)
                x = x + y
                y, _ = _ffn(cfg, cfg.layer_is_moe(j), p,
                            apply_norm(p["norm2"], x, cfg.norm_kind))
                x = x + y
        return self._decoded(params, cache, x)

    def _decoded(self, params: dict, cache: dict,
                 x: torch.Tensor) -> tuple[torch.Tensor, dict]:
        """The step's end: advance ``idx``, final norm, logits (B, V)."""
        cache["idx"] += 1
        x = apply_norm(_layer(params, "final_norm/"), x, self.cfg.norm_kind)
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
