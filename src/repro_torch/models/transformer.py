"""Transformer assembly of the LM zoo (port of
``repro.models.transformer``): dense and MoE attention stacks (GQA or
MLA), RWKV-6 stacks, jamba's hybrid period of Mamba and attention blocks
with MoE FFNs, whisper's encoder-decoder stack and pixtral's vision
patches.

Params are the port's flat ``dict[str, Tensor]``. The layers of one
period are stacked along a leading axis under ``layers/b{j}/...`` keys,
as the JAX package stacks them (``add_leading_axis``), so a key such as
``layers/b0/mixer/wq`` has shape ``(num_layers, d_model, H·D)``. The JAX
package's ``lax.scan`` over the stack becomes a Python loop over the
layers: a forward splits each stacked leaf once (``torch.unbind``) and
hands layer ``i`` its ``i``-th piece, so autograd stacks a leaf's
per-layer gradients once, where a view ``params[key][i]`` per layer
would add a zero-filled gradient the size of the whole stack into the
leaf's for every layer; decode, which keeps no grad, takes the views
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

Tensor parallelism over the mesh's ``model`` axis: ``hidden_states``,
``forward``, ``logits``, ``init_cache``, ``prime_encdec`` and
``decode_step`` take an optional ``axis``
(:class:`repro_torch.models.sharding.ModelAxis`) with ``params`` this
rank's shards (``sharding.shard_params`` by the sanitized
:meth:`Transformer.specs`). Each block then runs on its local heads,
channels or experts where ``model`` divides them and meets the other
ranks in all-reduces, or gathers its leaves and runs whole
(``models/sharding.py``); the embedding is vocab-parallel and the logits
are gathered, so ``forward`` returns whole logits on every rank and the
loss is unchanged. ``axis=None`` is the unsharded path.
:meth:`Transformer.specs` and :meth:`Transformer.cache_specs` are the
reference's partition specs, as tuples.
"""
from __future__ import annotations

from typing import Any, Optional

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.meter import note
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_lib
from repro_torch.models import rwkv as rwkv_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.layers import (
    apply_embed,
    apply_head,
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
    param_specs,
)
from repro_torch.models.sharding import ModelAxis, Shards


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


def _sub(tp: Optional[Shards], name: str) -> Optional[Shards]:
    return None if tp is None else tp.sub(name)


def _ffn(cfg: ArchConfig, is_moe: bool, p: dict, h2: torch.Tensor,
         tp: Optional[Shards] = None
         ) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The block's FFN on the normed input: (y, MoE aux loss or None)."""
    if is_moe:
        return moe_lib.apply_moe(cfg, p["moe"], h2, _sub(tp, "moe"))
    return apply_mlp(p["mlp"], h2, cfg.act, _sub(tp, "mlp")), None


def _apply_block(cfg: ArchConfig, kind: str, is_moe: bool, p: dict,
                 x: torch.Tensor, positions: torch.Tensor, *,
                 causal: bool = True, window: Optional[int] = None,
                 enc: Optional[torch.Tensor] = None,
                 tp: Optional[Shards] = None
                 ) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One block forward; with ``enc`` (the encoder's states), a decoder
    block's cross-attention after its self-attention. Returns (x, the MoE
    aux loss, or None for a block without MoE, whose aux the JAX package
    counts as 0). ``tp``: the block's leaves' shards."""
    mixer = _sub(tp, "mixer")
    if kind == "rwkv":
        x = x + rwkv_lib.rwkv_time_mix(
            cfg, p["mixer"], apply_norm(p["norm1"], x, cfg.norm_kind), mixer)
        return x + rwkv_lib.rwkv_channel_mix(
            cfg, p["cm"], apply_norm(p["norm2"], x, cfg.norm_kind),
            _sub(tp, "cm")), None
    h = apply_norm(p["norm1"], x, cfg.norm_kind)
    if kind == "mamba":
        x = x + ssm_lib.mamba_forward(cfg, p["mixer"], h, mixer)
    elif cfg.attention_kind == "mla":
        x = x + attn.mla_forward(cfg, p["mixer"], h, positions, mixer)
    else:
        x = x + attn.attention_forward(cfg, p["mixer"], h, positions,
                                       causal=causal, window=window,
                                       tp=mixer)
    if enc is not None:
        hx = apply_norm(p["norm_x"], x, cfg.norm_kind)
        x = x + attn.attention_forward(cfg, p["xattn"], hx, positions,
                                       causal=False, kv_x=enc,
                                       tp=_sub(tp, "xattn"))
    y, aux = _ffn(cfg, is_moe, p, apply_norm(p["norm2"], x, cfg.norm_kind),
                  tp)
    return x + y, aux


def _shards(axis: Optional[ModelAxis], prefix: str,
            layer: bool = False) -> Optional[Shards]:
    """The shards of the leaves under ``prefix`` (``layer``: stacked over
    layers), or None without a ``model`` axis."""
    return None if axis is None else axis.shards(prefix, layer)


def _split(params: dict, *prefixes: str) -> dict:
    """The stacked leaves under ``prefixes``, each split once along its
    layer axis into a tuple of per-layer views (``torch.unbind``), which
    :func:`_layer` indexes as it would the leaf. Taken outside remat's
    periods, each leaf's split is one ``UnbindBackward0`` that stacks
    the layers' gradients once."""
    return {k: torch.unbind(leaf, 0) for k, leaf in params.items()
            if k.startswith(prefixes)}


def _note_split(layers: dict) -> None:
    """Note on the open span how a forward took its layers' views from
    ``layers``: ``stacked_split``, the stacked leaves split once, and
    ``stacked_indexed``, the per-layer views it would take by indexing a
    stacked leaf that requires grad (each a whole-stack zero fill and add
    in the backward)."""
    note(stacked_split=sum(isinstance(v, tuple) for v in layers.values()),
         stacked_indexed=sum(v.shape[0] for v in layers.values()
                             if isinstance(v, torch.Tensor)
                             and v.requires_grad))


def _layer(params: dict, prefix: str, i: Optional[int] = None) -> dict:
    """Layer ``i`` of the stacked leaves under ``prefix`` (or of their
    :func:`_split` pieces) as the nested dict the block functions read:
    ``{"mixer": {"wq": view}, ...}``; with no ``i``, the leaves
    themselves (``final_norm/``)."""
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
            d["head"] = ParamDef((cfg.d_model, cfg.vocab_size), scale=0.02,
                                 axes=(None, "model"))
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

    def specs(self, prefix: tuple = ()) -> dict:
        """Each leaf's partition spec (the defs' ``axes``) as a tuple, with
        ``prefix`` prepended: the reference's ``model.specs()``."""
        return param_specs(self.defs(), prefix)

    def cache_specs(self, use_window: bool = False,
                    long_ctx: bool = False) -> dict:
        """Partition specs matching :meth:`init_cache`'s keys (the
        reference's ``cache_specs``, flat): every stacked leaf's first dim
        (the layers) unsharded; ``idx`` a 0-d spec."""
        cfg = self.cfg
        window = cfg.sliding_window if use_window else None
        specs: dict[str, Any] = {"idx": ()}

        def stack(prefix: str, one: dict) -> None:
            for name, spec in one.items():
                specs[f"{prefix}{name}"] = (None, *spec)
        if cfg.is_encdec:
            stack("self/", attn.kv_cache_specs(window, 0, long_ctx))
            for name in ("k", "v"):
                specs[f"cross/{name}"] = (None, "data", None, "model", None)
            return specs
        for j, kind in enumerate(self.pattern):
            if kind == "rwkv":
                one = rwkv_lib.rwkv_cache_specs()
            elif kind == "mamba":
                one = ssm_lib.mamba_cache_specs()
            elif cfg.attention_kind == "mla":
                one = attn.mla_cache_specs(long_ctx)
            else:
                one = attn.kv_cache_specs(window, 0, long_ctx)
            stack(f"layers/b{j}/", one)
        return specs

    def model_axis(self, mesh: Any, specs: dict) -> ModelAxis:
        """The ``model`` axis of ``mesh`` for this model, the leaves
        sharded by ``specs`` (sanitized trailing specs,
        ``launch/specs.sanitize_specs``)."""
        return ModelAxis.from_mesh(mesh, specs, self.specs())

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
                      aux_in: Optional[dict] = None,
                      axis: Optional[ModelAxis] = None
                      ) -> tuple[torch.Tensor, torch.Tensor]:
        """The final-normed hidden states (B, S, d_model) of ``forward``,
        before the unembedding, and the summed MoE aux loss (f32 scalar,
        0 without MoE). ``aux_in`` and ``axis`` as for :meth:`forward`."""
        cfg = self.cfg
        act_dtype = getattr(torch, cfg.act_dtype)
        if axis is not None:
            params = axis.prepare(params)
        x = apply_embed({"table": params["embed/table"]}, tokens.long(),
                        _shards(axis, "embed/")).to(act_dtype)
        if cfg.vision_patches and aux_in and "patches" in aux_in:
            x = torch.cat([aux_in["patches"].to(act_dtype), x], dim=1)
        positions = torch.arange(x.shape[1], dtype=torch.int32,
                                 device=x.device)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        layers = _split(params, "layers/", "encoder/layers/")
        _note_split(layers)
        enc = None
        if cfg.is_encdec:
            if not aux_in or "frames" not in aux_in:
                raise ValueError(f"{cfg.name}: an encoder-decoder stack "
                                 f"reads aux_in['frames']")
            enc = self._encode(params, aux_in["frames"], axis, layers)

        def period(x: torch.Tensor, aux: torch.Tensor, i: int):
            if cfg.is_encdec:
                x, _ = _apply_block(cfg, "attn", False,
                                    _layer(layers, "layers/", i), x,
                                    positions, enc=enc,
                                    tp=_shards(axis, "layers/", True))
                return x, aux
            for j, kind in enumerate(self.pattern):
                x, a = _apply_block(cfg, kind, cfg.layer_is_moe(j),
                                    _layer(layers, f"layers/b{j}/", i), x,
                                    positions,
                                    tp=_shards(axis, f"layers/b{j}/", True))
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

    def _encode(self, params: dict, frames: torch.Tensor,
                axis: Optional[ModelAxis] = None,
                layers: Optional[dict] = None) -> torch.Tensor:
        """The encoder over the stub frontend's frame embeddings
        (bidirectional: the flash kernel with the causal mask off),
        final-normed. ``layers``: the encoder's stacked leaves already
        :func:`_split`, else split here."""
        cfg = self.cfg
        if layers is None:
            layers = _split(params, "encoder/layers/")
        x = frames.to(getattr(torch, cfg.act_dtype))
        positions = torch.arange(x.shape[1], dtype=torch.int32,
                                 device=x.device)
        for i in range(cfg.encoder_layers):
            x, _ = _apply_block(cfg, "attn", False,
                                _layer(layers, "encoder/layers/", i), x,
                                positions, causal=False,
                                tp=_shards(axis, "encoder/layers/", True))
        return apply_norm(_layer(params, "encoder/final_norm/"), x,
                          cfg.norm_kind)

    def logits(self, params: dict, x: torch.Tensor,
               axis: Optional[ModelAxis] = None) -> torch.Tensor:
        """Unembed hidden states: the tied table or the head; with
        ``axis``, each rank's vocab shard, gathered."""
        if axis is not None:
            params = axis.prepare(params)
        if self.cfg.tie_embeddings:
            return unembed(params["embed/table"], x,
                           _shards(axis, "embed/"))
        return apply_head(params["head"], x, _shards(axis, ""))

    def forward(self, params: dict, tokens: torch.Tensor,
                aux_in: Optional[dict] = None,
                axis: Optional[ModelAxis] = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
        """-> (logits (B, S, V), aux_loss: the MoE blocks' summed
        load-balance loss, an f32 scalar, 0 without MoE). ``aux_in`` holds
        the stub frontends' inputs, as the JAX package's ``aux_inputs``:
        ``"frames"`` (B, S_enc, d_model), which an encoder-decoder stack
        requires, and ``"patches"`` (B, P, d_model), which a vision stack
        prepends (its logits then cover ``P + S`` positions); a stack
        without the feature ignores them. ``axis``: the mesh's ``model``
        axis, ``params`` then this rank's shards (the module's text)."""
        if axis is not None:
            params = axis.prepare(params)
        x, aux = self.hidden_states(params, tokens, aux_in, axis)
        return self.logits(params, x, axis), aux

    # ----------------------------------------------------------- decode
    def _local_heads(self, axis: Optional[ModelAxis], prefix: str,
                     want: dict, units: int) -> int:
        """``m`` where the layers under ``prefix`` run on their shards
        (their caches then hold ``1/m`` of the heads or channels), else
        1."""
        tp = _shards(axis, prefix, True)
        return tp.size if tp is not None and tp.parallel(want, units) else 1

    def init_cache(self, batch: int, max_len: int, use_window: bool = False,
                   device: torch.device | str = "cuda",
                   axis: Optional[ModelAxis] = None) -> dict:
        """Decode cache in the activation dtype: ``idx`` (a Python int,
        the next position) and per block ``layers/b{j}/{k,v,pos}`` (an
        attention block), ``layers/b{j}/{c_kv,k_rope,pos}`` (an MLA
        block), ``layers/b{j}/{s,x_prev_tm,x_prev_cm}`` (an RWKV block)
        or ``layers/b{j}/{h,conv}`` (a Mamba block; the recurrent states
        are the same size for any ``max_len``), stacked over the periods;
        for an encoder-decoder stack ``self/{k,v,pos}`` and zeroed
        ``cross/{k,v}`` (filled by :meth:`prime_encdec`), stacked over the
        decoder's layers. With ``axis``, the caches of blocks that run on
        their shards hold the rank's KV heads (RWKV heads, Mamba
        channels), as :meth:`cache_specs` places them over ``model``; an
        MLA block's latents, and the caches of blocks that gather, are
        whole on every rank."""
        cfg = self.cfg
        dtype = getattr(torch, cfg.act_dtype)
        window = cfg.sliding_window if use_window else None
        cache: dict[str, Any] = {"idx": 0}

        def stack(prefix: str, one: dict) -> None:
            for name, leaf in one.items():
                cache[f"{prefix}{name}"] = leaf.expand(
                    self.num_periods, *leaf.shape).contiguous()
        if cfg.is_encdec:
            m = self._local_heads(axis, "layers/mixer/", attn.GQA_WANT,
                                  cfg.num_kv_heads)
            stack("self/", attn.init_kv_cache(cfg, batch, max_len, window,
                                              dtype, device, m))
            mx = self._local_heads(axis, "layers/xattn/", attn.GQA_WANT,
                                   cfg.num_kv_heads)
            shape = (cfg.num_layers, batch, cfg.encoder_seq,
                     cfg.num_kv_heads // mx, cfg.head_dim)
            for name in ("k", "v"):
                cache[f"cross/{name}"] = torch.zeros(shape, dtype=dtype,
                                                     device=device)
            return cache
        for j, kind in enumerate(self.pattern):
            pre = f"layers/b{j}/mixer/"
            if kind == "rwkv":
                one = rwkv_lib.init_rwkv_cache(
                    cfg, batch, dtype, device, self._local_heads(
                        axis, pre, rwkv_lib.TIME_MIX_WANT, cfg.rwkv_heads))
            elif kind == "mamba":
                one = ssm_lib.init_mamba_cache(
                    cfg, batch, dtype, device, self._local_heads(
                        axis, pre, ssm_lib.MAMBA_WANT, cfg.d_inner_mamba))
            elif cfg.attention_kind == "mla":
                one = attn.init_mla_cache(cfg, batch, max_len, dtype, device)
            else:
                one = attn.init_kv_cache(
                    cfg, batch, max_len, window, dtype, device,
                    self._local_heads(axis, pre, attn.GQA_WANT,
                                      cfg.num_kv_heads))
            stack(f"layers/b{j}/", one)
        return cache

    def prime_encdec(self, params: dict, cache: dict,
                     frames: torch.Tensor,
                     axis: Optional[ModelAxis] = None) -> dict:
        """Run the encoder over ``frames`` (B, S_enc, d_model) and fill the
        cross-attention caches (``cross/k``, ``cross/v``, replaced by the
        encoder's k/v of every decoder layer). Returns ``cache``."""
        cfg = self.cfg
        if axis is not None:
            params = axis.prepare(params)
        enc = self._encode(params, frames, axis)
        tp = _shards(axis, "layers/", True)
        xcs = [attn.cross_attention_cache(
            cfg, _layer(params, "layers/", i)["xattn"], enc,
            _sub(tp, "xattn"))
            for i in range(cfg.num_layers)]
        for name in ("k", "v"):
            cache[f"cross/{name}"] = torch.stack([xc[name] for xc in xcs])
        return cache

    def decode_step(self, params: dict, cache: dict, token: torch.Tensor,
                    use_window: bool = False,
                    axis: Optional[ModelAxis] = None
                    ) -> tuple[torch.Tensor, dict]:
        """One token for the whole stack. token: (B,) int. Updates
        ``cache`` in place and returns (logits (B, V), cache); with
        ``axis``, the cache of :meth:`init_cache` with that axis."""
        cfg = self.cfg
        idx = cache["idx"]
        if axis is not None:
            params = axis.prepare(params)
        x = apply_embed({"table": params["embed/table"]},
                        token.long()[:, None],
                        _shards(axis, "embed/")).to(
                            getattr(torch, cfg.act_dtype))
        window = cfg.sliding_window if use_window else None
        if cfg.is_encdec:
            tp = _shards(axis, "layers/", True)
            for i in range(cfg.num_layers):
                p = _layer(params, "layers/", i)
                hin = apply_norm(p["norm1"], x, cfg.norm_kind)
                y, _ = attn.attention_decode(
                    cfg, p["mixer"], hin, _layer(cache, "self/", i), idx,
                    window, _sub(tp, "mixer"))
                x = x + y
                hx = apply_norm(p["norm_x"], x, cfg.norm_kind)
                x = x + attn.cross_attention_decode(
                    cfg, p["xattn"], hx, _layer(cache, "cross/", i),
                    _sub(tp, "xattn"))
                x = x + apply_mlp(p["mlp"], apply_norm(p["norm2"], x,
                                                       cfg.norm_kind),
                                  cfg.act, _sub(tp, "mlp"))
            return self._decoded(params, cache, x, axis)
        for i in range(self.num_periods):
            for j, kind in enumerate(self.pattern):
                p = _layer(params, f"layers/b{j}/", i)
                c = _layer(cache, f"layers/b{j}/", i)
                tp = _shards(axis, f"layers/b{j}/", True)
                mixer = _sub(tp, "mixer")
                hin = apply_norm(p["norm1"], x, cfg.norm_kind)
                if kind == "rwkv":
                    y, _ = rwkv_lib.rwkv_decode(cfg, p["mixer"], hin, c,
                                                mixer)
                    x = x + y
                    h2 = apply_norm(p["norm2"], x, cfg.norm_kind)
                    x = x + rwkv_lib.rwkv_channel_mix_decode(
                        cfg, p["cm"], h2, c["x_prev_cm"], _sub(tp, "cm"))
                    c["x_prev_cm"].copy_(h2[:, 0])
                    continue
                if kind == "mamba":
                    y, _ = ssm_lib.mamba_decode(cfg, p["mixer"], hin, c,
                                                mixer)
                elif cfg.attention_kind == "mla":
                    y, _ = attn.mla_decode(cfg, p["mixer"], hin, c, idx,
                                           mixer)
                else:
                    y, _ = attn.attention_decode(cfg, p["mixer"], hin, c,
                                                 idx, window, mixer)
                x = x + y
                y, _ = _ffn(cfg, cfg.layer_is_moe(j), p,
                            apply_norm(p["norm2"], x, cfg.norm_kind), tp)
                x = x + y
        return self._decoded(params, cache, x, axis)

    def _decoded(self, params: dict, cache: dict, x: torch.Tensor,
                 axis: Optional[ModelAxis] = None
                 ) -> tuple[torch.Tensor, dict]:
        """The step's end: advance ``idx``, final norm, logits (B, V)."""
        cache["idx"] += 1
        x = apply_norm(_layer(params, "final_norm/"), x, self.cfg.norm_kind)
        return self.logits(params, x, axis)[:, 0], cache


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
