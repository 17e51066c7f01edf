"""Attention of the LM zoo (port of ``repro.models.attention``): GQA with
qk-norm, RoPE and an optional sliding window, cross-attention over an
encoder's states, and MLA (multi-head latent attention).

Train / prefill (:func:`attention_forward`, :func:`mla_forward`) runs
the ``flash_attention`` kernel (``repro_torch.kernels``) on the
projected, rope'd q/k/v — the function the JAX package computes with its
blockwise ``_sdpa`` loop (``repro/models/attention.py:113-133``), which
``tests/test_kernels.py`` holds equal to the Pallas flash kernel. The
``(B, S, H, D)`` layout is kept: the kernel takes q, k and v as
transposed views, no copies. Query head ``h = hkv·G + g``, as
``reshape(b, s, hkv, g, dh)`` orders it, which is the kernel's ``h // G``
map. Cross-attention (``kv_x``, the decoder of an encoder-decoder stack)
takes no RoPE and runs the kernel with the causal mask off over Sq
queries and Sk encoder states. MLA attends with q and k of head dim
``qk_nope + qk_rope`` (96 for minicpm3-4b) and v of ``v_head_dim`` (64):
the kernel's D_qk ≠ D_v variant, at the scale ``1/√D_qk``.

Decode attends one query token against a cache with plain einsums and a
softmax, as the JAX package does:

- GQA full cache: k/v ``(B, S_max, H_kv, D)``;
- GQA sliding window: a rolling cache ``(B, W, H_kv, D)`` plus the
  absolute position of each slot;
- cross-attention: the encoder's k/v, computed once
  (:func:`cross_attention_cache`);
- MLA: the compressed latent cache ``c_kv`` ``(B, S, kv_lora)`` and
  ``k_rope`` ``(B, S, rope)``, with the absorbed-matrix decode
  (:func:`mla_decode`, DeepSeek-V2's trick).

Unlike the JAX package, the caches are updated in place
(``index_copy_``): no copy of a cache per step.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import apply_rope, rms_norm_headwise
from repro_torch.models.params import ParamDef
from repro_torch.models.sharding import Shards, on_shards

NEG_INF = -1e30


# ================================================================= GQA
def gqa_defs(cfg: ArchConfig, cross: bool = False) -> dict:
    d, h, hkv, dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    p = {
        "wq": ParamDef((d, h * dh), axes=(None, "model")),
        "wk": ParamDef((d, hkv * dh), axes=(None, "model")),
        "wv": ParamDef((d, hkv * dh), axes=(None, "model")),
        "wo": ParamDef((h * dh, d), axes=("model", None)),
    }
    if cfg.qk_norm and not cross:
        p["q_norm"] = ParamDef((dh,), "ones", axes=(None,))
        p["k_norm"] = ParamDef((dh,), "ones", axes=(None,))
    return p


#: GQA's parallel form (leaf -> its sharded dim): q, k, v column-parallel
#: on whole heads, ``wo`` row-parallel.
GQA_WANT = {"wq": 1, "wk": 1, "wv": 1, "wo": 0}
#: MLA's: the up-projections column-parallel on whole heads, ``wo``
#: row-parallel; the down-projections and norms replicate.
MLA_WANT = {"w_uq": 1, "w_uk": 1, "w_uv": 1, "wo": 0}


def gqa_shards(cfg: ArchConfig, p: dict, tp: Optional[Shards]):
    """``(p, tp, m)`` of a GQA layer: on its shards where ``model``
    divides its KV heads (then each rank holds ``H/m`` query and
    ``H_kv/m`` KV heads, and query head ``h`` still maps to KV head
    ``h // G``), else its leaves gathered and ``tp`` None; ``m`` divides
    the head counts."""
    p, tp = on_shards(tp, p, GQA_WANT, cfg.num_kv_heads)
    return p, tp, (1 if tp is None else tp.size)


def _project_qkv(cfg: ArchConfig, p: dict, x: torch.Tensor,
                 kv_x: Optional[torch.Tensor] = None,
                 tp: Optional[Shards] = None, m: int = 1):
    """-> q (B,Sq,Hkv,G,D), k,v (B,Sk,Hkv,D); k and v from ``kv_x`` where
    it is given (cross-attention), else from ``x``. On shards (``tp``),
    the rank's ``H/m`` and ``H_kv/m`` heads."""
    b, sq, _ = x.shape
    h, hkv, dh = cfg.num_heads // m, cfg.num_kv_heads // m, cfg.head_dim
    src = x if kv_x is None else kv_x
    sk = src.shape[1]
    q = (x @ p["wq"]).reshape(b, sq, hkv, h // hkv, dh)
    k = (src @ p["wk"]).reshape(b, sk, hkv, dh)
    v = (src @ p["wv"]).reshape(b, sk, hkv, dh)
    if "q_norm" in p:
        # On shards the norms' gradients cover the rank's heads only.
        qn, kn = ((p["q_norm"], p["k_norm"]) if tp is None else
                  (tp.enter(p["q_norm"]), tp.enter(p["k_norm"])))
        q = rms_norm_headwise(q, qn)
        k = rms_norm_headwise(k, kn)
    return q, k, v


def _check_positions(name: str, positions: torch.Tensor, s: int) -> None:
    """``positions`` must be ``arange(s)``: the kernel takes query and key
    positions from their indices. The values are asserted on the device
    (``torch._assert_async``): a check that read them back would stall
    the host once per layer."""
    if tuple(positions.shape) != (s,):
        raise ValueError(f"{name}: positions of shape "
                         f"{tuple(positions.shape)} for S={s}")
    torch._assert_async(
        torch.all(positions == torch.arange(s, device=positions.device)),
        f"{name}: positions must be arange(S)")


def attention_forward(
    cfg: ArchConfig,
    p: dict,
    x: torch.Tensor,
    positions: torch.Tensor,
    causal: bool = True,
    window: Optional[int] = None,
    kv_x: Optional[torch.Tensor] = None,
    kv_positions: Optional[torch.Tensor] = None,
    tp: Optional[Shards] = None,
) -> torch.Tensor:
    """Full-sequence attention (train / prefill) through the
    ``flash_attention`` kernel.

    x: (B, S, d_model); positions: (S,), which must be ``arange(S)``.
    kv_x: (B, Sk, d_model) encoder states for cross-attention (then no
    RoPE, and the caller passes ``causal=False``); kv_positions, where
    given, must be ``arange(Sk)``. ``tp``: the ``model`` axis
    (:func:`gqa_shards`); on shards the kernel runs at the rank's heads
    and ``wo``'s partial sums are all-reduced.
    """
    b, s, _ = x.shape
    _check_positions("attention_forward", positions, s)
    if kv_positions is not None:
        _check_positions("attention_forward (kv)", kv_positions,
                         s if kv_x is None else kv_x.shape[1])
    p, tp, m = gqa_shards(cfg, p, tp)
    if tp is not None:
        x = tp.enter(x)
        kv_x = None if kv_x is None else tp.enter(kv_x)
    h, dh = cfg.num_heads // m, cfg.head_dim
    q, k, v = _project_qkv(cfg, p, x, kv_x, tp, m)
    q = q.reshape(b, s, h, dh)
    if cfg.use_rope and kv_x is None:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    out = ops.flash_attention_op(q.transpose(1, 2), k.transpose(1, 2),
                                 v.transpose(1, 2), causal=causal,
                                 window=window)          # (B, H, S, D)
    y = out.transpose(1, 2).reshape(b, s, h * dh) @ p["wo"]
    return y if tp is None else tp.exit(y)


# --------------------------------------------------------------- caches
def init_kv_cache(cfg: ArchConfig, batch: int, length: int,
                  window: Optional[int], dtype: torch.dtype,
                  device: torch.device | str, m: int = 1) -> dict:
    """Cache of one attention layer: k/v and the absolute position held
    in each slot (-1: empty); ``m``: a layer on shards holds its
    ``H_kv/m`` heads."""
    hkv, dh = cfg.num_kv_heads // m, cfg.head_dim
    size = min(length, window) if window else length
    return {
        "k": torch.zeros((batch, size, hkv, dh), dtype=dtype, device=device),
        "v": torch.zeros((batch, size, hkv, dh), dtype=dtype, device=device),
        "pos": torch.full((size,), -1, dtype=torch.int32, device=device),
    }


def kv_cache_specs(window: Optional[int], length: int,
                   long_ctx: bool) -> dict:
    """Partition specs of the cache (the reference's): long full caches
    shard the sequence dim over ``data`` (flash-decoding), windowed and
    short caches the batch; the KV heads over ``model``."""
    if window is None and long_ctx:
        return {"k": (None, "data", "model", None),
                "v": (None, "data", "model", None),
                "pos": ("data",)}
    return {"k": ("data", None, "model", None),
            "v": ("data", None, "model", None),
            "pos": (None,)}


def attention_decode(
    cfg: ArchConfig,
    p: dict,
    x_t: torch.Tensor,          # (B, 1, d_model)
    cache: dict,
    idx: int,                   # absolute position of x_t
    window: Optional[int] = None,
    tp: Optional[Shards] = None,
) -> tuple[torch.Tensor, dict]:
    """One decode step against the (possibly rolling) KV cache. Writes
    the new k/v and position into ``cache`` in place (``index_copy_``)
    and returns it. On shards (``tp``) the cache holds the rank's KV
    heads (``init_kv_cache(m=)``)."""
    b = x_t.shape[0]
    p, tp, m = gqa_shards(cfg, p, tp)
    h, hkv, dh = cfg.num_heads // m, cfg.num_kv_heads // m, cfg.head_dim
    g = h // hkv
    q, k_new, v_new = _project_qkv(cfg, p, x_t, None, tp, m)
    dev = x_t.device
    if cfg.use_rope:
        pos1 = torch.full((1,), idx, dtype=torch.int32, device=dev)
        q = apply_rope(q.reshape(b, 1, h, dh), pos1,
                       cfg.rope_theta).reshape(b, 1, hkv, g, dh)
        k_new = apply_rope(k_new, pos1, cfg.rope_theta)
    size = cache["k"].shape[1]
    slot = torch.full((1,), idx if window is None else idx % size,
                      dtype=torch.int64, device=dev)
    k = cache["k"].index_copy_(1, slot, k_new)
    v = cache["v"].index_copy_(1, slot, v_new)
    pos = cache["pos"].index_fill_(0, slot, idx)
    # Validity: slot filled, causal, and within the window if rolling.
    ok = (pos >= 0) & (pos <= idx)
    if window is not None:
        ok &= pos > idx - window
    bias = torch.where(ok, 0.0, NEG_INF)                 # (Sk,)
    scale = 1.0 / math.sqrt(dh)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", q.float(), k.float()) * scale
    w = torch.softmax(scores + bias, dim=-1).to(v.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", w, v).reshape(b, 1, h * dh)
    y = out @ p["wo"]
    return (y if tp is None else tp.exit(y)), cache


def cross_attention_cache(cfg: ArchConfig, p: dict, enc: torch.Tensor,
                          tp: Optional[Shards] = None) -> dict:
    """The encoder's k/v for the decoder's cross-attention, computed once:
    ``k``, ``v`` of shape (B, Sk, H_kv, D), the rank's ``H_kv/m`` heads
    on shards."""
    b, sk, _ = enc.shape
    p, tp, m = gqa_shards(cfg, p, tp)
    hkv, dh = cfg.num_kv_heads // m, cfg.head_dim
    return {"k": (enc @ p["wk"]).reshape(b, sk, hkv, dh),
            "v": (enc @ p["wv"]).reshape(b, sk, hkv, dh)}


def cross_attention_decode(cfg: ArchConfig, p: dict, x_t: torch.Tensor,
                           xcache: dict,
                           tp: Optional[Shards] = None) -> torch.Tensor:
    """One decode step of cross-attention against the encoder's k/v (no
    RoPE, no mask)."""
    b = x_t.shape[0]
    p, tp, m = gqa_shards(cfg, p, tp)
    h, hkv, dh = cfg.num_heads // m, cfg.num_kv_heads // m, cfg.head_dim
    q = (x_t @ p["wq"]).reshape(b, 1, hkv, h // hkv, dh)
    scale = 1.0 / math.sqrt(dh)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", q.float(),
                          xcache["k"].float()) * scale
    w = torch.softmax(scores, dim=-1).to(xcache["v"].dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", w,
                       xcache["v"]).reshape(b, 1, h * dh)
    y = out @ p["wo"]
    return y if tp is None else tp.exit(y)


# ================================================================= MLA
def mla_defs(cfg: ArchConfig) -> dict:
    m = cfg.mla
    d, h = cfg.d_model, cfg.num_heads
    qd = m.qk_nope_head_dim + m.qk_rope_head_dim
    return {
        "w_dq": ParamDef((d, m.q_lora_rank), axes=(None, None)),
        "q_norm": ParamDef((m.q_lora_rank,), "ones", axes=(None,)),
        "w_uq": ParamDef((m.q_lora_rank, h * qd), axes=(None, "model")),
        "w_dkv": ParamDef((d, m.kv_lora_rank), axes=(None, None)),
        "kv_norm": ParamDef((m.kv_lora_rank,), "ones", axes=(None,)),
        "w_uk": ParamDef((m.kv_lora_rank, h * m.qk_nope_head_dim),
                         axes=(None, "model")),
        "w_uv": ParamDef((m.kv_lora_rank, h * m.v_head_dim),
                         axes=(None, "model")),
        "w_kr": ParamDef((d, m.qk_rope_head_dim), axes=(None, None)),
        "wo": ParamDef((h * m.v_head_dim, d), axes=("model", None)),
    }


def mla_shards(cfg: ArchConfig, p: dict, tp: Optional[Shards]):
    """``(p, tp, h)`` of an MLA layer: on its shards where ``model``
    divides its heads (``h = H/m`` of them on the rank), else its leaves
    gathered, ``tp`` None and ``h = H``."""
    p, tp = on_shards(tp, p, MLA_WANT, cfg.num_heads)
    return p, tp, cfg.num_heads // (1 if tp is None else tp.size)


def _enter(tp: Optional[Shards], x: torch.Tensor) -> torch.Tensor:
    return x if tp is None else tp.enter(x)


def _mla_q(cfg: ArchConfig, p: dict, x: torch.Tensor,
           tp: Optional[Shards] = None, h: Optional[int] = None):
    """-> (q_nope, q_rope), (B, S, H, qk_nope) and (B, S, H, qk_rope); on
    shards the rank's ``h`` heads from the replicated latent ``cq``."""
    m = cfg.mla
    b, s, _ = x.shape
    qd = m.qk_nope_head_dim + m.qk_rope_head_dim
    cq = _enter(tp, rms_norm_headwise(x @ p["w_dq"], p["q_norm"]))
    q = (cq @ p["w_uq"]).reshape(b, s, h or cfg.num_heads, qd)
    return torch.split(q, [m.qk_nope_head_dim, m.qk_rope_head_dim], dim=-1)


def mla_forward(cfg: ArchConfig, p: dict, x: torch.Tensor,
                positions: torch.Tensor,
                tp: Optional[Shards] = None) -> torch.Tensor:
    """Train / prefill MLA with expanded K/V through the
    ``flash_attention`` kernel: q and k of head dim ``qk_nope +
    qk_rope``, v of ``v_head_dim``, causal, scale ``1/√(qk_nope +
    qk_rope)``. x: (B, S, d_model); positions ``arange(S)``. On shards
    (``tp``, :func:`mla_shards`) the latents and the shared rope key are
    computed whole on every rank and the heads are the rank's."""
    m = cfg.mla
    b, s, _ = x.shape
    _check_positions("mla_forward", positions, s)
    p, tp, h = mla_shards(cfg, p, tp)
    q_nope, q_rope = _mla_q(cfg, p, x, tp, h)
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    c_kv = _enter(tp, rms_norm_headwise(x @ p["w_dkv"],
                                        p["kv_norm"]))  # (B, S, dc)
    k_nope = (c_kv @ p["w_uk"]).reshape(b, s, h, m.qk_nope_head_dim)
    v = (c_kv @ p["w_uv"]).reshape(b, s, h, m.v_head_dim)
    k_rope = _enter(tp, apply_rope((x @ p["w_kr"])[:, :, None, :],
                                   positions, cfg.rope_theta))  # (B,S,1,r)
    k_rope = k_rope.expand(b, s, h, m.qk_rope_head_dim)
    q = torch.cat([q_nope, q_rope], -1)
    k = torch.cat([k_nope, k_rope], -1)
    out = ops.flash_attention_op(q.transpose(1, 2), k.transpose(1, 2),
                                 v.transpose(1, 2), causal=True)
    y = out.transpose(1, 2).reshape(b, s, h * m.v_head_dim) @ p["wo"]
    return y if tp is None else tp.exit(y)


def init_mla_cache(cfg: ArchConfig, batch: int, length: int,
                   dtype: torch.dtype, device: torch.device | str) -> dict:
    """MLA's compressed cache: the latent ``c_kv`` (B, S, kv_lora), the
    rope'd key part ``k_rope`` (B, S, rope) and each slot's position
    (-1: empty)."""
    m = cfg.mla
    return {
        "c_kv": torch.zeros((batch, length, m.kv_lora_rank), dtype=dtype,
                            device=device),
        "k_rope": torch.zeros((batch, length, m.qk_rope_head_dim),
                              dtype=dtype, device=device),
        "pos": torch.full((length,), -1, dtype=torch.int32, device=device),
    }


def mla_cache_specs(long_ctx: bool = False) -> dict:
    """Partition specs of the latent cache (the reference's): the latents
    are tiny, so the sequence shards over ``data`` at long contexts, the
    batch otherwise; nothing over ``model``."""
    if long_ctx:
        return {"c_kv": (None, "data", None),
                "k_rope": (None, "data", None),
                "pos": ("data",)}
    return {"c_kv": ("data", None, None),
            "k_rope": ("data", None, None),
            "pos": (None,)}


def mla_decode(cfg: ArchConfig, p: dict, x_t: torch.Tensor, cache: dict,
               idx: int, tp: Optional[Shards] = None
               ) -> tuple[torch.Tensor, dict]:
    """Absorbed-matrix MLA decode over the latent cache: ``W_uk`` folded
    into the query, ``W_uv`` applied after the softmax, so no K or V is
    expanded. Writes the new latents and position into ``cache`` in
    place and returns it. On shards the latent cache is whole on every
    rank (``mla_cache_specs``) and the heads are the rank's."""
    m = cfg.mla
    b = x_t.shape[0]
    p, tp, h = mla_shards(cfg, p, tp)
    dev = x_t.device
    pos1 = torch.full((1,), idx, dtype=torch.int32, device=dev)
    q_nope, q_rope = _mla_q(cfg, p, x_t, tp, h)          # (B, 1, H, *)
    q_rope = apply_rope(q_rope, pos1, cfg.rope_theta)
    c_new = rms_norm_headwise(x_t @ p["w_dkv"], p["kv_norm"])  # (B, 1, dc)
    kr_new = apply_rope((x_t @ p["w_kr"])[:, :, None, :], pos1,
                        cfg.rope_theta)[:, :, 0, :]       # (B, 1, rope)
    slot = torch.full((1,), idx, dtype=torch.int64, device=dev)
    c_kv = cache["c_kv"].index_copy_(1, slot, c_new)
    k_rope = cache["k_rope"].index_copy_(1, slot, kr_new)
    pos = cache["pos"].index_fill_(0, slot, idx)
    # Absorb W_uk into the query: q_eff[b,h,c] = sum_n q_nope w_uk[c,h,n].
    w_uk = p["w_uk"].reshape(m.kv_lora_rank, h, m.qk_nope_head_dim)
    q_eff = torch.einsum("bhn,chn->bhc", q_nope[:, 0], w_uk)
    scores = (
        torch.einsum("bhc,bsc->bhs", q_eff.float(), c_kv.float())
        + torch.einsum("bhr,bsr->bhs", q_rope[:, 0].float(), k_rope.float())
    ) / math.sqrt(m.qk_nope_head_dim + m.qk_rope_head_dim)
    ok = (pos >= 0) & (pos <= idx)
    scores = torch.where(ok[None, None, :], scores, NEG_INF)
    w = torch.softmax(scores, dim=-1)
    ctx = torch.einsum("bhs,bsc->bhc", w, c_kv.float())
    w_uv = p["w_uv"].reshape(m.kv_lora_rank, h, m.v_head_dim)
    out = torch.einsum("bhc,chv->bhv", ctx, w_uv.float())
    y = out.reshape(b, 1, h * m.v_head_dim).to(x_t.dtype) @ p["wo"]
    return (y if tp is None else tp.exit(y)), cache
