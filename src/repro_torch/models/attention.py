"""Attention of the LM zoo (port of ``repro.models.attention``): GQA with
qk-norm, RoPE and an optional sliding window.

Train / prefill (:func:`attention_forward`) runs the ``flash_attention``
kernel (``repro_torch.kernels``) on the projected, rope'd q/k/v — the
function the JAX package computes with its blockwise ``_sdpa`` loop
(``repro/models/attention.py:113-133``), which ``tests/test_kernels.py``
holds equal to the Pallas flash kernel. The ``(B, S, H, D)`` layout is
kept: the kernel takes q, k and v as transposed views, no copies. Query
head ``h = hkv·G + g``, as ``reshape(b, s, hkv, g, dh)`` orders it,
which is the kernel's ``h // G`` map.

Decode (:func:`attention_decode`) attends one query token against a KV
cache with plain einsums and a softmax, as the JAX package does:

- full cache: k/v ``(B, S_max, H_kv, D)``;
- sliding window: a rolling cache ``(B, W, H_kv, D)`` plus the absolute
  position of each slot.

Unlike the JAX package, the cache is updated in place (``index_copy_``):
no copy of the cache per step.

MLA, cross-attention and ``kv_x`` are not ported yet (ROADMAP Queue A
item 13) and raise ``NotImplementedError``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import apply_rope, rms_norm_headwise
from repro_torch.models.params import ParamDef

NEG_INF = -1e30
_NOT_PORTED = "not ported yet (ROADMAP Queue A item 13)"


# ================================================================= GQA
def gqa_defs(cfg: ArchConfig, cross: bool = False) -> dict:
    if cross:
        raise NotImplementedError(f"cross-attention is {_NOT_PORTED}")
    d, h, hkv, dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    p = {
        "wq": ParamDef((d, h * dh)),
        "wk": ParamDef((d, hkv * dh)),
        "wv": ParamDef((d, hkv * dh)),
        "wo": ParamDef((h * dh, d)),
    }
    if cfg.qk_norm:
        p["q_norm"] = ParamDef((dh,), "ones")
        p["k_norm"] = ParamDef((dh,), "ones")
    return p


def _project_qkv(cfg: ArchConfig, p: dict, x: torch.Tensor,
                 kv_x: Optional[torch.Tensor] = None):
    """-> q (B,Sq,Hkv,G,D), k,v (B,Sk,Hkv,D)."""
    if kv_x is not None:
        raise NotImplementedError(f"attention over kv_x is {_NOT_PORTED}")
    b, s, _ = x.shape
    h, hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = (x @ p["wq"]).reshape(b, s, hkv, h // hkv, dh)
    k = (x @ p["wk"]).reshape(b, s, hkv, dh)
    v = (x @ p["wv"]).reshape(b, s, hkv, dh)
    if "q_norm" in p:
        q = rms_norm_headwise(q, p["q_norm"])
        k = rms_norm_headwise(k, p["k_norm"])
    return q, k, v


def attention_forward(
    cfg: ArchConfig,
    p: dict,
    x: torch.Tensor,
    positions: torch.Tensor,
    causal: bool = True,
    window: Optional[int] = None,
    kv_x: Optional[torch.Tensor] = None,
    kv_positions: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Full-sequence attention (train / prefill) through the
    ``flash_attention`` kernel.

    x: (B, S, d_model); positions: (S,), which must be ``arange(S)``: the
    kernel takes query and key positions from their indices. The values
    are asserted on the device (``torch._assert_async``): a check that
    read them back would stall the host once per layer.
    """
    if kv_x is not None or kv_positions is not None:
        raise NotImplementedError(f"cross-attention is {_NOT_PORTED}")
    b, s, _ = x.shape
    if tuple(positions.shape) != (s,):
        raise ValueError(f"attention_forward: positions of shape "
                         f"{tuple(positions.shape)} for S={s}")
    torch._assert_async(
        torch.all(positions == torch.arange(s, device=positions.device)),
        "attention_forward: positions must be arange(S)")
    h, dh = cfg.num_heads, cfg.head_dim
    q, k, v = _project_qkv(cfg, p, x)
    q = q.reshape(b, s, h, dh)
    if cfg.use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    out = ops.flash_attention_op(q.transpose(1, 2), k.transpose(1, 2),
                                 v.transpose(1, 2), causal=causal,
                                 window=window)          # (B, H, S, D)
    return out.transpose(1, 2).reshape(b, s, h * dh) @ p["wo"]


# --------------------------------------------------------------- caches
def init_kv_cache(cfg: ArchConfig, batch: int, length: int,
                  window: Optional[int], dtype: torch.dtype,
                  device: torch.device | str) -> dict:
    """Cache of one attention layer: k/v and the absolute position held
    in each slot (-1: empty)."""
    hkv, dh = cfg.num_kv_heads, cfg.head_dim
    size = min(length, window) if window else length
    return {
        "k": torch.zeros((batch, size, hkv, dh), dtype=dtype, device=device),
        "v": torch.zeros((batch, size, hkv, dh), dtype=dtype, device=device),
        "pos": torch.full((size,), -1, dtype=torch.int32, device=device),
    }


def attention_decode(
    cfg: ArchConfig,
    p: dict,
    x_t: torch.Tensor,          # (B, 1, d_model)
    cache: dict,
    idx: int,                   # absolute position of x_t
    window: Optional[int] = None,
) -> tuple[torch.Tensor, dict]:
    """One decode step against the (possibly rolling) KV cache. Writes
    the new k/v and position into ``cache`` in place (``index_copy_``)
    and returns it."""
    b = x_t.shape[0]
    h, hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    g = h // hkv
    q, k_new, v_new = _project_qkv(cfg, p, x_t)
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
    return out @ p["wo"], cache
