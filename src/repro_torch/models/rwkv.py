"""RWKV-6 ("Finch") time-mix and channel-mix blocks (port of
``repro.models.rwkv``).

Data-dependent per-channel decay: the wkv state S (per head,
head_size x head_size) evolves as

    y_t = r_tᵀ (S_{t-1} + diag(u) k_t v_tᵀ)
    S_t = diag(w_t) S_{t-1} + k_t v_tᵀ,    w_t = exp(-exp(wx_t))

with token-shift dynamic mixing (ddlerp) producing the r/k/v/w/g streams.

Prefill (:func:`rwkv_time_mix`) runs the whole sequence through the
``rwkv6_wkv`` kernel (``repro_torch.kernels``), one launch per layer:
the exact sequential recurrence of the TPU kernel and of
``ref.rwkv6_wkv_ref``. The JAX model computes it instead with the
prefix-product chunked form ``_wkv_chunk``, which clamps the log decay
at -60 inside a chunk and departs from the recurrence once a chunk's
cumulative decay passes it (ROADMAP Queue C); at decays like the
init's the two agree. The ``(B, S, H, N)`` projections go into the
kernel as transposed views, no copies, and w stays f32 as ``_decay``
makes it. Under grad (training) the wrapper applies ``RwkvWkvFn``: the
same forward kernel, storing the backward's checkpoints as well, and the
backward kernel ``csrc/rwkv6_wkv_bwd.cu`` for dr, dk, dv, dw and du;
with remat (``cfg.remat``) each layer's forward kernel runs once more in
the backward, and the backward reads that run's checkpoints.

Decode (:func:`rwkv_decode`) carries (S, x_prev) — O(1) per token — and
updates the cache in place (``copy_``).

Dtypes follow the JAX package step by step: the token shift, the LoRA
sums and the projections run in the activation dtype; the decay is
summed there and only then cast to f32 for ``exp(-exp(.))``; the group
norm is per head in f32 with eps 1e-5.

Over the mesh's ``model`` axis (``tp``, ``models/sharding.py``) the time
mix runs on the rank's ``H/m`` heads: ``w_r``, ``w_k``, ``w_v`` and
``w_g`` column-parallel, ``decay_w2`` sharded on ``d``, ``decay_base``,
``bonus_u``, ``ln_scale`` and ``ln_bias`` replicated but sliced to the
rank's channels, the WKV kernels at ``H/m`` heads and ``w_o``
row-parallel. ``mix_w2`` (sharded on ``d`` by its spec) is gathered at
use: the token shift's five streams feed the column-parallel
projections whole. In the channel mix ``w_k`` is column-parallel and
``w_v`` row-parallel; the receptance ``w_r`` (column-parallel by its
spec) is gathered at use, since it gates ``w_v``'s output, which is
whole after its all-reduce. :func:`rwkv_cache_specs` gives the decode
state's layout (the rank's heads of ``s``).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.models.params import ParamDef
from repro_torch.models.sharding import Shards, on_shards

_STREAMS = 5  # r, k, v, w, g

#: The time mix's parallel form (leaf -> its sharded dim) and the
#: channel mix's.
TIME_MIX_WANT = {"w_r": 1, "w_k": 1, "w_v": 1, "w_g": 1, "w_o": 0,
                 "decay_w2": 1}
CHANNEL_MIX_WANT = {"w_k": 1, "w_v": 0}


def rwkv_defs(cfg: ArchConfig) -> dict:
    d = cfg.d_model
    r = cfg.rwkv
    return {
        "mu": ParamDef((_STREAMS, d), "normal", scale=0.02,
                       axes=(None, None)),
        "mix_w1": ParamDef((d, _STREAMS * r.lora_rank_mix), scale=0.02,
                           axes=(None, None)),
        "mix_w2": ParamDef((_STREAMS, r.lora_rank_mix, d), scale=0.02,
                           axes=(None, None, "model")),
        "w_r": ParamDef((d, d), axes=(None, "model")),
        "w_k": ParamDef((d, d), axes=(None, "model")),
        "w_v": ParamDef((d, d), axes=(None, "model")),
        "w_g": ParamDef((d, d), axes=(None, "model")),
        "w_o": ParamDef((d, d), axes=("model", None)),
        "decay_base": ParamDef((d,), "constant", scale=-6.0, axes=(None,)),
        "decay_w1": ParamDef((d, r.lora_rank_decay), scale=0.02,
                             axes=(None, None)),
        "decay_w2": ParamDef((r.lora_rank_decay, d), scale=0.02,
                             axes=(None, "model")),
        "bonus_u": ParamDef((d,), "constant", scale=0.5, axes=(None,)),
        "ln_scale": ParamDef((d,), "ones", axes=(None,)),
        "ln_bias": ParamDef((d,), "zeros", axes=(None,)),
    }


def _ddlerp(p: dict, x: torch.Tensor, x_prev: torch.Tensor) -> torch.Tensor:
    """Dynamic token-shift: five mixed streams. -> (5, B, S, d)."""
    lxx = x_prev - x
    xxx = x + lxx * p["mu"][3]             # w-stream mu as probe (RWKV6)
    probe = torch.tanh(xxx @ p["mix_w1"])  # (B, S, 5*rank)
    b, s, _ = x.shape
    probe = probe.reshape(b, s, _STREAMS, -1)
    dyn = torch.einsum("bsfr,frd->fbsd", probe, p["mix_w2"])
    return x[None] + lxx[None] * (p["mu"][:, None, None] + dyn)


def _decay(p: dict, xw: torch.Tensor,
           tp: Optional[Shards] = None) -> torch.Tensor:
    """w_t in (0,1): exp(-exp(base + lora(xw))), f32. xw: (B,S,d); on
    shards the rank's channels."""
    lora = torch.tanh(xw @ p["decay_w1"])
    if tp is None:
        return torch.exp(-torch.exp((p["decay_base"]
                                     + lora @ p["decay_w2"]).float()))
    wx = tp.local(p["decay_base"]) + tp.enter(lora) @ p["decay_w2"]
    return torch.exp(-torch.exp(wx.float()))


def time_mix_shards(cfg: ArchConfig, p: dict, tp: Optional[Shards]):
    """``(p, tp, h)`` of a time mix: on its shards where ``model`` divides
    its heads (``h = H/m`` on the rank; ``mix_w2`` gathered), else its
    leaves gathered, ``tp`` None and ``h = H``."""
    p, tp = on_shards(tp, p, TIME_MIX_WANT, cfg.rwkv_heads)
    if tp is None:
        return p, None, cfg.rwkv_heads
    return ({**p, "mix_w2": tp.gather_leaf(p, "mix_w2")}, tp,
            cfg.rwkv_heads // tp.size)


def _heads_leaves(p: dict, tp: Optional[Shards], h: int, n: int):
    """``u`` (h, n) f32 and the group norm's scale and bias: the rank's
    channels on shards."""
    if tp is None:
        return p["bonus_u"].reshape(h, n).float(), p["ln_scale"], \
            p["ln_bias"]
    return (tp.local(p["bonus_u"]).reshape(h, n).float(),
            tp.local(p["ln_scale"]), tp.local(p["ln_bias"]))


def _group_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                heads: int, eps: float = 1e-5) -> torch.Tensor:
    """Per-head layernorm on (B, S, d) grouped into heads, in f32."""
    b, s, d = x.shape
    xg = x.reshape(b, s, heads, d // heads).float()
    mu = xg.mean(-1, keepdim=True)
    var = xg.var(-1, keepdim=True, unbiased=False)
    xg = (xg - mu) * torch.rsqrt(var + eps)
    return (xg.reshape(b, s, d) * scale + bias).to(x.dtype)


def _shift(x: torch.Tensor) -> torch.Tensor:
    """x_prev of a sequence with no cache: zeros at position 0."""
    return torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], dim=1)


def _streams(p: dict, x: torch.Tensor, x_prev: torch.Tensor,
             tp: Optional[Shards]):
    """The five token-shift streams; on shards the four that feed the
    column-parallel projections through one :meth:`~Shards.enter` (the
    decay's LoRA reads ``xw`` whole)."""
    xs = _ddlerp(p, x, x_prev)
    xw = xs[3]
    if tp is not None:
        xs = tp.enter(xs)
    return xs[0], xs[1], xs[2], xw, xs[4]


def rwkv_time_mix(cfg: ArchConfig, p: dict, x: torch.Tensor,
                  tp: Optional[Shards] = None) -> torch.Tensor:
    """Full-sequence time-mix through the ``rwkv6_wkv`` kernel.
    x: (B, S, d); ``tp``: the ``model`` axis (:func:`time_mix_shards`).

    As the JAX function, S must be a multiple of ``min(chunk, S)``, so
    the port fails where the JAX model fails, though the kernel itself
    takes any S. The JAX function's ``x_prev_last``, ``s0`` and
    ``unroll_chunks`` are not taken: the stack never passes them, and the
    kernel's state starts at zero as the TPU kernel's does."""
    r_cfg = cfg.rwkv
    b, s, _ = x.shape
    p, tp, h = time_mix_shards(cfg, p, tp)
    n = r_cfg.head_size
    chunk = min(r_cfg.chunk, s)
    assert s % chunk == 0, (s, chunk)
    xr, xk, xv, xw, xg = _streams(p, x, _shift(x), tp)
    r = (xr @ p["w_r"]).reshape(b, s, h, n)
    k = (xk @ p["w_k"]).reshape(b, s, h, n)
    v = (xv @ p["w_v"]).reshape(b, s, h, n)
    g = F.silu(xg @ p["w_g"])
    w = _decay(p, xw, tp).reshape(b, s, h, n)
    u, ln_scale, ln_bias = _heads_leaves(p, tp, h, n)
    y = ops.rwkv6_wkv_op(r.transpose(1, 2), k.transpose(1, 2),
                         v.transpose(1, 2), w.transpose(1, 2), u,
                         chunk=chunk)                    # (B, H, S, N)
    y = y.transpose(1, 2).reshape(b, s, h * n)
    y = _group_norm(y, ln_scale, ln_bias, h)
    out = (y * g) @ p["w_o"]
    return out if tp is None else tp.exit(out)


def channel_mix_defs(cfg: ArchConfig) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "mu_k": ParamDef((d,), "constant", scale=0.5, axes=(None,)),
        "mu_r": ParamDef((d,), "constant", scale=0.5, axes=(None,)),
        "w_k": ParamDef((d, f), axes=(None, "model")),
        "w_v": ParamDef((f, d), axes=("model", None)),
        "w_r": ParamDef((d, d), axes=(None, "model")),
    }


def _channel_mix(p: dict, x: torch.Tensor, x_prev: torch.Tensor,
                 tp: Optional[Shards] = None) -> torch.Tensor:
    """On shards: ``w_k`` / ``w_v`` on the rank's ``d_ff/m`` and an
    all-reduce; ``w_r`` gathered (see the module's text)."""
    p, tp = on_shards(tp, p, CHANNEL_MIX_WANT)
    xk = x + (x_prev - x) * p["mu_k"]
    xr = x + (x_prev - x) * p["mu_r"]
    if tp is None:
        k = torch.square(torch.relu(xk @ p["w_k"]))
        return torch.sigmoid(xr @ p["w_r"]) * (k @ p["w_v"])
    k = torch.square(torch.relu(tp.enter(xk) @ p["w_k"]))
    return (torch.sigmoid(xr @ tp.gather_leaf(p, "w_r"))
            * tp.exit(k @ p["w_v"]))


def rwkv_channel_mix(cfg: ArchConfig, p: dict, x: torch.Tensor,
                     tp: Optional[Shards] = None) -> torch.Tensor:
    """RWKV FFN with token shift and squared-relu. x: (B, S, d)."""
    return _channel_mix(p, x, _shift(x), tp)


def init_rwkv_cache(cfg: ArchConfig, batch: int, dtype: torch.dtype,
                    device: torch.device | str, m: int = 1) -> dict:
    """Decode state of one RWKV layer: the wkv state in f32 and the two
    token-shift states in the activation dtype; its size does not depend
    on the sequence length. ``m``: a time mix on shards holds its
    ``H/m`` heads of the state."""
    h, n = cfg.rwkv_heads // m, cfg.rwkv.head_size
    d = cfg.d_model
    return {
        "s": torch.zeros((batch, h, n, n), dtype=torch.float32,
                         device=device),
        "x_prev_tm": torch.zeros((batch, d), dtype=dtype, device=device),
        "x_prev_cm": torch.zeros((batch, d), dtype=dtype, device=device),
    }


def rwkv_cache_specs() -> dict:
    """Partition specs of the decode state (the reference's): the batch
    over ``data``, the wkv state's heads over ``model``."""
    return {"s": ("data", "model", None, None),
            "x_prev_tm": ("data", None),
            "x_prev_cm": ("data", None)}


def rwkv_decode(cfg: ArchConfig, p: dict, x_t: torch.Tensor,
                cache: dict, tp: Optional[Shards] = None
                ) -> tuple[torch.Tensor, dict]:
    """One token through time-mix. x_t: (B, 1, d). Updates ``cache["s"]``
    and ``cache["x_prev_tm"]`` in place (``copy_``, so views of a stacked
    cache update the stack) and returns (y_time_mix (B, 1, d), cache). The
    stack applies norms and residuals and calls
    :func:`rwkv_channel_mix_decode` itself (the JAX function's unused
    channel-mix params are not taken)."""
    b = x_t.shape[0]
    p, tp, h = time_mix_shards(cfg, p, tp)
    n = cfg.rwkv.head_size
    x = x_t[:, 0]
    xs = _streams(p, x[:, None], cache["x_prev_tm"][:, None], tp)
    xr, xk, xv, xw, xg = (a[:, 0] for a in xs)
    r = (xr @ p["w_r"]).reshape(b, h, n).float()
    k = (xk @ p["w_k"]).reshape(b, h, n).float()
    v = (xv @ p["w_v"]).reshape(b, h, n).float()
    g = F.silu(xg @ p["w_g"])
    w = _decay(p, xw[:, None], tp)[:, 0].reshape(b, h, n)
    u, ln_scale, ln_bias = _heads_leaves(p, tp, h, n)
    s = cache["s"]
    kv = torch.einsum("bhn,bhm->bhnm", k, v)
    y = torch.einsum("bhn,bhnm->bhm", r, s + u[None, :, :, None] * kv)
    s.copy_(w[..., None] * s + kv)
    cache["x_prev_tm"].copy_(x)
    y = y.reshape(b, 1, h * n).to(x_t.dtype)
    y = _group_norm(y, ln_scale, ln_bias, h)
    out = (y * g[:, None]) @ p["w_o"]
    return (out if tp is None else tp.exit(out)), cache


def rwkv_channel_mix_decode(cfg: ArchConfig, p: dict, x_t: torch.Tensor,
                            x_prev: torch.Tensor,
                            tp: Optional[Shards] = None) -> torch.Tensor:
    """Channel mix of one token x_t (B, 1, d) against the previous normed
    input x_prev (B, d) -> (B, 1, d)."""
    return _channel_mix(p, x_t[:, 0], x_prev, tp)[:, None]
