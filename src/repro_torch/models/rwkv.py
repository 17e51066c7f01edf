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
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.models.params import ParamDef

_STREAMS = 5  # r, k, v, w, g


def rwkv_defs(cfg: ArchConfig) -> dict:
    d = cfg.d_model
    r = cfg.rwkv
    return {
        "mu": ParamDef((_STREAMS, d), "normal", scale=0.02),
        "mix_w1": ParamDef((d, _STREAMS * r.lora_rank_mix), scale=0.02),
        "mix_w2": ParamDef((_STREAMS, r.lora_rank_mix, d), scale=0.02),
        "w_r": ParamDef((d, d)),
        "w_k": ParamDef((d, d)),
        "w_v": ParamDef((d, d)),
        "w_g": ParamDef((d, d)),
        "w_o": ParamDef((d, d)),
        "decay_base": ParamDef((d,), "constant", scale=-6.0),
        "decay_w1": ParamDef((d, r.lora_rank_decay), scale=0.02),
        "decay_w2": ParamDef((r.lora_rank_decay, d), scale=0.02),
        "bonus_u": ParamDef((d,), "constant", scale=0.5),
        "ln_scale": ParamDef((d,), "ones"),
        "ln_bias": ParamDef((d,), "zeros"),
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


def _decay(p: dict, xw: torch.Tensor) -> torch.Tensor:
    """w_t in (0,1): exp(-exp(base + lora(xw))), f32. xw: (B,S,d)."""
    wx = p["decay_base"] + torch.tanh(xw @ p["decay_w1"]) @ p["decay_w2"]
    return torch.exp(-torch.exp(wx.float()))


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


def rwkv_time_mix(cfg: ArchConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    """Full-sequence time-mix through the ``rwkv6_wkv`` kernel.
    x: (B, S, d).

    As the JAX function, S must be a multiple of ``min(chunk, S)``, so
    the port fails where the JAX model fails, though the kernel itself
    takes any S. The JAX function's ``x_prev_last``, ``s0`` and
    ``unroll_chunks`` are not taken: the stack never passes them, and the
    kernel's state starts at zero as the TPU kernel's does."""
    r_cfg = cfg.rwkv
    b, s, d = x.shape
    h, n = cfg.rwkv_heads, r_cfg.head_size
    chunk = min(r_cfg.chunk, s)
    assert s % chunk == 0, (s, chunk)
    xr, xk, xv, xw, xg = _ddlerp(p, x, _shift(x))
    r = (xr @ p["w_r"]).reshape(b, s, h, n)
    k = (xk @ p["w_k"]).reshape(b, s, h, n)
    v = (xv @ p["w_v"]).reshape(b, s, h, n)
    g = F.silu(xg @ p["w_g"])
    w = _decay(p, xw).reshape(b, s, h, n)
    u = p["bonus_u"].reshape(h, n).float()
    y = ops.rwkv6_wkv_op(r.transpose(1, 2), k.transpose(1, 2),
                         v.transpose(1, 2), w.transpose(1, 2), u,
                         chunk=chunk)                    # (B, H, S, N)
    y = y.transpose(1, 2).reshape(b, s, d)
    y = _group_norm(y, p["ln_scale"], p["ln_bias"], h)
    return (y * g) @ p["w_o"]


def channel_mix_defs(cfg: ArchConfig) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "mu_k": ParamDef((d,), "constant", scale=0.5),
        "mu_r": ParamDef((d,), "constant", scale=0.5),
        "w_k": ParamDef((d, f)),
        "w_v": ParamDef((f, d)),
        "w_r": ParamDef((d, d)),
    }


def _channel_mix(p: dict, x: torch.Tensor,
                 x_prev: torch.Tensor) -> torch.Tensor:
    xk = x + (x_prev - x) * p["mu_k"]
    xr = x + (x_prev - x) * p["mu_r"]
    k = torch.square(torch.relu(xk @ p["w_k"]))
    return torch.sigmoid(xr @ p["w_r"]) * (k @ p["w_v"])


def rwkv_channel_mix(cfg: ArchConfig, p: dict,
                     x: torch.Tensor) -> torch.Tensor:
    """RWKV FFN with token shift and squared-relu. x: (B, S, d)."""
    return _channel_mix(p, x, _shift(x))


def init_rwkv_cache(cfg: ArchConfig, batch: int, dtype: torch.dtype,
                    device: torch.device | str) -> dict:
    """Decode state of one RWKV layer: the wkv state in f32 and the two
    token-shift states in the activation dtype; its size does not depend
    on the sequence length."""
    h, n = cfg.rwkv_heads, cfg.rwkv.head_size
    d = cfg.d_model
    return {
        "s": torch.zeros((batch, h, n, n), dtype=torch.float32,
                         device=device),
        "x_prev_tm": torch.zeros((batch, d), dtype=dtype, device=device),
        "x_prev_cm": torch.zeros((batch, d), dtype=dtype, device=device),
    }


def rwkv_decode(cfg: ArchConfig, p: dict, x_t: torch.Tensor,
                cache: dict) -> tuple[torch.Tensor, dict]:
    """One token through time-mix. x_t: (B, 1, d). Updates ``cache["s"]``
    and ``cache["x_prev_tm"]`` in place (``copy_``, so views of a stacked
    cache update the stack) and returns (y_time_mix (B, 1, d), cache). The
    stack applies norms and residuals and calls
    :func:`rwkv_channel_mix_decode` itself (the JAX function's unused
    channel-mix params are not taken)."""
    b, _, d = x_t.shape
    h, n = cfg.rwkv_heads, cfg.rwkv.head_size
    x = x_t[:, 0]
    xs = _ddlerp(p, x[:, None], cache["x_prev_tm"][:, None])  # (5,B,1,d)
    xr, xk, xv, xw, xg = (a[:, 0] for a in xs)
    r = (xr @ p["w_r"]).reshape(b, h, n).float()
    k = (xk @ p["w_k"]).reshape(b, h, n).float()
    v = (xv @ p["w_v"]).reshape(b, h, n).float()
    g = F.silu(xg @ p["w_g"])
    w = _decay(p, xw[:, None])[:, 0].reshape(b, h, n)
    u = p["bonus_u"].reshape(h, n).float()
    s = cache["s"]
    kv = torch.einsum("bhn,bhm->bhnm", k, v)
    y = torch.einsum("bhn,bhnm->bhm", r, s + u[None, :, :, None] * kv)
    s.copy_(w[..., None] * s + kv)
    cache["x_prev_tm"].copy_(x)
    y = y.reshape(b, 1, d).to(x_t.dtype)
    y = _group_norm(y, p["ln_scale"], p["ln_bias"], h)
    return (y * g[:, None]) @ p["w_o"], cache


def rwkv_channel_mix_decode(cfg: ArchConfig, p: dict, x_t: torch.Tensor,
                            x_prev: torch.Tensor) -> torch.Tensor:
    """Channel mix of one token x_t (B, 1, d) against the previous normed
    input x_prev (B, d) -> (B, 1, d)."""
    return _channel_mix(p, x_t[:, 0], x_prev)[:, None]
