"""Mamba selective-SSM block, jamba's mixer (port of ``repro.models.ssm``).

Prefill (:func:`mamba_forward`) runs the recurrence through the
``selective_scan`` kernel (``repro_torch.kernels``): the function the JAX
package computes with its chunked associative scan
(``_ssm_scan_chunked``, ``repro/models/ssm.py:48-89``) and its Pallas
kernel with a sequential loop. Both keep the state in f32 and return
bx's dtype, as the kernel does. Unlike the JAX model's scan, the kernel
takes any S (no ``S % chunk`` precondition).

``abar = exp(dt·A)`` is formed in place (``exp_`` on the f32 product):
at the jamba prefill shape (4 x 4096 tokens, 8192 channels, 16 states)
the product is 8.6 GB, and a second f32 temporary of that size would
leave the one-period model too little room on one card. Under autograd
that stays valid: the product's own backward saves dt and A, not the
product, and ``exp_``'s backward saves its output, which is the abar
that ``SelectiveScanFn`` saves too; nothing writes abar afterwards.
Under grad (training) the scan's wrapper applies ``SelectiveScanFn``:
the same forward kernel, storing the state every 8 steps, and the
backward kernel ``csrc/selective_scan_bwd.cu`` on those checkpoints for
d abar, d bx and dc (dc in c's shape; c is a view of ``x_proj``'s
output).

Decode (:func:`mamba_decode`) is the O(1) recurrence with plain
einsums, as the JAX package's (``repro/models/ssm.py:129-151``),
including its cast of the f32 state to the activation dtype before the
output einsum. Unlike the JAX package, it updates the cache (``h`` and
the conv window) in place. ``mamba_cache_specs`` (the mesh layout) waits
for ROADMAP Queue A item 19.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.models.params import ParamDef


def mamba_defs(cfg: ArchConfig) -> dict:
    d = cfg.d_model
    di = cfg.d_inner_mamba
    m = cfg.mamba
    dtr = cfg.dt_rank
    return {
        "in_proj": ParamDef((d, 2 * di)),
        "conv_w": ParamDef((m.d_conv, di), scale=0.5),
        "conv_b": ParamDef((di,), "zeros"),
        "x_proj": ParamDef((di, dtr + 2 * m.d_state)),
        "dt_proj": ParamDef((dtr, di)),
        "dt_bias": ParamDef((di,), "constant", scale=-4.6),
        # A = -exp(A_log); init A_log = log(1..N) per state (S4D-real).
        "a_log": ParamDef((di, m.d_state), "s4d_a_log"),
        "d_skip": ParamDef((di,), "ones"),
        "out_proj": ParamDef((di, d)),
    }


def _conv1d_causal(x: torch.Tensor, w: torch.Tensor,
                   b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv. x: (B, S, di), w: (K, di); the taps summed
    in the JAX package's order."""
    k, s = w.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, k - 1, 0))
    # sum_j w[j] * x[t - (K-1) + j]
    out = torch.zeros_like(x)
    for j in range(k):
        out = out + pad[:, j:j + s, :] * w[j]
    return out + b


def _split_dbc(cfg: ArchConfig, dbc: torch.Tensor):
    """x_proj's output -> (dt_raw, B_t, C_t), views of it."""
    n = cfg.mamba.d_state
    return dbc.split([cfg.dt_rank, n, n], dim=-1)


def mamba_forward(cfg: ArchConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    """Full-sequence Mamba mixer. x: (B, S, d_model)."""
    xz = x @ p["in_proj"]
    x_in, z = xz.chunk(2, dim=-1)
    x_c = F.silu(_conv1d_causal(x_in, p["conv_w"], p["conv_b"]))
    dt_raw, b_t, c_t = _split_dbc(cfg, x_c @ p["x_proj"])
    dt = F.softplus(dt_raw @ p["dt_proj"] + p["dt_bias"])       # (B,S,di)
    a = -torch.exp(p["a_log"].float())                          # (di,N)
    abar = (dt[..., None] * a).exp_()                   # (B,S,di,N) f32
    bx = (dt * x_c)[..., None] * b_t[:, :, None, :]             # (B,S,di,N)
    y = ops.selective_scan_op(abar, bx, c_t, chunk=cfg.mamba.chunk)
    del abar, bx
    y = y + p["d_skip"] * x_c
    return (y * F.silu(z)) @ p["out_proj"]


def init_mamba_cache(cfg: ArchConfig, batch: int, dtype: torch.dtype,
                     device: torch.device | str) -> dict:
    """Decode state of one Mamba layer: ``h`` (B, di, N) f32 and the conv
    window ``conv`` (B, d_conv, di) in the activation dtype."""
    m = cfg.mamba
    di = cfg.d_inner_mamba
    return {
        "h": torch.zeros((batch, di, m.d_state), dtype=torch.float32,
                         device=device),
        "conv": torch.zeros((batch, m.d_conv, di), dtype=dtype,
                            device=device),
    }


def mamba_decode(cfg: ArchConfig, p: dict, x_t: torch.Tensor,
                 cache: dict) -> tuple[torch.Tensor, dict]:
    """One decode step. x_t: (B, 1, d_model). Shifts the conv window and
    advances ``h`` in ``cache`` in place and returns it."""
    xz = x_t[:, 0] @ p["in_proj"]
    x_in, z = xz.chunk(2, dim=-1)                              # (B, di)
    conv = cache["conv"]
    conv.copy_(torch.cat([conv[:, 1:], x_in[:, None]], dim=1))
    x_c = F.silu(torch.einsum("bkd,kd->bd", conv, p["conv_w"])
                 + p["conv_b"])
    dt_raw, b_t, c_t = _split_dbc(cfg, x_c @ p["x_proj"])
    dt = F.softplus(dt_raw @ p["dt_proj"] + p["dt_bias"])      # (B, di)
    a = -torch.exp(p["a_log"].float())
    abar = torch.exp(dt[..., None] * a)                        # (B, di, N)
    h = cache["h"]
    h.copy_(abar * h + ((dt * x_c)[..., None] * b_t[:, None, :]).float())
    y = torch.einsum("bdn,bn->bd", h.to(x_t.dtype), c_t)
    y = y + p["d_skip"] * x_c
    out = (y * F.silu(z)) @ p["out_proj"]
    return out[:, None], cache
