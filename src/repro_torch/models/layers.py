"""Shared layers of the LM zoo (port of ``repro.models.layers``): norms,
rotary embeddings, MLPs, embedding tables.

Same arithmetic as the JAX package: norms and rotary embeddings compute
in f32 and cast back to the input's dtype; matmuls run in the operands'
dtype. Param defs are flat dicts (``{"scale": ParamDef}``); a block
nests them under ``/``-joined keys.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.params import ParamDef


# ---------------------------------------------------------------- norms
def norm_def(d: int, kind: str) -> dict:
    if kind == "rmsnorm":
        return {"scale": ParamDef((d,), "ones")}
    if kind == "layernorm":
        return {"scale": ParamDef((d,), "ones"),
                "bias": ParamDef((d,), "zeros")}
    raise ValueError(kind)


def apply_norm(p: dict, x: torch.Tensor, kind: str,
               eps: float = 1e-6) -> torch.Tensor:
    """``p`` holds ``scale`` (and ``bias`` for layernorm)."""
    xf = x.float()
    if kind == "rmsnorm":
        var = (xf * xf).mean(-1, keepdim=True)
        out = xf * torch.rsqrt(var + eps) * p["scale"].float()
    else:
        mu = xf.mean(-1, keepdim=True)
        var = xf.var(-1, keepdim=True, unbiased=False)
        out = (xf - mu) * torch.rsqrt(var + eps)
        out = out * p["scale"].float() + p["bias"].float()
    return out.to(x.dtype)


def rms_norm_headwise(x: torch.Tensor, scale: torch.Tensor,
                      eps: float = 1e-6) -> torch.Tensor:
    """qk-norm: RMS-normalize the last (head) dim (Qwen3-style)."""
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


# ---------------------------------------------------------------- rope
def rope_freqs(head_dim: int, theta: float,
               device: torch.device | str = "cpu") -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (seq,). The half-split
    rotation ``[x1·cos − x2·sin, x1·sin + x2·cos]`` in f32."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                 # (d/2,)
    angles = positions[:, None].float() * freqs            # (S, d/2)
    cos = torch.cos(angles)[:, None, :]                    # (S, 1, d/2)
    sin = torch.sin(angles)[:, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------- mlp
def mlp_def(d_model: int, d_ff: int, act: str) -> dict:
    p = {"w_down": ParamDef((d_ff, d_model)),
         "w_up": ParamDef((d_model, d_ff))}
    if act == "silu":  # gated (SwiGLU)
        p["w_gate"] = ParamDef((d_model, d_ff))
    return p


def apply_mlp(p: dict, x: torch.Tensor, act: str) -> torch.Tensor:
    up = x @ p["w_up"]
    if act == "silu":
        up = F.silu(x @ p["w_gate"]) * up
    elif act == "gelu":
        # jax.nn.gelu defaults to the tanh approximation.
        up = F.gelu(up, approximate="tanh")
    else:
        raise ValueError(act)
    return up @ p["w_down"]


# ---------------------------------------------------------------- embed
def embed_def(vocab: int, d_model: int) -> dict:
    return {"table": ParamDef((vocab, d_model), scale=0.02)}


def apply_embed(p: dict, tokens: torch.Tensor) -> torch.Tensor:
    return p["table"][tokens]


def unembed(table: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Logits via the (possibly tied) embedding table: (..., d) -> (..., V)."""
    return x @ table.T
