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
from repro_torch.models.sharding import Shards, on_shards


# ---------------------------------------------------------------- norms
def norm_def(d: int, kind: str) -> dict:
    if kind == "rmsnorm":
        return {"scale": ParamDef((d,), "ones", axes=(None,))}
    if kind == "layernorm":
        return {"scale": ParamDef((d,), "ones", axes=(None,)),
                "bias": ParamDef((d,), "zeros", axes=(None,))}
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
    p = {"w_down": ParamDef((d_ff, d_model), axes=("model", None)),
         "w_up": ParamDef((d_model, d_ff), axes=(None, "model"))}
    if act == "silu":  # gated (SwiGLU)
        p["w_gate"] = ParamDef((d_model, d_ff), axes=(None, "model"))
    return p


#: The MLP's parallel form (leaf -> its sharded dim): column-parallel up
#: and gate, row-parallel down.
MLP_WANT = {"w_up": 1, "w_gate": 1, "w_down": 0}


def apply_mlp(p: dict, x: torch.Tensor, act: str,
              tp: Shards | None = None) -> torch.Tensor:
    """The FFN; with ``tp`` (the ``model`` axis) on the rank's columns of
    ``w_up`` / ``w_gate`` and rows of ``w_down``, then an all-reduce."""
    p, tp = on_shards(tp, p, MLP_WANT)
    if tp is not None:
        x = tp.enter(x)
    up = x @ p["w_up"]
    if act == "silu":
        up = F.silu(x @ p["w_gate"]) * up
    elif act == "gelu":
        # jax.nn.gelu defaults to the tanh approximation.
        up = F.gelu(up, approximate="tanh")
    else:
        raise ValueError(act)
    y = up @ p["w_down"]
    return y if tp is None else tp.exit(y)


# ---------------------------------------------------------------- embed
def embed_def(vocab: int, d_model: int) -> dict:
    return {"table": ParamDef((vocab, d_model), scale=0.02,
                              axes=("model", None))}


def apply_embed(p: dict, tokens: torch.Tensor,
                tp: Shards | None = None) -> torch.Tensor:
    """The table's rows of ``tokens``; with ``tp``, vocab-parallel: each
    rank looks up the tokens among its own rows, zeros the others, and an
    all-reduce joins them (each token's row comes from one rank, so the
    sum is exact)."""
    p, tp = on_shards(tp, p, {"table": 0})
    if tp is None:
        return p["table"][tokens]
    rows = p["table"].shape[0]
    local = tokens - tp.rank * rows
    mine = (local >= 0) & (local < rows)
    e = p["table"][local.clamp(0, rows - 1)]
    return tp.exit(torch.where(mine[..., None], e, 0.0).to(e.dtype))


def unembed(table: torch.Tensor, x: torch.Tensor,
            tp: Shards | None = None) -> torch.Tensor:
    """Logits via the (possibly tied) embedding table: (..., d) -> (..., V);
    with ``tp``, each rank's logits over its own rows, gathered."""
    p, tp = on_shards(tp, {"table": table}, {"table": 0})
    if tp is None:
        return x @ p["table"].T
    return tp.gather(tp.enter(x) @ p["table"].T, x.dim() - 1)


def apply_head(head: torch.Tensor, x: torch.Tensor,
               tp: Shards | None = None) -> torch.Tensor:
    """Logits via an untied head (d, V); with ``tp``, each rank's columns,
    gathered."""
    p, tp = on_shards(tp, {"head": head}, {"head": 1})
    if tp is None:
        return x @ p["head"]
    return tp.gather(tp.enter(x) @ p["head"], x.dim() - 1)
