"""Plain-PyTorch reference of federated rounds of an MLA decoder (the
equations of DeepSeek-V2's multi-head latent attention as MiniCPM3 uses
them, in the port's layout), computed in float32 a layer at a time.

A round: every satellite starts from the global model, runs its local
SGD steps on its own rows, each step's update ``p - lr·g`` taken as the
configuration states it (bf16 parameters: the gradient rounded to bf16,
the product rounded, the difference rounded); then the Eq. 14-16 fold
``Σ_s μ_s·x_s`` accumulated in f32 and rounded once to bf16.

Each satellite step runs the stack forward without keeping its graph
(only each layer's input), the loss and its gradient at the head, then
each layer again under autograd, last to first, updating that layer's
weights as soon as its gradient is known (no later layer of the backward
reads them). Attention is exact causal softmax attention in blocks of
queries, forward and backward written out, in f32.

``control=True`` computes every product in the precision below the
configuration's, float8 (e4m3, one scale a tensor) for bf16: the
control that the comparison has to refuse. Imports nothing of the
program.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from chipbench.reference.fedhap_plan import mu_paper

QUERY_BLOCK = 1024
EPS = 1e-6
F8_MAX = 448.0


def q8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with one scale for the tensor."""
    s = x.detach().abs().amax().clamp_min(1e-30) / F8_MAX
    return (x / s).to(torch.float8_e4m3fn).to(torch.float32) * s


class _Q8Matmul(torch.autograd.Function):
    """``a @ b`` with every product's operands in float8, the backward's
    too."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return q8(a) @ q8(b)

    @staticmethod
    def backward(ctx, dy):
        a, b = ctx.saved_tensors
        dyq = q8(dy)
        return dyq @ q8(b).transpose(-1, -2), q8(a).transpose(-1, -2) @ dyq


class Precision:
    """How the reference multiplies: f32, or float8 for the control."""

    def __init__(self, control: bool):
        self.control = control
        self.cast = q8 if control else (lambda x: x)

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """``a (..., n) @ b (n, m)``."""
        if not self.control:
            return a @ b
        y = _Q8Matmul.apply(a.reshape(-1, a.shape[-1]), b)
        return y.reshape(*a.shape[:-1], b.shape[-1])


class _CausalAttention(torch.autograd.Function):
    """softmax(q·kᵀ/√D, causal)·v in f32, ``(B, H, S, D)`` inputs, in
    blocks of :data:`QUERY_BLOCK` queries; the backward recomputes each
    block's probabilities from the saved log-sum-exp."""

    @staticmethod
    def forward(ctx, q, k, v, prec):
        s_len, scale = q.shape[2], q.shape[3] ** -0.5
        o = torch.empty(*q.shape[:3], v.shape[3], dtype=q.dtype,
                        device=q.device)
        lse = torch.empty(q.shape[:3], dtype=q.dtype, device=q.device)
        for i0 in range(0, s_len, QUERY_BLOCK):
            i1 = min(i0 + QUERY_BLOCK, s_len)
            p, lse[:, :, i0:i1] = _probs(q, k, i0, i1, scale, prec)
            o[:, :, i0:i1] = prec.cast(p) @ prec.cast(v[:, :, :i1])
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.prec = prec
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        prec, c = ctx.prec, ctx.prec.cast
        s_len, scale = q.shape[2], q.shape[3] ** -0.5
        delta = (do * o).sum(-1)
        dq, dk, dv = (torch.zeros_like(t) for t in (q, k, v))
        for i0 in range(0, s_len, QUERY_BLOCK):
            i1 = min(i0 + QUERY_BLOCK, s_len)
            p, _ = _probs(q, k, i0, i1, scale, prec, lse[:, :, i0:i1])
            doi = do[:, :, i0:i1]
            dv[:, :, :i1] += c(p).transpose(-1, -2) @ c(doi)
            dp = c(doi) @ c(v[:, :, :i1]).transpose(-1, -2)
            ds = p * (dp - delta[:, :, i0:i1, None])
            dq[:, :, i0:i1] = scale * (c(ds) @ c(k[:, :, :i1]))
            dk[:, :, :i1] += scale * (c(ds).transpose(-1, -2)
                                      @ c(q[:, :, i0:i1]))
        return dq, dk, dv, None


def _probs(q, k, i0, i1, scale, prec, lse=None):
    s = (prec.cast(q[:, :, i0:i1]) @ prec.cast(k[:, :, :i1])
         .transpose(-1, -2)) * scale
    rows = torch.arange(i0, i1, device=q.device)[:, None]
    cols = torch.arange(i1, device=q.device)[None, :]
    s = s.masked_fill(cols > rows, float("-inf"))
    if lse is None:
        lse = torch.logsumexp(s, dim=-1)
    return torch.exp(s - lse[..., None]), lse


def rms(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + EPS) * scale


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding over the last dim of ``(B, S, H, d)``: the
    half-split rotation at positions ``0 .. S-1``."""
    d = x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                          device=x.device) / d))
    ang = torch.arange(x.shape[1], dtype=torch.float32,
                       device=x.device)[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def layer(cfg: dict, p: dict, x: torch.Tensor, prec: Precision):
    """One decoder layer: MLA then the gated MLP, each pre-normed, each
    added to the residual."""
    b, s, _ = x.shape
    h_n, nope, rope_d, dv = (cfg["num_attention_heads"],
                             cfg["qk_nope_head_dim"],
                             cfg["qk_rope_head_dim"], cfg["v_head_dim"])
    mm = prec.mm
    h = rms(x, p["norm1/scale"])
    cq = rms(mm(h, p["mixer/w_dq"]), p["mixer/q_norm"])
    q = mm(cq, p["mixer/w_uq"]).reshape(b, s, h_n, nope + rope_d)
    q_nope, q_rope = torch.split(q, [nope, rope_d], dim=-1)
    ckv = rms(mm(h, p["mixer/w_dkv"]), p["mixer/kv_norm"])
    k_nope = mm(ckv, p["mixer/w_uk"]).reshape(b, s, h_n, nope)
    v = mm(ckv, p["mixer/w_uv"]).reshape(b, s, h_n, dv)
    k_rope = rope(mm(h, p["mixer/w_kr"])[:, :, None, :], cfg["rope_theta"])
    q = torch.cat([q_nope, rope(q_rope, cfg["rope_theta"])], -1)
    k = torch.cat([k_nope, k_rope.expand(b, s, h_n, rope_d)], -1)
    o = _CausalAttention.apply(q.transpose(1, 2), k.transpose(1, 2),
                               v.transpose(1, 2), prec)
    x = x + mm(o.transpose(1, 2).reshape(b, s, h_n * dv), p["mixer/wo"])
    h2 = rms(x, p["norm2/scale"])
    up = torch.nn.functional.silu(mm(h2, p["mlp/w_gate"])) * mm(
        h2, p["mlp/w_up"])
    return x + mm(up, p["mlp/w_down"])


LAYERS = "layers/b0/"


def _layer_params(replica: dict, i: int, grad: bool) -> dict:
    return {k[len(LAYERS):]: _f32(v[i]).requires_grad_(grad)
            for k, v in replica.items() if k.startswith(LAYERS)}


def _f32(x: torch.Tensor) -> torch.Tensor:
    """An f32 copy of ``x`` that shares nothing with it."""
    return x.detach().to(torch.float32, copy=True)


def _sgd(leaf: torch.Tensor, g: torch.Tensor, lr: float) -> None:
    """The configuration's update of a bf16 leaf, in place."""
    leaf.copy_(leaf - lr * g.to(leaf.dtype))


def satellite_step(cfg: dict, replica: dict, tokens: torch.Tensor,
                   labels: torch.Tensor, lr: float, prec: Precision,
                   grad_norms: dict | None = None) -> float:
    """One local SGD step of one replica (bf16 leaves, updated in place)
    on ``tokens``/``labels`` ``(B, S)``; returns the step's loss. With
    ``grad_norms``, each leaf's f32 gradient norm is written there."""
    n_layers, d = cfg["num_hidden_layers"], cfg["hidden_size"]
    table = _f32(replica["embed/table"])
    inputs = []
    with torch.no_grad():
        x = table[tokens]
        for i in range(n_layers):
            inputs.append(x)
            x = layer(cfg, _layer_params(replica, i, False), x, prec)
    x = x.requires_grad_()
    tab = table.requires_grad_()
    fnorm = _f32(replica["final_norm/scale"]).requires_grad_()
    logits = prec.mm(rms(x, fnorm), tab.transpose(0, 1))
    loss = (torch.logsumexp(logits, -1)
            - logits.gather(-1, labels[..., None])[..., 0]).mean()
    dx, g_fnorm, g_tab = torch.autograd.grad(loss, [x, fnorm, tab])
    del logits
    sq: dict = {}
    for i in reversed(range(n_layers)):
        p = _layer_params(replica, i, True)
        xin = inputs[i].requires_grad_()
        y = layer(cfg, p, xin, prec)
        grads = torch.autograd.grad(y, [xin, *p.values()], dx)
        dx = grads[0]
        inputs[i] = None
        with torch.no_grad():
            for name, g in zip(p, grads[1:]):
                key = LAYERS + name
                if grad_norms is not None:
                    sq[key] = sq.get(key, 0.0) + g.double().square().sum()
                _sgd(replica[key][i], g, lr)
    with torch.no_grad():
        g_tab.index_add_(0, tokens.reshape(-1), dx.reshape(-1, d))
        _sgd(replica["embed/table"], g_tab, lr)
        _sgd(replica["final_norm/scale"], g_fnorm, lr)
    if grad_norms is not None:
        grad_norms.update({k: math.sqrt(float(v)) for k, v in sq.items()})
        grad_norms["embed/table"] = float(g_tab.norm())
        grad_norms["final_norm/scale"] = float(g_fnorm.norm())
    return float(loss.detach())


def rounds(cfg: dict, wl: dict, params: dict, tokens: torch.Tensor,
           visible: np.ndarray, n_rounds: int, control: bool = False):
    """``n_rounds`` federated rounds from ``params`` (the bf16 global
    model, updated in place), round r on ``tokens[r]`` ``(S, B, T+1)``
    and ``visible[r]``. Returns each round's loss (the mean of the
    satellites' last local step), the first step's per-leaf gradient
    norms, and each leaf's change norm after each round."""
    prec = Precision(control)
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        start = {k: v.clone() for k, v in params.items()}
        losses, changes, grad0 = [], [], {}
        n_sats, k_ring = wl["sats"], wl["sats"] // wl["orbits"]
        sizes = np.ones((wl["orbits"], k_ring), np.float32)
        for r in range(n_rounds):
            mu = mu_paper(visible[r].reshape(wl["orbits"], k_ring),
                          sizes).reshape(-1)
            acc = {k: torch.zeros(v.shape, dtype=torch.float32,
                                  device=v.device) for k, v in params.items()}
            last = []
            for s in range(n_sats):
                rep = {k: v.clone() for k, v in params.items()}
                for _ in range(wl["local_steps"]):
                    loss = satellite_step(
                        cfg, rep, tokens[r, s, :, :-1], tokens[r, s, :, 1:],
                        wl["lr"], prec,
                        grad0 if (r == 0 and s == 0 and not grad0) else None)
                last.append(loss)
                for k in acc:
                    acc[k].add_(rep[k].float(), alpha=float(np.float32(mu[s])))
                del rep
            for k in params:
                params[k].copy_(acc[k].to(params[k].dtype))
            del acc
            losses.append(float(np.mean(last)))
            changes.append({k: float((params[k].float() - start[k].float())
                                     .norm()) for k in params})
        return losses, grad0, changes
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
