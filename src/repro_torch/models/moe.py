"""Mixture-of-Experts with capacity-based sort dispatch (port of
``repro.models.moe``).

router -> top-k -> flatten assignments -> stable sort by expert ->
per-expert capacity slots -> dispatch buffer (E, C, D) -> batched expert
FFN (``torch.matmul`` over experts; the JAX package leaves these
einsums to XLA, outside any Pallas kernel) -> gather back and
gate-weighted combine, plus the Switch-style load-balance loss.

The dispatch reproduces what the JAX package computes on the CPU, and is
deterministic on every device. The JAX package scatters every
assignment, its dropped ones as zero rows clamped to slot ``cap - 1``
(``repro/models/moe.py:100-106``); with duplicate indices the last write
wins, so the kept assignment at slot ``cap - 1`` of an overflowing expert
is overwritten with zeros and its expert output is exactly 0 (ROADMAP
Queue C). A scatter with duplicate indices has no defined order on a
card, so the port gathers instead: slot j of expert e takes the
assignment at position ``starts[e] + j`` of the sorted order if
``j < counts[e]``, and slot ``cap - 1`` of an expert whose load exceeds
``cap`` stays zero. No index is written twice and the host never waits
on the device.

Both dispatch modes are ported: one global buffer, or with
``moe_dispatch_local`` (where the tokens split into
``moe_dispatch_blocks`` blocks of at least ``top_k`` tokens) each block
dispatched on its own with capacity ``C/G``, one block after another
(the JAX package vmaps them), and the blocks' aux losses averaged.
``moe_ep_constraint`` (a GSPMD layout hint) has no counterpart.

Expert parallelism over ``model`` (``tp``, ``models/sharding.py``): a
rank holds ``E/m`` experts (``w_gate`` / ``w_up`` / ``w_down`` sharded on
their expert dim). Every rank routes every token (the router and the
tokens replicate, and the routing is deterministic), fills only its own
experts' slice of the ``(E, C, D)`` buffer, runs them and combines their
outputs into a partial ``y``; an all-reduce over ``model`` finishes it.
The dropped kept-assignment at slot ``cap - 1`` is reproduced in each
rank's slice and in each block.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig, MoEConfig
from repro_torch.models.params import ParamDef
from repro_torch.models.sharding import Shards, on_shards

#: The MoE's parallel form: experts sharded on their leading dim.
MOE_WANT = {"w_gate": 0, "w_up": 0, "w_down": 0}


def moe_defs(cfg: ArchConfig) -> dict:
    m = cfg.moe
    d = cfg.d_model
    f = m.d_ff_expert
    return {
        "router": ParamDef((d, m.num_experts), scale=0.02, axes=(None, None)),
        "w_gate": ParamDef((m.num_experts, d, f), axes=("model", None, None)),
        "w_up": ParamDef((m.num_experts, d, f), axes=("model", None, None)),
        "w_down": ParamDef((m.num_experts, f, d), axes=("model", None, None)),
    }


def capacity(m: MoEConfig, num_tokens: int) -> int:
    c = int(m.capacity_factor * m.top_k * num_tokens / m.num_experts)
    return max(4, -(-c // 4) * 4)  # round up to a multiple of 4


def apply_moe(cfg: ArchConfig, p: dict, x: torch.Tensor,
              tp: Optional[Shards] = None
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (y, aux_loss): one global dispatch buffer, or with
    ``cfg.moe_dispatch_local`` (and ``T % G == 0``, ``T/G >= top_k``) one
    per token block. ``tp``: the ``model`` axis (experts on shards where
    ``model`` divides them, else gathered)."""
    p, tp = on_shards(tp, p, MOE_WANT, cfg.moe.num_experts)
    b, s, d = x.shape
    t = b * s
    xt = x.reshape(t, d)
    g = cfg.moe_dispatch_blocks
    if cfg.moe_dispatch_local and t % g == 0 and t // g >= cfg.moe.top_k:
        parts = [_moe_tokens(cfg, p, xb, tp)
                 for xb in xt.reshape(g, t // g, d)]
        y = torch.cat([y for y, _ in parts])
        aux = torch.stack([a for _, a in parts]).mean()
    else:
        y, aux = _moe_tokens(cfg, p, xt, tp)
    if tp is not None:
        y = tp.exit(y)
    return y.reshape(b, s, d), aux


def route(cfg: ArchConfig, p: dict, xt: torch.Tensor):
    """The router over a flat token block (T, D) -> (probs (T, E) f32, the
    renormalized top-k gate values (T, k), their experts (T, k))."""
    logits = (xt @ p["router"]).float()                    # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = torch.topk(probs, cfg.moe.top_k, dim=-1)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp(
        min=1e-9)                                          # renormalize
    return probs, gate_vals, gate_idx


def _moe_tokens(cfg: ArchConfig, p: dict, xt: torch.Tensor,
                tp: Optional[Shards] = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Capacity-based sort dispatch over a flat token block (T, D); on
    shards (``tp``) the rank's experts only, and ``y`` is the rank's
    partial sum (the caller all-reduces it)."""
    m = cfg.moe
    t, d = xt.shape
    e, k = m.num_experts, m.top_k
    cap = capacity(m, t)
    dev = xt.device
    probs, gate_vals, gate_idx = route(cfg, p, xt)
    # The rank's experts [lo, hi); the tokens and the gates feed only
    # them, so their gradients are partial: all-reduced by enter.
    lo, hi = 0, e
    if tp is not None:
        lo = tp.rank * (e // tp.size)
        hi = lo + e // tp.size
        xt, gate_vals = tp.enter(xt), tp.enter(gate_vals)

    # ---- flatten assignments and sort by expert (stable).
    e_flat = gate_idx.reshape(-1)                          # (T*k,)
    order = torch.argsort(e_flat, stable=True)
    t_sorted = order // k                                  # token of each
    g_sorted = gate_vals.reshape(-1)[order]
    counts = F.one_hot(e_flat, e).sum(dim=0)               # (E,); unlike
    # bincount, one_hot with its class count given reads nothing back
    starts = torch.cumsum(counts, 0) - counts
    pos_in_e = torch.arange(t * k, device=dev) - starts[e_flat[order]]
    keep = pos_in_e < cap                                  # capacity drop
    slot = e_flat[order] * cap + pos_in_e.clamp(max=cap - 1)

    # ---- dispatch (E, C, D), by gather: slot j of expert e holds sorted
    # assignment starts[e] + j; an overflowing expert's slot cap-1 stays 0.
    # Only the rows of experts [lo, hi) are filled.
    j = torch.arange(cap, device=dev)
    filled = torch.where(counts > cap, cap - 1, counts)[lo:hi]
    src = (starts[lo:hi, None] + j).clamp(max=t * k - 1)   # (E', C)
    disp = torch.where((j < filled[:, None])[..., None],
                       xt[t_sorted[src]], 0.0).to(xt.dtype)

    # ---- expert FFN (batched matmul over experts).
    h = F.silu(disp @ p["w_gate"]) * (disp @ p["w_up"])
    out = h @ p["w_down"]                                  # (E', C, D)

    # ---- combine: each kept assignment's output, gate-weighted, summed
    # over the token's k assignments in their top-k order; an assignment
    # to another rank's expert adds 0 here.
    if tp is not None:
        keep = keep & (slot >= lo * cap) & (slot < hi * cap)
        slot = (slot - lo * cap).clamp(0, (hi - lo) * cap - 1)
    contrib = torch.where(keep[:, None],
                          out.reshape(-1, d)[slot] * g_sorted[:, None],
                          0.0).to(xt.dtype)                # (T*k, D) sorted
    unsorted = torch.empty_like(contrib)
    unsorted[order] = contrib
    y = unsorted.reshape(t, k, d).sum(dim=1)

    # ---- Switch-style load-balance loss.
    frac_tokens = F.one_hot(gate_idx[:, 0], e).float().mean(dim=0)
    frac_probs = probs.mean(dim=0)
    aux = e * torch.sum(frac_tokens * frac_probs) * m.aux_loss_coef
    return y, aux
