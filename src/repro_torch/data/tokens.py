"""Synthetic token streams for federated LM pre-training.

A learnable-but-nontrivial language: a mixture of per-satellite Markov
chains over the vocabulary with shared global structure. Each satellite's
local corpus draws from the global bigram model plus a client-specific
skew — mirroring the paper's non-IID setting at LM scale. Deterministic
given (seed, client).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class TokenTaskConfig:
    vocab_size: int = 4096
    num_states: int = 64          # latent states of the generative chain
    client_skew: float = 0.3      # 0 = IID across clients, 1 = fully local
    seed: int = 0


def _chain(cfg: TokenTaskConfig, client: int | None) -> tuple[np.ndarray, np.ndarray]:
    """(state-transition matrix, per-state emission logits)."""
    rng = np.random.default_rng(cfg.seed)
    trans = rng.dirichlet(np.full(cfg.num_states, 0.2), size=cfg.num_states)
    emit = rng.normal(0.0, 2.5, size=(cfg.num_states, cfg.vocab_size))
    if client is not None and cfg.client_skew > 0:
        crng = np.random.default_rng(cfg.seed * 7919 + client + 1)
        emit = emit + cfg.client_skew * crng.normal(
            0.0, 1.0, size=emit.shape
        )
    return trans, emit


def make_token_dataset(
    num_tokens: int,
    cfg: TokenTaskConfig = TokenTaskConfig(),
    client: int | None = None,
    seed_offset: int = 0,
) -> np.ndarray:
    """Generate `num_tokens` int32 tokens for one client."""
    trans, emit = _chain(cfg, client)
    rng = np.random.default_rng(
        cfg.seed * 104729 + (client or 0) * 31 + seed_offset
    )
    # Emission distributions (softmax over vocab), truncated for speed.
    top_k = min(256, cfg.vocab_size)
    probs = np.exp(emit - emit.max(axis=1, keepdims=True))
    top_idx = np.argsort(-probs, axis=1)[:, :top_k]
    top_p = np.take_along_axis(probs, top_idx, axis=1)
    top_p /= top_p.sum(axis=1, keepdims=True)
    states = np.zeros(num_tokens, dtype=np.int32)
    s = rng.integers(0, cfg.num_states)
    # Vectorized-ish state walk in blocks.
    u = rng.random(num_tokens)
    cum_trans = np.cumsum(trans, axis=1)
    for i in range(num_tokens):
        states[i] = s
        s = int(np.searchsorted(cum_trans[s], u[i]))
        s = min(s, cfg.num_states - 1)
    choice = rng.random(num_tokens)
    cum_p = np.cumsum(top_p, axis=1)
    pos = np.empty(num_tokens, dtype=np.int64)
    for st in range(cfg.num_states):
        m = states == st
        if m.any():
            pos[m] = np.searchsorted(cum_p[st], choice[m])
    pos = np.minimum(pos, top_k - 1)
    return top_idx[states, pos].astype(np.int32)
