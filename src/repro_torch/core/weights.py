"""Closed-form FedHAP weights engine (paper Eq. 14-16) — single source
of truth.

Every place that turns a visibility mask + data sizes into aggregation
weights goes through this module:

- ``repro.core.aggregation.segment_upload_weights`` (numpy, per-orbit API)
  wraps :func:`chain_stats` / :func:`segment_ends`;
- ``repro.core.mesh_round._fused_body`` (shard_map) calls
  :func:`chain_stats` with ``xp=jax.numpy`` on its all-gathered orbit
  vectors;
- ``repro.launch.train`` and the timeline simulator
  (``repro.sim.engine``) call :func:`mu_weights` for the flat
  per-satellite global weight vector consumed by a single einsum.

The math is expressed once, over batched ``(..., K)`` arrays, and runs
under either numpy (``xp=numpy``) or jax.numpy (``xp=jax.numpy``, safe
inside ``jit``/``shard_map``: the ring walk is a static unroll over the
orbit size K using ``xp.roll``, no data-dependent control flow).

Terminology (one orbit ring of K satellites):

- A *segment* starts at a visible satellite (the chain *origin*), folds
  the following run of invisible satellites via Eq. 14, and delivers to
  the next visible satellite.
- ``lam[x]`` — the closed-form weight of satellite x's model inside its
  segment (``sum_x lam[x] == 1`` per segment).
- ``seg_mass[x]`` — the segment's total data mass (Eq. 16's ``m_U``).
- ``mu[x]`` — the end-to-end weight of satellite x in the new *global*
  model after Eq. 16, i.e. ``w_global = sum_x mu[x] * w_x``.

Partial-aggregation modes (Eq. 14's gamma):

- ``"paper"`` — gamma_k' = m_k'/m_orbit (order-dependent telescoping, as
  written in the paper);
- ``"exact"`` — gamma_k' = m_k'/(m_acc + m_k') (beyond-paper running
  weighted mean; the chain telescopes to sum(m_i w_i)/sum(m_i)).

Orbit weightings (Eq. 16):

- ``"paper"`` — each orbit normalized by its own mass, orbits averaged
  with equal weight 1/L;
- ``"global"`` — every segment weighted by mass/total_mass (Eq. 4).
"""
from __future__ import annotations

from typing import Any, Sequence, Tuple

import numpy as np

PARTIAL_MODES = ("paper", "exact")
ORBIT_WEIGHTINGS = ("paper", "global")


def chain_weights(
    sizes: Sequence[float], m_orbit_total: float, mode: str = "paper"
) -> np.ndarray:
    """Closed-form effective weight of each chain member (one segment).

    ``sizes[0]`` is the *origin* (visible satellite whose local model
    seeds the chain); subsequent entries are the invisible satellites
    folded in order. The result λ satisfies:
        chain_result == Σ_i λ_i · w_i,   Σ_i λ_i == 1.

    paper mode:  λ_i = γ_i · Π_{u>i} (1-γ_u), γ_0 ≡ 1, γ_i = m_i/m_orbit.
    exact mode:  λ_i = m_i / Σ_j m_j (the weighted mean).
    """
    sizes = np.asarray(sizes, dtype=np.float64)
    n = len(sizes)
    if mode == "exact":
        total = sizes.sum()
        return sizes / total if total > 0 else np.zeros(n)
    if mode != "paper":
        raise ValueError(mode)
    gammas = sizes / (m_orbit_total if m_orbit_total > 0 else 1.0)
    gammas[0] = 1.0
    lam = np.empty(n)
    suffix = 1.0
    for i in range(n - 1, -1, -1):
        lam[i] = gammas[i] * suffix
        suffix *= (1.0 - gammas[i]) if i > 0 else 1.0
    return lam


def chain_stats(
    visible: Any,
    sizes: Any,
    partial_mode: str = "paper",
    xp: Any = np,
) -> Tuple[Any, Any]:
    """Batched per-slot chain weights for orbit rings.

    ``visible``/``sizes`` have shape ``(..., K)`` — any number of leading
    batch dims (orbits); the trailing dim is the ring. Returns
    ``(lam, seg_mass)`` of the same shape:

    - ``lam[..., x]``: satellite x's Eq.-14 weight inside its segment,
    - ``seg_mass[..., x]``: x's segment total mass (Eq. 16's m_U).

    Rings with no visible satellite get all-zero lam and seg_mass
    (Eq. 15's missing-ID gating: the orbit contributes nothing).

    ``xp`` selects the backend (numpy or jax.numpy). Under jax the walk
    is a static unroll over K (K is small and static), so the function
    is jit- and shard_map-safe.
    """
    if partial_mode not in PARTIAL_MODES:
        raise ValueError(f"unknown partial aggregation mode: {partial_mode}")
    visible = xp.asarray(visible).astype(bool)
    sizes = xp.asarray(sizes)
    k = visible.shape[-1]
    m_orbit = sizes.sum(axis=-1, keepdims=True)
    # Zero-total guard (Eq. 15): a ring whose surviving mass is zero
    # divides by 1 instead of 0 and is zeroed below — rings with mass
    # are untouched bit-for-bit.
    safe_orbit = xp.where(m_orbit > 0, m_orbit, 1.0)

    # Forward walk: fold the invisible successors of each slot until the
    # segment's terminal visible satellite (which is NOT a member).
    suffix = xp.ones_like(sizes)
    seg = sizes
    terminated = xp.zeros_like(visible)
    for step in range(1, k):
        nxt_vis = xp.roll(visible, -step, axis=-1)
        nxt_sz = xp.roll(sizes, -step, axis=-1)
        active = (~terminated) & (~nxt_vis)
        if partial_mode == "paper":
            suffix = xp.where(active,
                              suffix * (1.0 - nxt_sz / safe_orbit),
                              suffix)
        seg = xp.where(active, seg + nxt_sz, seg)
        terminated = terminated | nxt_vis

    # Backward walk: accumulate the mass of the members before each slot
    # in its segment, stopping at (and including) the visible origin.
    prefix = xp.zeros_like(sizes)
    back_done = visible
    for step in range(1, k):
        prv_vis = xp.roll(visible, step, axis=-1)
        prv_sz = xp.roll(sizes, step, axis=-1)
        prefix = xp.where(back_done, prefix, prefix + prv_sz)
        back_done = back_done | prv_vis
    seg_mass = prefix + seg

    if partial_mode == "paper":
        # The origin's gamma is 1 by definition (it seeds the chain).
        lam = xp.where(visible, 1.0, sizes / safe_orbit) * suffix
    else:
        safe_seg = xp.where(seg_mass > 0, seg_mass, 1.0)
        lam = sizes / safe_seg

    any_vis = visible.any(axis=-1, keepdims=True)
    lam = xp.where(any_vis, lam, 0.0)
    seg_mass = xp.where(any_vis, seg_mass, 0.0)
    return lam, seg_mass


def segment_ends(visible: Any) -> np.ndarray:
    """Terminal (delivering) slot of every satellite's segment.

    ``visible``: ``(..., K)`` bool. Returns int64 ``(..., K)``: the slot
    of the *next visible* satellite strictly after x on the ring — the
    visible satellite x's segment delivers to — or -1 everywhere for a
    ring with no visible satellite. Numpy only (used for latency
    bookkeeping on the host, never inside jit).

    Vectorized: one sentinel-masked ``minimum.accumulate`` over the
    doubled ring instead of a Python scan per slot.
    """
    v = np.asarray(visible, dtype=bool)
    k = v.shape[-1]
    dbl = np.concatenate([v, v], axis=-1)                  # (..., 2K)
    idx = np.where(dbl, np.arange(2 * k), 2 * k)           # sentinel 2K
    nxt = np.minimum.accumulate(idx[..., ::-1], axis=-1)[..., ::-1]
    ends = nxt[..., 1:k + 1] % k
    return np.where(v.any(axis=-1, keepdims=True), ends, -1).astype(np.int64)


def mu_from_chain(
    lam: Any,
    seg_mass: Any,
    sizes: Any,
    orbit_weighting: str = "paper",
    xp: Any = np,
) -> Any:
    """Eq. 16 on top of chain stats: per-satellite *global* weights.

    Inputs are batched ``(L, K)`` (orbits x ring); returns ``mu`` of the
    same shape with ``w_global = sum mu * w`` (mu sums to 1 when every
    orbit has a visible satellite).

    Zero-total guard (Eq. 15/16): an orbit (paper weighting) or a whole
    constellation (global weighting) whose surviving data mass is zero
    yields exactly-zero mu rows instead of NaN — the caller's fold then
    carries the previous params forward. Non-degenerate inputs take the
    original division bit-for-bit.
    """
    if orbit_weighting not in ORBIT_WEIGHTINGS:
        raise ValueError(orbit_weighting)
    sizes = xp.asarray(sizes)
    m_orbit = sizes.sum(axis=-1, keepdims=True)
    if orbit_weighting == "paper":
        n_orbits = lam.shape[0]
        safe_orbit = xp.where(m_orbit > 0, m_orbit, 1.0)
        return seg_mass / safe_orbit * lam / n_orbits
    total = sizes.sum()
    safe_total = xp.where(total > 0, total, 1.0)
    return seg_mass / safe_total * lam


def renormalize(weights: Any, xp: Any = np) -> Any:
    """Renormalize aggregation weights over surviving uploads.

    Used by the fault plane: after lost uploads zero their satellites'
    entries, the survivors are rescaled to unit mass so the fold stays
    an affine combination. An all-zero vector (a round that lost every
    upload) stays all-zero — the executor's zero-weight fold then
    contributes nothing and the previous params carry forward, never
    NaN.
    """
    w = xp.asarray(weights)
    total = w.sum()
    safe = xp.where(total > 0, total, 1.0)
    return xp.where(total > 0, w / safe, xp.zeros_like(w))


def staleness_discount(staleness: Any, power: float = 0.5,
                       xp: Any = np) -> Any:
    """Multiplicative staleness discount ``1 / (1 + s)^p``.

    The FedBuff/FedSpace-style polynomial down-weighting of updates that
    trained against an old global model — the single definition shared
    by the simulator's buffered baseline (``fedspace``) and the routed
    asynchronous FedHAP strategies (``fedhap_async`` /
    ``fedhap_buffered``), which apply it on top of the Eq. 14-16
    closed-form weights. ``staleness`` counts aggregation events since
    the update's base model; batched over any shape.
    """
    return 1.0 / (1.0 + xp.asarray(staleness)) ** power


def mu_weights(
    visible: Any,
    sizes: Any,
    sats_per_orbit: int,
    partial_mode: str = "paper",
    orbit_weighting: str = "paper",
    xp: Any = np,
) -> Any:
    """Flat per-satellite global weights for a whole constellation.

    ``visible``/``sizes`` are flat ``(n_sats,)`` vectors laid out orbit-
    major (the constellation's satellite-ID order); ``sats_per_orbit``
    gives the ring size K. Returns a flat ``(n_sats,)`` ``mu`` such that
    ``w_global = einsum('s,s...->...', mu, stacked_params)``.
    """
    v = xp.asarray(visible).reshape(-1, sats_per_orbit)
    s = xp.asarray(sizes).reshape(-1, sats_per_orbit)
    lam, seg_mass = chain_stats(v, s, partial_mode, xp=xp)
    mu = mu_from_chain(lam, seg_mass, s, orbit_weighting, xp=xp)
    return mu.reshape(-1)


__all__ = [
    "PARTIAL_MODES", "ORBIT_WEIGHTINGS",
    "chain_weights", "chain_stats", "segment_ends",
    "mu_from_chain", "mu_weights", "renormalize", "staleness_discount",
]
