"""FedHAP aggregation math (paper Eq. 14-16; port of
``repro.core.aggregation``).

The closed-form weight math lives in :mod:`repro_torch.core.weights`
(the single source of truth shared with the simulator); this module
keeps the literal Eq.-14 recursion (``partial_aggregate``), the Eq.-15
dedup set cover, the Eq.-16 tree aggregation, and the per-orbit
``segment_upload_weights`` API as a thin wrapper over the batched
engine. Models are the port's param trees: flat ``dict[str, Tensor]``.

Two partial-aggregation modes:

- ``"paper"`` — Eq. 14 verbatim: w <- (1-γ_k')·w + γ_k'·w_k' with
  γ_k' = m_k'/m (m = the orbit's total data size). The telescoped chain
  weights are *order-dependent* and do NOT equal the per-orbit weighted
  mean (easy to check with two equal-size satellites: weights become
  [(1-γ)..., γ...] ≠ uniform).
- ``"exact"`` — beyond-paper correction: γ_k' = m_k'/(m_acc + m_k') (the
  running weighted mean), whose chain telescopes exactly to
  Σ m_i w_i / Σ m_i over the folded satellites.
"""
from __future__ import annotations

from typing import Any, Mapping, Sequence

import numpy as np
import torch

from repro_torch.core.treeops import tree_add, tree_scale
from repro_torch.core.weights import chain_stats, chain_weights, segment_ends

__all__ = [
    "partial_aggregate", "chain_weights", "segment_upload_weights",
    "dedup_set_cover", "full_aggregate",
]


def partial_aggregate(
    w_acc: Mapping[str, torch.Tensor],
    w_new: Mapping[str, torch.Tensor],
    m_new: float,
    m_orbit_total: float,
    m_acc: float,
    mode: str = "paper",
):
    """One Eq.-14 hop: fold satellite k' (weight m_new) into the partial
    model w_acc (accumulated mass m_acc). Returns (w_updated, m_acc_new).
    """
    if mode == "paper":
        gamma = m_new / m_orbit_total
    elif mode == "exact":
        gamma = m_new / (m_acc + m_new)
    else:
        raise ValueError(f"unknown partial aggregation mode: {mode}")
    upd = {k: (1.0 - gamma) * a + gamma * w_new[k] for k, a in w_acc.items()}
    return upd, m_acc + m_new


def segment_upload_weights(
    visible: np.ndarray,
    sizes: np.ndarray,
    mode: str = "paper",
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-satellite closed-form weights for one orbit ring.

    Given the ring's visibility mask and data sizes, computes for every
    satellite x:
      - ``lam[x]``: its weight inside its chain segment,
      - ``seg_end[x]``: the slot (visible satellite) its segment delivers to,
      - ``seg_mass[x]``: the segment's total data mass (Eq. 16's m_U).

    A segment starts at a visible satellite and folds the following run of
    invisible satellites, delivering to the *next* visible satellite. If no
    satellite is visible the orbit contributes nothing (all seg_end = -1):
    Eq. 15's missing-ID gating.

    Thin single-orbit wrapper over the batched engine in
    :mod:`repro_torch.core.weights`.
    """
    visible = np.asarray(visible, dtype=bool)
    sizes = np.asarray(sizes, dtype=np.float64)
    lam, seg_mass = chain_stats(visible[None], sizes[None], mode, xp=np)
    seg_end = segment_ends(visible[None])
    return lam[0], seg_end[0], seg_mass[0]


def dedup_set_cover(
    partials: Sequence[tuple[frozenset[int], float, Any]],
) -> tuple[list[tuple[frozenset[int], float, Any]], set[int]]:
    """Eq. 15: filter redundant partial models by satellite-ID metadata.

    ``partials`` is a list of (covered satellite IDs, data mass, model).
    Keeps a subset whose coverage sets are pairwise disjoint (greedy in
    the given order — HAP arrival order, as the paper's source HAP would
    see them) and returns (kept, covered_ids).
    """
    covered: set[int] = set()
    kept = []
    for ids, mass, model in partials:
        if ids & covered:
            continue  # redundant: some satellite already covered
        kept.append((ids, mass, model))
        covered |= ids
    return kept, covered


def full_aggregate(
    per_orbit: dict[int, list[tuple[float, Mapping[str, torch.Tensor]]]],
    orbit_weighting: str = "paper",
):
    """Eq. 16: combine deduped partial models into the new global model.

    ``per_orbit[l]`` = [(mass, model), ...] for orbit l.

    paper mode: each orbit is normalized by its own mass m_l and orbits
    are averaged with equal weight (Eq. 16 as written, normalized by L so
    the weights sum to one).
    global mode: every partial weighted by mass/total_mass (Eq. 4's n_k/n).
    """
    orbits = sorted(per_orbit)
    if not orbits:
        raise ValueError("no partial models to aggregate")
    if orbit_weighting == "paper":
        acc = None
        for l in orbits:
            m_l = sum(m for m, _ in per_orbit[l])
            for mass, model in per_orbit[l]:
                w = mass / m_l / len(orbits)
                term = tree_scale(model, w)
                acc = term if acc is None else tree_add(acc, term)
        return acc
    if orbit_weighting == "global":
        total = sum(m for l in orbits for m, _ in per_orbit[l])
        acc = None
        for l in orbits:
            for mass, model in per_orbit[l]:
                term = tree_scale(model, mass / total)
                acc = term if acc is None else tree_add(acc, term)
        return acc
    raise ValueError(orbit_weighting)
