"""Federated dataset partitioning across satellites (paper §IV-A).

IID: shuffle and split equally; every satellite holds all 10 classes.
non-IID: satellites in the first 3 orbits hold classes 0-5; satellites in
the remaining 2 orbits hold classes 6-9 (the paper's split, generalized to
any orbit count: the first ceil(0.6*L) orbits get classes 0-5).
"""
from __future__ import annotations

import numpy as np


def partition_iid(
    labels: np.ndarray, num_clients: int, seed: int = 0
) -> list[np.ndarray]:
    """Equal random split; returns per-client index arrays."""
    rng = np.random.default_rng(seed)
    idx = rng.permutation(len(labels))
    return [np.sort(part) for part in np.array_split(idx, num_clients)]


def partition_noniid_by_orbit(
    labels: np.ndarray,
    num_orbits: int,
    sats_per_orbit: int,
    seed: int = 0,
    split_classes: tuple[tuple[int, ...], tuple[int, ...]] = (
        (0, 1, 2, 3, 4, 5),
        (6, 7, 8, 9),
    ),
    orbit_shells: np.ndarray | None = None,
) -> list[np.ndarray]:
    """Paper's non-IID split, keyed by orbit membership.

    Returns per-satellite index arrays ordered by sat_id
    (= orbit * sats_per_orbit + slot).

    ``orbit_shells`` maps each of the ``num_orbits`` stacked orbital
    planes to its shell id (``constellation.shell_of`` evaluated on the
    plane table). When given, the ceil(0.6*L) class-group split is
    applied *within each shell* so multi-shell ``shells:`` specs keep
    the paper's 60/40 orbit mix per shell instead of assigning whole
    shells to one class group. ``None`` (single shell) reproduces the
    historical split exactly.
    """
    rng = np.random.default_rng(seed)
    if orbit_shells is None:
        orbit_shells = np.zeros(num_orbits, dtype=np.int64)
    else:
        orbit_shells = np.asarray(orbit_shells, dtype=np.int64)
        if orbit_shells.shape != (num_orbits,):
            raise ValueError(
                f"orbit_shells must have shape ({num_orbits},), "
                f"got {orbit_shells.shape}")
    is_a = np.zeros(num_orbits, dtype=bool)
    for shell in np.unique(orbit_shells):
        orbits = np.nonzero(orbit_shells == shell)[0]
        group_a = max(1, int(np.ceil(0.6 * len(orbits))))
        is_a[orbits[:group_a]] = True
    cls_a, cls_b = (set(split_classes[0]), set(split_classes[1]))
    idx_a = np.nonzero(np.isin(labels, list(cls_a)))[0]
    idx_b = np.nonzero(np.isin(labels, list(cls_b)))[0]
    rng.shuffle(idx_a)
    rng.shuffle(idx_b)
    a_rank = np.cumsum(is_a) - 1       # orbit -> position among A orbits
    b_rank = np.cumsum(~is_a) - 1      # orbit -> position among B orbits
    n_a_sats = int(is_a.sum()) * sats_per_orbit
    n_b_sats = int((~is_a).sum()) * sats_per_orbit
    parts_a = np.array_split(idx_a, n_a_sats) if n_a_sats else []
    parts_b = np.array_split(idx_b, n_b_sats) if n_b_sats else []
    out: list[np.ndarray] = []
    for orbit in range(num_orbits):
        for slot in range(sats_per_orbit):
            if is_a[orbit]:
                out.append(np.sort(
                    parts_a[a_rank[orbit] * sats_per_orbit + slot]))
            else:
                out.append(np.sort(
                    parts_b[b_rank[orbit] * sats_per_orbit + slot]))
    return out
