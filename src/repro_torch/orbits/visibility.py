"""Visibility geometry between satellites and GS/HAP stations.

Paper §II-B: satellite k and station g can communicate iff the elevation
angle of k above g's local horizon exceeds alpha_min, i.e.
    angle(r_g, r_k - r_g) <= pi/2 - alpha_min.

A HAP at 20 km sees "beyond 180 degrees" (paper §III): at altitude h_s the
local horizon is depressed by acos(R_E / (R_E + h_s)), so a HAP with the
same alpha_min sees strictly more sky than a GS — we model this with the
horizon-depression term, which is the physically correct statement of the
paper's claim.

Batched layout: ``visibility_mask`` evaluates all stations x all
satellites x all times as one broadcasted elevation test over stacked
``(n_st, T, 3)`` station and ``(S, T, 3)`` satellite position tensors
(time-chunked to bound the broadcast intermediate), with no per-pair
Python. The scalar per-pair path (``is_visible`` /
``visibility_mask_pairwise``) is retained as the equivalence reference
and benchmark baseline.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np

from repro_torch.orbits.constellation import (
    EARTH_RADIUS_M,
    Satellite,
    WalkerConstellation,
    station_position_eci,
    station_positions_eci,
)

# Size of one (n_st, S, T_chunk) float64 block of the batched elevation
# evaluation. Grids are processed in time chunks of this many bytes so
# the elementwise intermediates stay cache-resident (streaming whole
# mega-constellation grids through RAM is ~5x slower) and memory stays
# bounded regardless of grid size.
_CHUNK_BYTES = 1 << 21


@dataclasses.dataclass(frozen=True)
class Station:
    """A parameter server: GS (altitude ~0) or HAP (stratosphere ~20 km)."""
    name: str
    lat_deg: float
    lon_deg: float
    altitude_m: float = 0.0
    min_elevation_deg: float = 10.0

    def position_eci(self, t_s: float | np.ndarray) -> np.ndarray:
        return station_position_eci(
            self.lat_deg, self.lon_deg, self.altitude_m, t_s
        )

    @property
    def horizon_depression_deg(self) -> float:
        """How far below the astronomical horizon this station can see."""
        r = EARTH_RADIUS_M + self.altitude_m
        return math.degrees(math.acos(min(1.0, EARTH_RADIUS_M / r)))

    @property
    def is_hap(self) -> bool:
        return self.altitude_m > 1_000.0


# The paper's two deployment sites (§IV-A).
ROLLA = (37.9514, -91.7713)
DALLAS = (32.7767, -96.7970)


def stations_eci(
    stations: Sequence[Station], t_s: float | np.ndarray
) -> np.ndarray:
    """Stacked ECI positions of every station; shape (n_st, ...t, 3)."""
    lat = np.array([s.lat_deg for s in stations])
    lon = np.array([s.lon_deg for s in stations])
    alt = np.array([s.altitude_m for s in stations])
    return station_positions_eci(lat, lon, alt, t_s)


def effective_min_elevation_deg(stations: Sequence[Station]) -> np.ndarray:
    """Per-station alpha_min minus earned horizon depression; (n_st,)."""
    return np.array([
        s.min_elevation_deg - s.horizon_depression_deg for s in stations
    ])


def elevation_angle_deg(
    station_pos: np.ndarray, sat_pos: np.ndarray
) -> np.ndarray:
    """Elevation of the satellite above the station's local horizon plane.

    elevation = 90 deg - angle(r_g, r_k - r_g). Fully broadcastable: any
    leading dims on either position tensor.
    """
    rel = sat_pos - station_pos
    num = np.sum(station_pos * rel, axis=-1)
    den = np.linalg.norm(station_pos, axis=-1) * np.linalg.norm(rel, axis=-1)
    cosang = np.clip(num / np.maximum(den, 1e-12), -1.0, 1.0)
    return 90.0 - np.degrees(np.arccos(cosang))


def is_visible(
    station: Station, sat: Satellite, t_s: float | np.ndarray
) -> np.ndarray:
    """Feasibility condition of paper §II-B (vectorized over time).

    The effective minimum elevation is alpha_min minus the horizon
    depression earned by the station's altitude (0 for a GS). This is
    the scalar per-pair reference; grid builds go through
    :func:`visibility_mask`.
    """
    sp = station.position_eci(t_s)
    kp = sat.position_eci(t_s)
    elev = elevation_angle_deg(sp, kp)
    eff_min = station.min_elevation_deg - station.horizon_depression_deg
    return elev >= eff_min


def _iter_gram_chunks(station_pos: np.ndarray, sat_pos: np.ndarray):
    """Yield cache-sized Gram blocks of the station x satellite geometry.

    For each time chunk ``sl`` yields ``(sl, g, sp2, kp2)``: ``g`` the
    ``(Tc, n_st, S)`` dot products r_g . r_k (one batched matmul),
    ``sp2``/``kp2`` the matching ``(Tc, n_st)`` / ``(Tc, S)`` squared
    norms. Chunks are sized by ``_CHUNK_BYTES`` so the elementwise
    passes of every consumer (visibility masks, distance/delay tables)
    stay cache-resident; no (n_st, S, T, 3) temporary ever exists.
    """
    n_st, T = station_pos.shape[0], station_pos.shape[1]
    S = sat_pos.shape[0]
    sp2 = np.einsum("ntc,ntc->tn", station_pos, station_pos)
    kp2 = np.einsum("stc,stc->ts", sat_pos, sat_pos)
    chunk = max(1, _CHUNK_BYTES // max(1, n_st * S * 8))
    for i in range(0, T, chunk):
        sl = slice(i, min(i + chunk, T))
        g = station_pos[:, sl].transpose(1, 0, 2) @ \
            sat_pos[:, sl].transpose(1, 2, 0)
        yield sl, g, sp2[sl], kp2[sl]


def iter_distance_chunks(station_pos: np.ndarray, sat_pos: np.ndarray):
    """Yield ``(time_slice, (n_st, S, Tc) distances)`` over the grid.

    |r_k - r_g| expanded from the shared Gram blocks — the chunked
    pairwise-distance kernel behind the engine's SHL-delay tables.
    """
    for sl, g, sp2, kp2 in _iter_gram_chunks(station_pos, sat_pos):
        rel2 = np.maximum(
            kp2[:, None, :] - 2.0 * g + sp2[:, :, None], 0.0)
        yield sl, np.sqrt(rel2).transpose(1, 2, 0)


def mask_from_positions(
    station_pos: np.ndarray,
    sat_pos: np.ndarray,
    eff_min_deg: np.ndarray,
) -> np.ndarray:
    """Batched §II-B feasibility from precomputed position tensors.

    ``station_pos``: (n_st, T, 3); ``sat_pos``: (S, T, 3);
    ``eff_min_deg``: (n_st,). Returns (n_st, S, T) bool.

    The elevation test is evaluated in dot-product form:
        elev >= eff  <=>  cos(angle(r_g, r_k - r_g)) >= cos(90deg - eff)
    with r_g.(r_k - r_g) and |r_k - r_g|^2 expanded from the shared
    Gram blocks (:func:`_iter_gram_chunks`) — no arccos and no
    (n_st, S, T, 3) relative-position temporary.
    """
    n_st, T = station_pos.shape[0], station_pos.shape[1]
    S = sat_pos.shape[0]
    eff = np.asarray(eff_min_deg, dtype=np.float64)
    thresh = np.cos(np.radians(90.0 - eff))[None, :, None]   # (1, n_st, 1)
    out = np.empty((n_st, S, T), dtype=bool)
    for sl, g, sp2, kp2 in _iter_gram_chunks(station_pos, sat_pos):
        s2 = sp2[:, :, None]
        num = g - s2                                # r_g . (r_k - r_g)
        rel2 = np.maximum(kp2[:, None, :] - 2.0 * g + s2, 0.0)
        den = np.sqrt(s2 * rel2)                    # |r_g| |r_k - r_g|
        out[:, :, sl] = (num >= thresh * np.maximum(den, 1e-12)
                         ).transpose(1, 2, 0)
    return out


def visibility_mask(
    stations: Sequence[Station],
    constellation: WalkerConstellation,
    t_s: float | np.ndarray,
) -> np.ndarray:
    """Boolean mask [n_stations, n_sats, ...time] of who sees whom.

    One stacked-ephemeris propagation + one broadcasted elevation test —
    bit-identical to :func:`visibility_mask_pairwise` (verified in
    tests), O(stations·sats) Python eliminated.
    """
    t = np.asarray(t_s, dtype=np.float64)
    sp = stations_eci(stations, t).reshape(len(stations), -1, 3)
    kp = constellation.positions_eci(t).reshape(len(constellation), -1, 3)
    m = mask_from_positions(sp, kp, effective_min_elevation_deg(stations))
    return m.reshape((len(stations), len(constellation)) + t.shape)


def visibility_mask_pairwise(
    stations: Sequence[Station],
    constellation: WalkerConstellation,
    t_s: float | np.ndarray,
) -> np.ndarray:
    """Per-pair reference grid build (one ``is_visible`` per station x
    satellite); kept for equivalence tests and ``bench_geometry``."""
    t = np.asarray(t_s, dtype=np.float64)
    out = np.zeros((len(stations), len(constellation)) + t.shape, dtype=bool)
    for i, st in enumerate(stations):
        for j, sat in enumerate(constellation.satellites):
            out[i, j] = is_visible(st, sat, t)
    return out


def windows_from_mask(
    vis: np.ndarray, ts: np.ndarray
) -> list[tuple[float, float]]:
    """Contiguous [rise, set] intervals of one ``(T,)`` visibility series.

    Edge detection is one ``np.diff`` over the sampled series.
    """
    vis = np.asarray(vis, dtype=bool)
    if not vis.any():
        return []
    edges = np.diff(vis.astype(np.int8))
    rises = np.nonzero(edges == 1)[0] + 1
    sets_ = np.nonzero(edges == -1)[0]
    if vis[0]:
        rises = np.concatenate([[0], rises])
    if vis[-1]:
        sets_ = np.concatenate([sets_, [len(vis) - 1]])
    return [(float(ts[r]), float(ts[s])) for r, s in zip(rises, sets_)]


def visibility_windows(
    station: Station,
    sat: Satellite,
    t_start_s: float,
    t_end_s: float,
    step_s: float = 10.0,
) -> list[tuple[float, float]]:
    """Contiguous [rise, set] intervals within [t_start, t_end].

    Sampled at `step_s` resolution (the paper simulates at comparable
    granularity; windows at 2000 km last many minutes, so 10 s is ample).
    Routed through the batched mask core — one stacked position
    evaluation + :func:`windows_from_mask` — and returns exactly the
    windows the per-pair sampling used to produce.
    """
    ts = np.arange(t_start_s, t_end_s + step_s, step_s)
    sp = station_positions_eci(
        np.array([station.lat_deg]), np.array([station.lon_deg]),
        np.array([station.altitude_m]), ts)
    from repro_torch.orbits.constellation import ephemeris_positions_eci
    kp = ephemeris_positions_eci(
        np.array([EARTH_RADIUS_M + sat.altitude_m]),
        np.array([sat.inclination_rad]),
        np.array([sat.raan_rad]), np.array([sat.phase_rad]), ts)
    eff = np.array([station.min_elevation_deg
                    - station.horizon_depression_deg])
    vis = mask_from_positions(sp, kp, eff)[0, 0]
    return windows_from_mask(vis, ts)


def next_contact_table(vis: np.ndarray, dtype=np.int64) -> np.ndarray:
    """Next-contact lookup over a precomputed visibility grid.

    ``vis``: ``(..., T)`` bool time series (any leading batch dims:
    stations, orbits, satellites). Returns an int table ``nxt`` of the
    same shape where ``nxt[..., i]`` is the smallest grid index ``j >= i``
    with ``vis[..., j]`` True, or the sentinel ``T`` when no contact
    remains.

    One reversed ``minimum.accumulate`` per series replaces the O(T)
    Python scan the simulator used to run per orbit per round: contact
    queries become O(1) lookups. ``dtype`` shrinks the table for dense
    edge grids (the routing subsystem's (S, S, T) tables use int16 when
    the sentinel fits).
    """
    vis = np.asarray(vis, dtype=bool)
    T = vis.shape[-1]
    # Stored values span 0..T inclusive (T is the no-contact sentinel),
    # so the dtype must hold T itself — T == iinfo.max is still exact.
    if T > np.iinfo(dtype).max:
        raise ValueError(f"{T} time steps overflow {np.dtype(dtype).name}")
    idx = np.where(vis, np.arange(T, dtype=dtype), np.asarray(T, dtype=dtype))
    return np.minimum.accumulate(idx[..., ::-1], axis=-1)[..., ::-1]


def sat_sat_visible(
    a_pos: np.ndarray, b_pos: np.ndarray, grazing_altitude_m: float = 80_000.0
) -> np.ndarray:
    """LoS between two space objects: the chord must clear the atmosphere.

    Visibility is obstructed if the minimum distance from the Earth's center
    to the segment [a, b] drops below R_E + grazing altitude (paper Eq. 6's
    l_{a,b} condition). Fully broadcastable over leading dims.
    """
    d = b_pos - a_pos
    dd = np.sum(d * d, axis=-1)
    t = np.clip(-np.sum(a_pos * d, axis=-1) / np.maximum(dd, 1e-12), 0.0, 1.0)
    closest = a_pos + t[..., None] * d
    return np.linalg.norm(closest, axis=-1) >= EARTH_RADIUS_M + grazing_altitude_m


def isl_mask_from_positions(
    pos: np.ndarray, grazing_altitude_m: float = 80_000.0
) -> np.ndarray:
    """All-pairs ISL LoS grid from a stacked ``(S, T, 3)`` position
    tensor; returns ``(S, S, T)`` bool, evaluated in cache-sized time
    chunks of :func:`sat_sat_visible`. The diagonal is zeroed — a
    satellite has no ISL to itself, and the routing subsystem's edge
    tables must not contain self-loops.
    """
    S, T = pos.shape[0], pos.shape[1]
    out = np.empty((S, S, T), dtype=bool)
    chunk = max(1, (1 << 25) // max(1, S * S * 3 * 8))
    for i in range(0, T, chunk):
        sl = slice(i, min(i + chunk, T))
        out[:, :, sl] = sat_sat_visible(
            pos[:, None, sl, :], pos[None, :, sl, :], grazing_altitude_m)
    out[np.arange(S), np.arange(S)] = False
    return out


def isl_pairs_visible(
    pos: np.ndarray,
    a_ids: np.ndarray,
    b_ids: np.ndarray,
    grazing_altitude_m: float = 80_000.0,
) -> np.ndarray:
    """LoS series of an explicit ISL pair list (the sparse counterpart of
    :func:`isl_mask_from_positions`): ``pos`` is the stacked ``(S, T, 3)``
    ephemeris, ``a_ids``/``b_ids`` are ``(E,)`` satellite ids; returns
    ``(E, T)`` bool. Evaluated in cache-sized time chunks of the same
    elementwise :func:`sat_sat_visible` test the dense grid build runs,
    so masked CSR contact-graph builds are bit-equal to gathering the
    dense grid at the same pairs — only the pairs a locality mask keeps
    (e.g. intra-plane chords) are ever touched.
    """
    a_ids = np.asarray(a_ids, dtype=np.int64)
    b_ids = np.asarray(b_ids, dtype=np.int64)
    E, T = len(a_ids), pos.shape[1]
    out = np.empty((E, T), dtype=bool)
    chunk = max(1, (1 << 25) // max(1, E * 3 * 8))
    for i in range(0, T, chunk):
        sl = slice(i, min(i + chunk, T))
        out[:, sl] = sat_sat_visible(
            pos[a_ids, sl, :], pos[b_ids, sl, :], grazing_altitude_m)
    out[a_ids == b_ids] = False
    return out


def sat_sat_visibility_mask(
    constellation: WalkerConstellation,
    t_s: float | np.ndarray,
    grazing_altitude_m: float = 80_000.0,
) -> np.ndarray:
    """All-pairs ISL line-of-sight grid; shape (S, S, ...time) bool.

    One stacked propagation + a time-chunked (S, S, T_chunk) broadcast of
    :func:`sat_sat_visible` — the ISL-gating analogue of
    :func:`visibility_mask` feeding the contact-graph router
    (`repro.orbits.routing`). The diagonal is zero (no self-links).
    """
    t = np.asarray(t_s, dtype=np.float64)
    pos = constellation.positions_eci(t).reshape(len(constellation), -1, 3)
    S = pos.shape[0]
    return isl_mask_from_positions(pos, grazing_altitude_m).reshape(
        (S, S) + t.shape)
