"""The plan of a FedHAP simulation in plain numpy, frozen from the port's
plan code so that the reference works out by itself who trains, on
which samples, when, and with which weights.

Copied, operation for operation, from ``repro_torch``'s
``orbits/constellation.py`` (circular Walker-delta ephemeris, Earth-fixed
stations), ``orbits/visibility.py`` (the elevation mask from Gram blocks,
the next-contact table), ``orbits/links.py`` (Eq. 7 delays at Table I's
fixed 16 Mb/s), ``core/weights.py`` (Eq. 14-16 in the paper's modes),
``data/partition.py`` (the paper's non-IID orbit split),
``sim/trainer.py`` (the batched index sampler) and
``sim/strategies/fedhap.py`` with ``base.RoundStrategy.run_fused`` (the
round schedule in blocks). It imports nothing of the program.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

EARTH_RADIUS_M = 6_371_000.0
MU_EARTH = 3.986004418e14
EARTH_ROTATION_RAD_S = 7.2921159e-5
SPEED_OF_LIGHT = 299_792_458.0
LINK_RATE_BPS = 16e6            # Table I pins R for RF and FSO alike
PROCESSING_DELAY_S = 0.05
ROLLA = (37.9514, -91.7713)
_CHUNK_BYTES = 1 << 21


@dataclasses.dataclass(frozen=True)
class Station:
    lat_deg: float
    lon_deg: float
    altitude_m: float
    min_elevation_deg: float = 10.0

    @property
    def eff_min_deg(self) -> float:
        r = EARTH_RADIUS_M + self.altitude_m
        depression = math.degrees(math.acos(min(1.0, EARTH_RADIUS_M / r)))
        return self.min_elevation_deg - depression


def stations(kind: str) -> list:
    """The parameter servers: one HAP at 20 km over Rolla (the paper's
    FedHAP-oneHAP), the one set a cell uses."""
    if kind == "one_hap":
        return [Station(*ROLLA, 20e3)]
    raise ValueError(f"the reference plans no station set {kind!r}")


def walker_ephemeris(num_orbits: int, k: int, altitude_m: float,
                     inclination_deg: float):
    total = num_orbits * k
    orbit = np.arange(total) // k
    slot = np.arange(total) % k
    sma = np.full(total, EARTH_RADIUS_M + altitude_m)
    inc = np.full(total, math.radians(inclination_deg))
    raan = 2.0 * math.pi * orbit / num_orbits
    phase = 2.0 * math.pi * slot / k + 2.0 * math.pi * orbit / total
    return sma, inc, raan, phase


def sat_positions(eph, t_s) -> np.ndarray:
    """(S, ...t, 3) ECI positions of circular orbits."""
    sma, inc, raan, phase = (np.asarray(a, np.float64)[:, None] for a in eph)
    t = np.asarray(t_s, dtype=np.float64)
    t_shape = t.shape
    t = t.reshape(1, -1)
    n = 2.0 * math.pi / (2.0 * math.pi * sma ** 1.5 / math.sqrt(MU_EARTH))
    u = phase + n * t
    x_o, y_o = sma * np.cos(u), sma * np.sin(u)
    ci, si = np.cos(inc), np.sin(inc)
    co, so = np.cos(raan), np.sin(raan)
    x = co * x_o - so * ci * y_o
    y = so * x_o + co * ci * y_o
    z = si * y_o
    pos = np.stack([np.broadcast_to(x, u.shape), np.broadcast_to(y, u.shape),
                    np.broadcast_to(z, u.shape)], axis=-1)
    return pos.reshape(sma.shape[0], *t_shape, 3)


def station_positions(sts: list, t_s) -> np.ndarray:
    """(n_st, ...t, 3): stations rotating with the Earth."""
    lat = np.radians(np.array([s.lat_deg for s in sts], np.float64))[:, None]
    lon0 = np.radians(np.array([s.lon_deg for s in sts], np.float64))[:, None]
    r = (EARTH_RADIUS_M + np.array([s.altitude_m for s in sts],
                                   np.float64))[:, None]
    t = np.asarray(t_s, dtype=np.float64)
    t_shape = t.shape
    lon = lon0 + EARTH_ROTATION_RAD_S * t.reshape(1, -1)
    x = r * np.cos(lat) * np.cos(lon)
    y = r * np.cos(lat) * np.sin(lon)
    z = (r * np.sin(lat)) * np.ones_like(lon)
    return np.stack([x, y, z], axis=-1).reshape(lat.shape[0], *t_shape, 3)


def _gram_chunks(sp: np.ndarray, kp: np.ndarray):
    n_st, T = sp.shape[0], sp.shape[1]
    S = kp.shape[0]
    sp2 = np.einsum("ntc,ntc->tn", sp, sp)
    kp2 = np.einsum("stc,stc->ts", kp, kp)
    chunk = max(1, _CHUNK_BYTES // max(1, n_st * S * 8))
    for i in range(0, T, chunk):
        sl = slice(i, min(i + chunk, T))
        g = sp[:, sl].transpose(1, 0, 2) @ kp[:, sl].transpose(1, 2, 0)
        yield sl, g, sp2[sl], kp2[sl]


def visibility(sp: np.ndarray, kp: np.ndarray, eff_min: np.ndarray):
    """(n_st, S, T) bool: elevation above each station's effective
    minimum, in dot-product form."""
    n_st, T, S = sp.shape[0], sp.shape[1], kp.shape[0]
    thresh = np.cos(np.radians(90.0 - eff_min))[None, :, None]
    out = np.empty((n_st, S, T), dtype=bool)
    for sl, g, sp2, kp2 in _gram_chunks(sp, kp):
        s2 = sp2[:, :, None]
        num = g - s2
        rel2 = np.maximum(kp2[:, None, :] - 2.0 * g + s2, 0.0)
        den = np.sqrt(s2 * rel2)
        out[:, :, sl] = (num >= thresh * np.maximum(den, 1e-12)
                         ).transpose(1, 2, 0)
    return out


def transfer_delay_s(n_params: int, distance_m) -> np.ndarray:
    """Eq. 7 for a model of ``n_params`` f32 values at Table I's rate
    (RF and FSO alike)."""
    d = np.asarray(distance_m, dtype=np.float64)
    rate = np.full(d.shape, LINK_RATE_BPS)
    return (float(n_params) * 32 / rate + distance_m / SPEED_OF_LIGHT
            + 2.0 * PROCESSING_DELAY_S)


def delay_table(sp, kp, n_params: int) -> np.ndarray:
    out = np.empty((sp.shape[0], kp.shape[0], sp.shape[1]), dtype=np.float32)
    for sl, g, sp2, kp2 in _gram_chunks(sp, kp):
        rel2 = np.maximum(kp2[:, None, :] - 2.0 * g + sp2[:, :, None], 0.0)
        out[:, :, sl] = transfer_delay_s(n_params,
                                         np.sqrt(rel2).transpose(1, 2, 0))
    return out


def next_contact(vis: np.ndarray) -> np.ndarray:
    T = vis.shape[-1]
    idx = np.where(vis, np.arange(T, dtype=np.int64), np.int64(T))
    return np.minimum.accumulate(idx[..., ::-1], axis=-1)[..., ::-1]


# ------------------------------------------------------------ Eq. 14-16
def chain_stats(visible: np.ndarray, sizes: np.ndarray):
    """Per-slot chain weight and segment mass of each ring, paper mode."""
    visible = np.asarray(visible).astype(bool)
    k = visible.shape[-1]
    m_orbit = sizes.sum(axis=-1, keepdims=True)
    safe = np.where(m_orbit > 0, m_orbit, 1.0)
    suffix = np.ones_like(sizes)
    seg = sizes
    done = np.zeros_like(visible)
    for step in range(1, k):
        nxt_vis = np.roll(visible, -step, axis=-1)
        nxt_sz = np.roll(sizes, -step, axis=-1)
        active = (~done) & (~nxt_vis)
        suffix = np.where(active, suffix * (1.0 - nxt_sz / safe), suffix)
        seg = np.where(active, seg + nxt_sz, seg)
        done = done | nxt_vis
    prefix = np.zeros_like(sizes)
    back = visible
    for step in range(1, k):
        prefix = np.where(back, prefix,
                          prefix + np.roll(sizes, step, axis=-1))
        back = back | np.roll(visible, step, axis=-1)
    seg_mass = prefix + seg
    lam = np.where(visible, 1.0, sizes / safe) * suffix
    anyv = visible.any(axis=-1, keepdims=True)
    return np.where(anyv, lam, 0.0), np.where(anyv, seg_mass, 0.0)


def mu_paper(visible: np.ndarray, sizes: np.ndarray) -> np.ndarray:
    """Eq. 16 with every orbit normalised by its own mass, the orbits
    averaged: ``(L, K)`` global weights."""
    lam, seg_mass = chain_stats(visible, sizes)
    m_orbit = sizes.sum(axis=-1, keepdims=True)
    safe = np.where(m_orbit > 0, m_orbit, 1.0)
    return seg_mass / safe * lam / lam.shape[0]


def segment_ends(visible: np.ndarray) -> np.ndarray:
    v = np.asarray(visible, dtype=bool)
    k = v.shape[-1]
    dbl = np.concatenate([v, v], axis=-1)
    idx = np.where(dbl, np.arange(2 * k), 2 * k)
    nxt = np.minimum.accumulate(idx[..., ::-1], axis=-1)[..., ::-1]
    ends = nxt[..., 1:k + 1] % k
    return np.where(v.any(axis=-1, keepdims=True), ends, -1).astype(np.int64)


# --------------------------------------------------------------- data
def partition_noniid(labels: np.ndarray, num_orbits: int, k: int,
                     seed: int) -> list:
    """The paper's split: the first ceil(0.6 L) orbits hold classes 0-5,
    the others 6-9, shuffled and split evenly per satellite."""
    rng = np.random.default_rng(seed)
    is_a = np.zeros(num_orbits, dtype=bool)
    is_a[:max(1, int(np.ceil(0.6 * num_orbits)))] = True
    idx_a = np.nonzero(np.isin(labels, [0, 1, 2, 3, 4, 5]))[0]
    idx_b = np.nonzero(np.isin(labels, [6, 7, 8, 9]))[0]
    rng.shuffle(idx_a)
    rng.shuffle(idx_b)
    a_rank, b_rank = np.cumsum(is_a) - 1, np.cumsum(~is_a) - 1
    n_a, n_b = int(is_a.sum()) * k, int((~is_a).sum()) * k
    parts_a = np.array_split(idx_a, n_a) if n_a else []
    parts_b = np.array_split(idx_b, n_b) if n_b else []
    out = []
    for orbit in range(num_orbits):
        for slot in range(k):
            part = (parts_a[a_rank[orbit] * k + slot] if is_a[orbit]
                    else parts_b[b_rank[orbit] * k + slot])
            out.append(np.sort(part))
    return out


def padded(parts: list):
    sizes = np.array([len(p) for p in parts])
    pad = np.empty((len(parts), int(sizes.max())), dtype=np.int64)
    for c, ix in enumerate(parts):
        pad[c, :len(ix)] = ix
        pad[c, len(ix):] = ix[0]
    return pad, sizes


def sample_indices(pad: np.ndarray, sizes: np.ndarray, need: int,
                   rng: np.random.Generator) -> np.ndarray:
    """Every satellite's ``need`` global sample indices for one burst:
    without replacement where its shard covers the burst (the smallest
    of per-row uniform keys), else ``floor(u * size)``."""
    n = len(sizes)
    local = np.empty((n, need), dtype=np.int64)
    small = sizes < need
    if small.any():
        r = rng.random((int(small.sum()), need))
        bound = sizes[small][:, None]
        local[small] = np.minimum((r * bound).astype(np.int64), bound - 1)
    if (~small).any():
        keys = rng.random((int((~small).sum()), pad.shape[1]))
        ok = np.arange(pad.shape[1])[None, :] < sizes[~small][:, None]
        local[~small] = np.argsort(np.where(ok, keys, np.inf),
                                   axis=1)[:, :need]
    return pad[np.arange(n)[:, None], local]


# --------------------------------------------------------------- plan
class Plan:
    """The world of one FedHAP run: the visibility and delay grids, the
    partition, and the round schedule."""

    def __init__(self, sim: dict, labels: np.ndarray, n_params: int):
        self.sim = sim
        L, k = sim["num_orbits"], sim["sats_per_orbit"]
        self.L, self.k = L, k
        self.step = sim["time_step_s"]
        self.horizon_s = sim["horizon_h"] * 3600.0
        n_steps = int(sim["horizon_h"] * 3600 / self.step) + 2
        grid_t = np.arange(n_steps) * self.step
        sts = stations(sim["stations"])
        eph = walker_ephemeris(L, k, sim["altitude_m"],
                               sim["inclination_deg"])
        sp = station_positions(sts, grid_t)
        kp = sat_positions(eph, grid_t)
        self.vis = visibility(sp, kp, np.array([s.eff_min_deg
                                                for s in sts]))
        self.shl = delay_table(sp, kp, n_params)
        any_vis = self.vis.any(axis=0)
        self.orbit_next = next_contact(any_vis.reshape(L, k, -1).any(axis=1))
        a, b = sat_positions(eph, 0.0)[:2]
        self.isl = transfer_delay_s(n_params, float(np.linalg.norm(a - b)))
        self.train_t = sim["local_steps"] * sim["compute_s_per_step"]
        n_eval = sim["eval_samples"]
        self.parts = partition_noniid(labels[n_eval:], L, k, sim["seed"])
        self.sizes = np.array([len(p) for p in self.parts], np.float64)
        self.pad, self.int_sizes = padded(self.parts)
        self.rng = np.random.default_rng(sim["seed"])

    def tidx(self, t) -> np.ndarray:
        t = np.asarray(t, dtype=np.float64)
        return np.minimum((t / self.step).astype(np.int64),
                          self.vis.shape[2] - 1)

    def round(self, t: float):
        """``(mu (S,), t_next)`` of the round starting at ``t``, or None
        where an orbit has no contact left before the horizon."""
        L, k = self.L, self.k
        T = self.orbit_next.shape[1]
        i0 = int(t / self.step)
        j = self.orbit_next[:, min(i0, T - 1)]
        tt = t + np.maximum(0, j - i0) * self.step
        orbit_t = np.where((j < T) & (tt <= self.horizon_s), tt, np.nan)
        if np.isnan(orbit_t).any():
            return None
        tidx = self.tidx(orbit_t)
        rows = self.vis[:, :, tidx].reshape(self.vis.shape[0], L, k, L)
        vis_rows = rows[:, np.arange(L), :, np.arange(L)]
        any_vis = vis_rows.any(axis=1)
        mu = mu_paper(any_vis, self.sizes.reshape(L, k)).reshape(-1)
        seg_end = segment_ends(any_vis)
        owner = np.where(vis_rows.any(axis=1), vis_rows.argmax(axis=1), 0)
        counts = np.zeros((L, k), dtype=np.int64)
        np.add.at(counts, (np.arange(L)[:, None], seg_end), 1)
        sat_ids = np.arange(L)[:, None] * k + np.arange(k)[None, :]
        shl = self.shl[owner, sat_ids, tidx[:, None]].astype(np.float64)
        lat = self.train_t + counts * self.isl + shl
        round_end = max(t, float((orbit_t[:, None] + lat)[counts > 0].max()))
        return mu, round_end      # one station: no inter-HAP ring

    def blocks(self, block: int, max_rounds: int):
        """The schedule in blocks of ``block`` rounds, as the fused loop
        plans it: lists of ``(mu, t_next, idx)``, each round's sample
        indices drawn in round order. Stops where the run would."""
        t, events = 0.0, 0
        need = self.sim["local_steps"] * self.sim["batch_size"]
        while events < max_rounds and t <= self.horizon_s:
            plans = []
            while (len(plans) < block and events + len(plans) < max_rounds
                   and t <= self.horizon_s):
                r = self.round(t)
                if r is None:
                    break
                plans.append(r)
                t = r[1]
            if not plans:
                return
            out = [(mu, t_next,
                    sample_indices(self.pad, self.int_sizes, need, self.rng))
                   for mu, t_next in plans]
            terminal = len(plans) < block and r is None
            yield out
            events += len(out)
            if terminal:
                return
