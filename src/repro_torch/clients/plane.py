"""Virtual-client plane: who trains on what, per round.

The engine's historical data plane gives each satellite one static
``FederatedData`` shard.  This module generalizes that into a *plane*:
an object the engine asks, at every training point, "which global
sample indices does each participating satellite train on right now?"
The answer is always a ``(C, local_steps * batch)`` int64 table that
feeds the existing gather -> vmapped-SGD path (and the fused
executor's schedule tensors) unchanged.

Three plane families, selected by ``SimConfig.clients``:

``static``
    The historical behavior, byte-for-byte: delegates to
    ``LocalTrainer.sample_client_indices`` drawing from the engine's
    shared rng stream, so existing histories are bit-identical.

``sampled:FRAC[xCLIENTS]``
    Thousands of virtual ground clients (default ``10 * n_sats``)
    partitioned by any registered partitioner and multiplexed onto
    satellites through a block client->satellite assignment table.
    Each round an i.i.d. Bernoulli(FRAC) participation draw picks the
    active clients; every satellite trains on mini-batches drawn from
    the union of its *active* clients' samples.  Sampling uses a
    plane-private counter-keyed PRNG (one stream per resolve call), so
    the fused plan-ahead driver and the per-round reference — which
    resolve rounds in the same order — see identical draws.

``geo:REGIONSxCLIENTS[@FRAC]``
    The streaming-acquisition plane: clients live in lat/lon regions
    on a global grid, and a satellite can only read a client's samples
    after its ground track has crossed that client's region (computed
    from the same batched ephemeris/visibility machinery the engine
    uses for station contacts, with a tight elevation cone standing in
    for the sensor footprint).  Acquisition is cumulative, so
    per-satellite training distributions drift as coverage accrues;
    satellites that have not yet crossed any populated region fall
    back to their static bootstrap shard.

Grammar summary (``SimConfig.clients``)::

    static                      # default; bit-identical to history
    sampled:0.1                 # 10% participation, 10*n_sats clients
    sampled:0.25x5000           # 25% participation, 5000 clients
    geo:64x10000                # 64 regions, 10k clients, frac 0.1
    geo:64x10000@0.05           # same, 5% participation
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np

from repro_torch.clients.partitioners import label_histograms, partition
from repro_torch.data.loader import FederatedData
from repro_torch.orbits.visibility import (Station, effective_min_elevation_deg,
                                     mask_from_positions, stations_eci)

# Salt for the plane-private PRNG streams (arbitrary, fixed forever).
_PLANE_SALT = 0x5A7C11E7


@dataclasses.dataclass
class VirtualClients:
    """CSR view over per-virtual-client global sample indices."""

    idx: np.ndarray       # (total,) concatenated per-client indices
    ptr: np.ndarray       # (V + 1,) CSR offsets into idx
    sizes: np.ndarray     # (V,) shard sizes
    labels: np.ndarray    # (N,) dataset labels (for histograms)

    @classmethod
    def from_parts(cls, parts: Sequence[np.ndarray],
                   labels: np.ndarray) -> "VirtualClients":
        sizes = np.array([len(p) for p in parts], dtype=np.int64)
        ptr = np.zeros(len(parts) + 1, dtype=np.int64)
        np.cumsum(sizes, out=ptr[1:])
        idx = (np.concatenate(parts) if len(parts)
               else np.empty(0, dtype=np.int64)).astype(np.int64)
        return cls(idx=idx, ptr=ptr, sizes=sizes, labels=np.asarray(labels))

    @property
    def num_clients(self) -> int:
        return len(self.sizes)

    def client_indices(self, c: int) -> np.ndarray:
        return self.idx[self.ptr[c]:self.ptr[c + 1]]

    def histograms(self, num_classes: int | None = None) -> np.ndarray:
        """Per-client label histograms, ``(V, num_classes)``."""
        parts = [self.client_indices(c) for c in range(self.num_clients)]
        return label_histograms(self.labels, parts, num_classes)


class ClientPlane:
    """Base resolve interface; subclasses fill ``sample_indices``."""

    name = "static"

    def sample_indices(self, sats: Sequence[int],
                       t_s: float) -> np.ndarray:
        """``(len(sats), need)`` int64 global indices for time ``t_s``."""
        raise NotImplementedError

    def describe(self) -> dict:
        return {"kind": self.name}


class StaticPlane(ClientPlane):
    """Historical one-shard-per-satellite plane (bit-identical).

    Draws from the engine's shared rng Generator through the exact
    ``sample_client_indices`` call the strategies used to make, in the
    exact call order, so ``clients="static"`` reproduces pre-plane
    histories bit-for-bit on every strategy, fused and per-round.
    """

    def __init__(self, trainer, fd: FederatedData,
                 rng: np.random.Generator, local_steps: int):
        self._trainer = trainer
        self._fd = fd
        self._rng = rng
        self._steps = local_steps

    def sample_indices(self, sats: Sequence[int],
                       t_s: float = 0.0) -> np.ndarray:
        return self._trainer.sample_client_indices(
            self._fd, sats, self._steps, self._rng)

    def describe(self) -> dict:
        return {"kind": "static", "clients": self._fd.num_clients}


def _flat_gather(cl: VirtualClients, act_ids: np.ndarray) -> np.ndarray:
    """Concatenate the given clients' sample indices (vectorized)."""
    lens = cl.sizes[act_ids]
    total = int(lens.sum())
    if total == 0:
        return np.empty(0, dtype=np.int64)
    within = np.arange(total) - np.repeat(np.cumsum(lens) - lens, lens)
    return cl.idx[np.repeat(cl.ptr[act_ids], lens) + within]


class SampledPlane(ClientPlane):
    """Virtual clients + per-round Bernoulli participation sampling.

    Every resolve draws one i.i.d. Bernoulli(frac) participation vector
    over the virtual clients, builds the flat pool of the participating
    clients' samples grouped by satellite (pure-numpy repeat/cumsum —
    no per-satellite Python), and samples each listed satellite's
    mini-batch stream uniformly from its pool segment.
    """

    name = "sampled"

    def __init__(self, clients: VirtualClients, sat_clients: np.ndarray,
                 sat_ptr: np.ndarray, frac: float, need: int, seed: int):
        if not 0.0 < frac <= 1.0:
            raise ValueError(f"participation fraction {frac} not in (0, 1]")
        self.clients = clients
        self._sat_clients = np.asarray(sat_clients, dtype=np.int64)
        self._sat_ptr = np.asarray(sat_ptr, dtype=np.int64)
        n_sats = len(sat_ptr) - 1
        self._n_sats = n_sats
        # client -> owning satellite (inverse of the CSR assignment).
        # GeoPlane passes a degenerate empty CSR (acquisition replaces
        # ownership), in which case the inverse map is left as zeros.
        self._sat_of = np.zeros(clients.num_clients, dtype=np.int64)
        if self._sat_ptr[-1] == len(self._sat_clients):
            self._sat_of[self._sat_clients] = np.repeat(
                np.arange(n_sats), np.diff(self._sat_ptr))
        # per-satellite fallback client (first non-empty assigned one)
        self._fallback = np.full(n_sats, -1, dtype=np.int64)
        for s in range(n_sats):
            ids = self._sat_clients[self._sat_ptr[s]:self._sat_ptr[s + 1]]
            nonempty = ids[clients.sizes[ids] > 0]
            if len(nonempty):
                self._fallback[s] = nonempty[0]
        self.frac = frac
        self._need = need
        self._seed = seed
        self._calls = 0                   # resolve counter -> PRNG stream

    # -- deterministic per-resolve stream ------------------------------
    def _next_rng(self) -> np.random.Generator:
        rng = np.random.default_rng((self._seed, _PLANE_SALT, self._calls))
        self._calls += 1
        return rng

    def _participation(self, rng: np.random.Generator) -> np.ndarray:
        """Active-client mask for this resolve (size-0 clients never)."""
        u = rng.random(self.clients.num_clients)
        active = (u < self.frac) & (self.clients.sizes > 0)
        if not active.any():   # degenerate frac: keep the round alive
            nonempty = np.nonzero(self.clients.sizes > 0)[0]
            active[nonempty[np.argmin(u[nonempty])]] = True
        return active

    def _sat_client_ids(self, sat: int) -> np.ndarray:
        return self._sat_clients[self._sat_ptr[sat]:self._sat_ptr[sat + 1]]

    def sample_indices(self, sats: Sequence[int],
                       t_s: float = 0.0) -> np.ndarray:
        rng = self._next_rng()
        active = self._participation(rng)
        sats = np.asarray(sats, dtype=np.int64)
        draws = rng.random((len(sats), self._need))
        cl = self.clients
        # Flat round pool grouped by satellite.
        act_ids = np.nonzero(active)[0]
        act_ids = act_ids[np.argsort(self._sat_of[act_ids],
                                     kind="stable")]
        pool = _flat_gather(cl, act_ids)
        sat_sizes = np.zeros(self._n_sats, dtype=np.int64)
        np.add.at(sat_sizes, self._sat_of[act_ids], cl.sizes[act_ids])
        sat_ptr = np.zeros(self._n_sats + 1, dtype=np.int64)
        np.cumsum(sat_sizes, out=sat_ptr[1:])

        totals = sat_sizes[sats]
        t = np.minimum((draws * totals[:, None]).astype(np.int64),
                       np.maximum(totals, 1)[:, None] - 1)
        out = pool[np.minimum(sat_ptr[sats][:, None] + t,
                              max(len(pool) - 1, 0))] if len(pool) else \
            np.zeros((len(sats), self._need), dtype=np.int64)
        # Satellites whose assigned clients all sat out this round fall
        # back to their first non-empty assigned client.
        empty = np.nonzero(totals == 0)[0]
        for i in empty:
            fb = self._fallback[sats[i]]
            if fb < 0:
                raise ValueError(
                    f"satellite {int(sats[i])} has no non-empty clients")
            ix = cl.client_indices(int(fb))
            out[i] = ix[np.minimum((draws[i] * len(ix)).astype(np.int64),
                                   len(ix) - 1)]
        return out

    def describe(self) -> dict:
        return {"kind": self.name, "clients": self.clients.num_clients,
                "frac": self.frac}


class GeoPlane(SampledPlane):
    """Geo-keyed streaming acquisition over lat/lon client regions.

    ``acq_t[r, s]`` is the first visibility-grid step at which
    satellite ``s``'s ground track crosses region ``r`` (``T`` when it
    never does within the horizon).  At resolve time ``t_s`` a
    satellite's candidate pool is the union of samples of *active*
    (participating) clients living in regions already acquired —
    cumulative coverage, so distributions drift orbit over orbit.
    """

    name = "geo"

    def __init__(self, clients: VirtualClients, region_of: np.ndarray,
                 acq_t: np.ndarray, time_step_s: float, frac: float,
                 need: int, seed: int,
                 bootstrap: FederatedData | None = None):
        n_sats = acq_t.shape[1]
        # Geo acquisition replaces the assignment table: every
        # satellite may reach every client, gated by acq_t.
        ids = np.arange(clients.num_clients, dtype=np.int64)
        super().__init__(
            clients, sat_clients=ids,
            sat_ptr=np.arange(n_sats + 1, dtype=np.int64) * 0,
            frac=frac, need=need, seed=seed)
        self.region_of = np.asarray(region_of, dtype=np.int64)
        self.acq_t = np.asarray(acq_t, dtype=np.int64)
        self._step = float(time_step_s)
        self._T = int(acq_t.max(initial=0) + 1)
        self._bootstrap = bootstrap
        # region -> member clients CSR (static; pools built per round).
        order = np.argsort(self.region_of, kind="stable")
        self._reg_members = order
        counts = np.bincount(self.region_of, minlength=acq_t.shape[0])
        self._reg_ptr = np.zeros(acq_t.shape[0] + 1, dtype=np.int64)
        np.cumsum(counts, out=self._reg_ptr[1:])

    def acquired_mask(self, t_s: float) -> np.ndarray:
        """``(R, n_sats)`` bool: region r acquired by satellite s."""
        tidx = int(t_s // self._step)
        return self.acq_t <= tidx

    def acquired_fraction(self, t_s: float) -> float:
        return float(self.acquired_mask(t_s).mean())

    def sample_indices(self, sats: Sequence[int],
                       t_s: float = 0.0) -> np.ndarray:
        rng = self._next_rng()
        active = self._participation(rng)
        sats = np.asarray(sats, dtype=np.int64)
        draws = rng.random((len(sats), self._need))
        acq = self.acquired_mask(t_s)        # (R, n_sats)
        cl = self.clients
        n_regions = acq.shape[0]
        # Flat round pool grouped by region: participating members'
        # samples (region-sorted member order keeps segments aligned).
        act_members = self._reg_members[active[self._reg_members]]
        pool = _flat_gather(cl, act_members)
        pool_sizes = np.zeros(n_regions, dtype=np.int64)
        np.add.at(pool_sizes, self.region_of[act_members],
                  cl.sizes[act_members])
        pool_ptr = np.zeros(n_regions + 1, dtype=np.int64)
        np.cumsum(pool_sizes, out=pool_ptr[1:])

        # Satellites sharing a reachable-region set (identical acq
        # column — the common case once coverage saturates) are grouped
        # so each group's reachable pool is materialised once and every
        # draw maps through a direct floor(u * total) index; no
        # per-draw searchsorted.
        reach = acq[:, sats] & (pool_sizes > 0)[:, None]     # (R, C)
        uniq, inv = np.unique(reach, axis=1, return_inverse=True)
        out = np.empty((len(sats), self._need), dtype=np.int64)
        for g in range(uniq.shape[1]):
            rows = np.nonzero(inv == g)[0]
            regs = np.nonzero(uniq[:, g])[0]
            gpool = (np.concatenate(
                [pool[pool_ptr[r]:pool_ptr[r + 1]] for r in regs])
                if len(regs) else np.empty(0, dtype=np.int64))
            if len(gpool):
                t = np.minimum((draws[rows] * len(gpool)).astype(np.int64),
                               len(gpool) - 1)
                out[rows] = gpool[t]
            else:
                # No acquired+populated region yet: fall back to the
                # static bootstrap shard (pre-first-crossing warmup).
                for i in rows:
                    out[i] = self._bootstrap_row(int(sats[i]), draws[i])
        return out

    def _bootstrap_row(self, sat: int, u: np.ndarray) -> np.ndarray:
        """Pre-acquisition fallback: the satellite's static shard."""
        if self._bootstrap is None:
            raise ValueError(
                f"satellite {sat} has acquired no populated region and "
                "no bootstrap shard was provided")
        ix = self._bootstrap.client_indices[sat]
        sel = np.minimum((u * len(ix)).astype(np.int64), len(ix) - 1)
        return ix[sel]

    def describe(self) -> dict:
        return {"kind": self.name, "clients": self.clients.num_clients,
                "regions": int(self.acq_t.shape[0]), "frac": self.frac}


# ----------------------------------------------------------------------
# Region grid + acquisition table for the geo plane.

def region_grid(n_regions: int, footprint_elevation_deg: float = 40.0
                ) -> list[Station]:
    """~n_regions anchor points on a lat/lon grid between +-55 deg.

    Regions are modeled as ground anchors with a tight elevation cone:
    a satellite "crosses" the region while the anchor sees it above
    ``footprint_elevation_deg`` — the same Gram-form visibility math as
    station contacts, reused as a sensor-footprint test.
    """
    rows = max(1, int(round(math.sqrt(n_regions / 2))))
    cols = max(1, int(math.ceil(n_regions / rows)))
    out = []
    for r in range(rows):
        lat = -55.0 + 110.0 * (r + 0.5) / rows
        for c in range(cols):
            lon = -180.0 + 360.0 * (c + 0.5) / cols
            out.append(Station(
                name=f"region-{len(out)}", lat_deg=lat, lon_deg=lon,
                min_elevation_deg=footprint_elevation_deg))
            if len(out) == n_regions:
                return out
    return out


def first_crossing_table(
    regions: Sequence[Station], grid_t: np.ndarray, sat_pos: np.ndarray,
    chunk: int = 256,
) -> np.ndarray:
    """``(R, S)`` int64 first grid step each satellite crosses each region.

    Streams the ``(R, S, T)`` visibility mask in time chunks (never
    materializing it whole) and early-exits once every pair has a
    crossing.  Pairs that never cross within the horizon get ``T``.
    """
    T = len(grid_t)
    reg_pos = stations_eci(list(regions), grid_t)        # (R, T, 3)
    eff = effective_min_elevation_deg(list(regions))
    first = np.full((len(regions), sat_pos.shape[0]), T, dtype=np.int64)
    for i0 in range(0, T, chunk):
        sl = slice(i0, min(i0 + chunk, T))
        m = mask_from_positions(reg_pos[:, sl], sat_pos[:, sl], eff)
        hit = m.any(axis=2)
        t_hit = i0 + m.argmax(axis=2)
        np.minimum(first, np.where(hit, t_hit, T), out=first)
        if (first < T).all():
            break
    return first


# ----------------------------------------------------------------------
# Spec grammar -> plane construction.

def _split_virtual_clients(
    labels: np.ndarray, n_clients: int, n_sats: int, seed: int,
    partitioner: str, partitioner_kw: dict | None,
) -> tuple[VirtualClients, np.ndarray, np.ndarray]:
    parts = partition(partitioner, labels, n_clients, seed=seed,
                      **(partitioner_kw or {}))
    clients = VirtualClients.from_parts(parts, labels)
    # Block client -> satellite assignment: contiguous, near-equal.
    groups = np.array_split(np.arange(n_clients, dtype=np.int64), n_sats)
    sat_ptr = np.zeros(n_sats + 1, dtype=np.int64)
    np.cumsum([len(g) for g in groups], out=sat_ptr[1:])
    return clients, np.concatenate(groups), sat_ptr


def build_plane(
    spec: str,
    *,
    trainer,
    fd: FederatedData,
    rng: np.random.Generator,
    local_steps: int,
    seed: int = 0,
    partitioner: str = "iid",
    partitioner_kw: dict | None = None,
    grid_t: np.ndarray | None = None,
    sat_positions: np.ndarray | None = None,
    time_step_s: float = 30.0,
) -> ClientPlane:
    """Parse a ``SimConfig.clients`` spec and build the plane.

    ``grid_t`` / ``sat_positions`` are only needed for ``geo:`` specs
    (the engine passes its already-propagated ephemerides).
    """
    need = local_steps * trainer.batch_size
    n_sats = fd.num_clients
    if spec == "static":
        return StaticPlane(trainer, fd, rng, local_steps)

    kind, _, arg = spec.partition(":")
    if kind == "sampled":
        if not arg:
            raise ValueError("sampled spec needs a fraction: sampled:FRAC")
        frac_s, _, count_s = arg.partition("x")
        frac = float(frac_s)
        n_clients = int(count_s) if count_s else 10 * n_sats
        clients, sat_clients, sat_ptr = _split_virtual_clients(
            fd.labels, n_clients, n_sats, seed, partitioner, partitioner_kw)
        return SampledPlane(clients, sat_clients, sat_ptr, frac, need, seed)

    if kind == "geo":
        if grid_t is None or sat_positions is None:
            raise ValueError("geo plane needs grid_t and sat_positions")
        head, _, frac_s = arg.partition("@")
        reg_s, _, count_s = head.partition("x")
        if not reg_s or not count_s:
            raise ValueError(
                f"geo spec must be geo:REGIONSxCLIENTS[@FRAC], got {spec!r}")
        n_regions, n_clients = int(reg_s), int(count_s)
        frac = float(frac_s) if frac_s else 0.1
        clients, _, _ = _split_virtual_clients(
            fd.labels, n_clients, n_sats, seed, partitioner, partitioner_kw)
        regions = region_grid(n_regions)
        acq_t = first_crossing_table(regions, grid_t, sat_positions)
        # Contiguous client blocks -> regions, so partitioner block
        # structure maps onto geography (nearby regions, similar data).
        region_of = (np.arange(n_clients, dtype=np.int64)
                     * len(regions) // n_clients)
        return GeoPlane(clients, region_of, acq_t, time_step_s, frac,
                        need, seed, bootstrap=fd)

    raise ValueError(
        f"unknown clients spec {spec!r}; expected 'static', "
        "'sampled:FRAC[xCLIENTS]', or 'geo:REGIONSxCLIENTS[@FRAC]'")
