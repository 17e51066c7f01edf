"""Walker-delta constellation kinematics (paper §II, Fig. 1).

We model circular orbits. Satellite positions are computed in an
Earth-centered inertial (ECI) frame; ground/HAP stations rotate with the
Earth (see `visibility.Station`). All units SI unless suffixed.

The paper's setup (§IV-A): L=5 orbits x K=8 satellites, h=2000 km,
inclination 80 deg, Walker-delta phasing.

Ephemeris layout: besides the per-object :class:`Satellite` list (kept
for scheduling code that reasons about individual spacecraft),
:class:`WalkerConstellation` carries a *stacked ephemeris* — flat
``(S,)`` float64 arrays ``sma_m`` (semi-major axis), ``inclination``,
``raan``, ``phase`` in satellite-id order. ``positions_eci`` and
``ephemeris_positions_eci`` propagate every satellite for every query
time as one broadcasted ``(S, T, 3)`` evaluation with no per-satellite
Python, which is what lets the visibility/delay grids scale to
mega-constellations (100+ satellite shells).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

# Physical constants.
EARTH_RADIUS_M = 6_371_000.0          # R_E
MU_EARTH = 3.986004418e14             # G*M (m^3/s^2)
EARTH_ROTATION_RAD_S = 7.2921159e-5   # sidereal rotation rate
SPEED_OF_LIGHT = 299_792_458.0


def orbital_period_s(altitude_m: float) -> float:
    """T = 2*pi/sqrt(GM) * (R_E + h)^{3/2}   (paper §II)."""
    a = EARTH_RADIUS_M + altitude_m
    return 2.0 * math.pi * a ** 1.5 / math.sqrt(MU_EARTH)


def orbital_speed_ms(altitude_m: float) -> float:
    """v = 2*pi*(R_E + h) / T   (paper §II)."""
    a = EARTH_RADIUS_M + altitude_m
    return 2.0 * math.pi * a / orbital_period_s(altitude_m)


@dataclasses.dataclass(frozen=True)
class Satellite:
    """A single LEO satellite on a circular orbit.

    Identified by (orbit index, slot index) and a globally unique `sat_id`
    — the paper's dedup (Eq. 15) keys on satellite IDs.
    """
    sat_id: int
    orbit: int
    slot: int
    altitude_m: float
    inclination_rad: float
    raan_rad: float        # right ascension of ascending node (orbit plane)
    phase_rad: float       # initial along-track anomaly

    @property
    def period_s(self) -> float:
        return orbital_period_s(self.altitude_m)

    def position_eci(self, t_s: float | np.ndarray) -> np.ndarray:
        """ECI position at time(s) `t_s`; shape (..., 3)."""
        t = np.asarray(t_s, dtype=np.float64)
        a = EARTH_RADIUS_M + self.altitude_m
        n = 2.0 * math.pi / self.period_s           # mean motion
        u = self.phase_rad + n * t                   # argument of latitude
        # Position in the orbital plane.
        x_o = a * np.cos(u)
        y_o = a * np.sin(u)
        # Rotate by inclination about x, then RAAN about z.
        ci, si = math.cos(self.inclination_rad), math.sin(self.inclination_rad)
        co, so = math.cos(self.raan_rad), math.sin(self.raan_rad)
        x = co * x_o - so * ci * y_o
        y = so * x_o + co * ci * y_o
        z = si * y_o
        return np.stack([x, y, z], axis=-1)


def ephemeris_positions_eci(
    sma_m: np.ndarray,
    inclination_rad: np.ndarray,
    raan_rad: np.ndarray,
    phase_rad: np.ndarray,
    t_s: float | np.ndarray,
) -> np.ndarray:
    """Batched circular-orbit propagation; shape (S, ...t, 3).

    All four ephemeris arrays are ``(S,)``; ``t_s`` may be scalar or any
    shape ``(...t)``. One broadcasted evaluation computes every satellite
    at every time — the array-native core behind
    :meth:`WalkerConstellation.positions_eci` and the visibility/delay
    grids. The arithmetic mirrors :meth:`Satellite.position_eci`
    operation-for-operation so batched and per-object paths agree.
    """
    sma = np.asarray(sma_m, dtype=np.float64)[:, None]
    inc = np.asarray(inclination_rad, dtype=np.float64)[:, None]
    raan = np.asarray(raan_rad, dtype=np.float64)[:, None]
    phase = np.asarray(phase_rad, dtype=np.float64)[:, None]
    t = np.asarray(t_s, dtype=np.float64)
    t_shape = t.shape                        # () for scalar queries
    t = t.reshape(1, -1)

    n = 2.0 * math.pi / (2.0 * math.pi * sma ** 1.5 / math.sqrt(MU_EARTH))
    u = phase + n * t                       # argument of latitude (S, T)
    x_o = sma * np.cos(u)
    y_o = sma * np.sin(u)
    ci, si = np.cos(inc), np.sin(inc)
    co, so = np.cos(raan), np.sin(raan)
    x = co * x_o - so * ci * y_o
    y = so * x_o + co * ci * y_o
    z = si * y_o
    pos = np.stack([np.broadcast_to(x, u.shape),
                    np.broadcast_to(y, u.shape),
                    np.broadcast_to(z, u.shape)], axis=-1)
    return pos.reshape(sma.shape[0], *t_shape, 3)


class WalkerConstellation:
    """Walker-delta constellation: L equally spaced planes, K_l sats/plane.

    Walker notation i:T/P/F with phasing factor F: the along-track phase
    offset between adjacent planes is F * 360/T degrees.

    Holds both per-object :class:`Satellite` records (satellite-id order)
    and the equivalent stacked ephemeris arrays ``sma_m`` /
    ``inclination`` / ``raan`` / ``phase``, each ``(S,)`` float64 — the
    batched representation used by ``positions_eci`` and the grid
    builders.
    """

    def __init__(
        self,
        num_orbits: int = 5,
        sats_per_orbit: int = 8,
        altitude_m: float = 2_000_000.0,
        inclination_deg: float = 80.0,
        phasing_factor: int = 1,
    ) -> None:
        if num_orbits < 1 or sats_per_orbit < 1:
            raise ValueError("need at least one orbit and one satellite")
        self.num_orbits = num_orbits
        self.sats_per_orbit = sats_per_orbit
        self.altitude_m = altitude_m
        self.inclination_rad = math.radians(inclination_deg)
        total = num_orbits * sats_per_orbit

        # Stacked ephemeris (satellite-id order): one vectorized build.
        orbit_idx = np.arange(total) // sats_per_orbit
        slot_idx = np.arange(total) % sats_per_orbit
        self.sma_m = np.full(total, EARTH_RADIUS_M + altitude_m)
        self.inclination = np.full(total, self.inclination_rad)
        self.raan = 2.0 * math.pi * orbit_idx / num_orbits
        self.phase = (2.0 * math.pi * slot_idx / sats_per_orbit
                      + 2.0 * math.pi * phasing_factor * orbit_idx / total)
        self._finalize()

    def _finalize(self) -> None:
        """Build the per-object records and membership table from the
        stacked ephemeris (shared with :class:`MultiShellConstellation`).

        Requires ``num_orbits`` / ``sats_per_orbit`` and the four ``(S,)``
        ephemeris arrays plus per-satellite altitudes (implied by
        ``sma_m``) to be set; derives ``satellites`` and ``_orbit_table``.
        """
        total = self.num_orbits * self.sats_per_orbit
        orbit_idx = np.arange(total) // self.sats_per_orbit
        slot_idx = np.arange(total) % self.sats_per_orbit
        self.satellites: list[Satellite] = [
            Satellite(
                sat_id=i,
                orbit=int(orbit_idx[i]),
                slot=int(slot_idx[i]),
                altitude_m=float(self.sma_m[i]) - EARTH_RADIUS_M,
                inclination_rad=float(self.inclination[i]),
                raan_rad=float(self.raan[i]),
                phase_rad=float(self.phase[i]),
            )
            for i in range(total)
        ]
        # Per-orbit membership table, built once: _orbit_table[l] holds the
        # satellite ids of plane l in slot order (orbit_members/ring_neighbor
        # used to rebuild an O(S) comprehension per call).
        self._orbit_table = np.arange(total).reshape(
            self.num_orbits, self.sats_per_orbit)

    def __len__(self) -> int:
        return len(self.satellites)

    @property
    def period_s(self) -> float:
        return orbital_period_s(self.altitude_m)

    def orbit_members(self, orbit: int) -> list[Satellite]:
        return [self.satellites[i] for i in self._orbit_table[orbit]]

    def ring_neighbor(self, sat: Satellite, direction: int = +1) -> Satellite:
        """Next-hop satellite on the same orbit's PTP ring (paper §III-A).

        `direction` +1 = the pre-designated dissemination direction,
        -1 = reverse.
        """
        k = (sat.slot + direction) % self.sats_per_orbit
        return self.satellites[self._orbit_table[sat.orbit, k]]

    def same_plane_mask(self) -> np.ndarray:
        """``(S, S)`` bool locality mask of intra-plane ISL candidates:
        True where two *distinct* satellites share an orbital plane. The
        block-diagonal structure this induces on a contact graph (one
        ``k x k`` block per orbit, no cross-plane edges) is what lets
        sink elections route every orbit at once over one sparse graph
        — ``E = L*k^2`` candidate pairs instead of ``S^2``."""
        ids = np.arange(len(self))
        same = (ids[:, None] // self.sats_per_orbit
                == ids[None, :] // self.sats_per_orbit)
        same[ids, ids] = False
        return same

    def local_neighbor_mask(self, ring_hops: int = 2,
                            plane_hops: int = 1) -> np.ndarray:
        """``(S, S)`` bool ring/grid locality mask: True for pairs within
        ``ring_hops`` slots on the same plane or on planes within
        ``plane_hops`` (cyclic in both axes) at any slot — the classic
        +grid ISL neighborhood. A *candidate* filter for top-k CSR
        builds on shells where hardware limits ISL reach; the default
        simulator keeps the lossless any-contact adjacency instead."""
        ids = np.arange(len(self))
        orb = ids // self.sats_per_orbit
        slot = ids % self.sats_per_orbit
        dorb = np.abs(orb[:, None] - orb[None, :])
        dorb = np.minimum(dorb, self.num_orbits - dorb)
        dslot = np.abs(slot[:, None] - slot[None, :])
        dslot = np.minimum(dslot, self.sats_per_orbit - dslot)
        near = ((dorb == 0) & (dslot <= ring_hops)) | \
            ((dorb > 0) & (dorb <= plane_hops))
        near[ids, ids] = False
        return near

    def positions_eci(self, t_s: float | np.ndarray) -> np.ndarray:
        """Positions of every satellite; shape (n_sats, ...t, 3).

        One broadcasted ephemeris evaluation — no per-satellite Python.
        """
        return ephemeris_positions_eci(
            self.sma_m, self.inclination, self.raan, self.phase, t_s)

    def positions_eci_pairwise(self, t_s: float | np.ndarray) -> np.ndarray:
        """Per-object reference path (one ``Satellite.position_eci`` call
        per spacecraft); kept for equivalence tests and benchmarks."""
        return np.stack([s.position_eci(t_s) for s in self.satellites])

    def isl_distance_m(self, a: Satellite, b: Satellite, t_s: float) -> float:
        """Euclidean intra-plane ISL distance at time t."""
        pa = a.position_eci(t_s)
        pb = b.position_eci(t_s)
        return float(np.linalg.norm(pa - pb))


@dataclasses.dataclass(frozen=True)
class ShellSpec:
    """One altitude shell of a multi-shell constellation."""
    num_orbits: int
    sats_per_orbit: int
    altitude_m: float
    inclination_deg: float = 80.0
    phasing_factor: int = 1


def parse_shells(spec: str) -> list[ShellSpec]:
    """Parse a ``shells:`` constellation spec into per-shell parameters.

    Grammar (the constellation analogue of ``stations="grid:RxC"``)::

        [shells:]LxK@ALT_KM[/INC_DEG][+LxK@ALT_KM[/INC_DEG]]...

    e.g. ``shells:10x20@550+5x8@1200/60`` — a 10x20 shell at 550 km
    (default 80 deg inclination) stacked with a 5x8 shell at 1200 km
    inclined 60 deg. Every shell must share ``K`` (sats per orbit) so
    the combined constellation keeps the rectangular ``(L_total, K)``
    orbit table every scheduler reshape relies on.
    """
    body = spec.split(":", 1)[1] if spec.startswith("shells:") else spec
    shells: list[ShellSpec] = []
    try:
        for part in body.split("+"):
            lk, _, rest = part.partition("@")
            if not rest:
                raise ValueError("missing '@ALT_KM'")
            l_str, _, k_str = lk.partition("x")
            alt, _, inc = rest.partition("/")
            shells.append(ShellSpec(
                num_orbits=int(l_str), sats_per_orbit=int(k_str),
                altitude_m=float(alt) * 1000.0,
                inclination_deg=float(inc) if inc else 80.0))
    except ValueError as e:
        raise ValueError(
            f"bad shells spec {spec!r}: expected "
            f"'LxK@ALT_KM[/INC_DEG][+...]', e.g. "
            f"'shells:10x20@550+5x8@1200/60' ({e})") from None
    ks = {s.sats_per_orbit for s in shells}
    if len(ks) != 1:
        raise ValueError(
            f"bad shells spec {spec!r}: all shells must share "
            f"sats_per_orbit (got {sorted(ks)}) so the stacked "
            f"constellation keeps a rectangular (L, K) orbit table")
    if any(s.num_orbits < 1 or s.sats_per_orbit < 1 for s in shells):
        raise ValueError(f"bad shells spec {spec!r}: empty shell")
    return shells


class MultiShellConstellation(WalkerConstellation):
    """Two-plus Walker shells at different altitudes composed into ONE
    stacked ephemeris (the dense-constellation regime of
    arXiv:2111.12769).

    Satellite ids concatenate shell by shell in plane-major order, so
    ``num_orbits`` is the total plane count across shells and every
    ``(L, K)`` reshape downstream (orbit tables, per-orbit visibility,
    partitioners, mesh maps) works unchanged. Inter-shell ISLs need no
    special casing: :func:`repro.orbits.visibility.sat_sat_visible` is
    purely positional, so a cross-shell link whose chord grazes the
    atmosphere below ``isl_grazing_altitude_m`` is pruned by the same
    test that gates intra-shell links — the contact-graph path is
    untouched.
    """

    def __init__(self, shells: "list[ShellSpec] | str") -> None:
        if isinstance(shells, str):
            shells = parse_shells(shells)
        shells = list(shells)
        if not shells:
            raise ValueError("need at least one shell")
        ks = {s.sats_per_orbit for s in shells}
        if len(ks) != 1:
            raise ValueError(
                f"all shells must share sats_per_orbit (got {sorted(ks)})")
        self.shells = tuple(shells)
        subs = [WalkerConstellation(
            s.num_orbits, s.sats_per_orbit, s.altitude_m,
            s.inclination_deg, s.phasing_factor) for s in shells]
        self.num_orbits = sum(s.num_orbits for s in shells)
        self.sats_per_orbit = shells[0].sats_per_orbit
        # Scalar attributes describe the FIRST shell (kept for API
        # compatibility; per-satellite values live in the stacked arrays).
        self.altitude_m = shells[0].altitude_m
        self.inclination_rad = subs[0].inclination_rad
        self.sma_m = np.concatenate([c.sma_m for c in subs])
        self.inclination = np.concatenate([c.inclination for c in subs])
        self.raan = np.concatenate([c.raan for c in subs])
        self.phase = np.concatenate([c.phase for c in subs])
        # shell_of[s] = which shell satellite s belongs to.
        self.shell_of = np.repeat(np.arange(len(subs)),
                                  [len(c) for c in subs])
        self._finalize()


def station_position_eci(
    lat_deg: float, lon_deg: float, altitude_m: float, t_s: float | np.ndarray
) -> np.ndarray:
    """ECI position of an Earth-fixed station (GS or HAP) at time(s) t.

    The station rotates with the Earth at the sidereal rate; at t=0 the
    Greenwich meridian is aligned with the ECI x-axis.
    """
    t = np.asarray(t_s, dtype=np.float64)
    r = EARTH_RADIUS_M + altitude_m
    lat = math.radians(lat_deg)
    lon = np.radians(lon_deg) + EARTH_ROTATION_RAD_S * t
    x = r * math.cos(lat) * np.cos(lon)
    y = r * math.cos(lat) * np.sin(lon)
    z = r * math.sin(lat) * np.ones_like(np.asarray(lon))
    return np.stack([np.broadcast_to(x, np.shape(lon)),
                     np.broadcast_to(y, np.shape(lon)),
                     np.broadcast_to(z, np.shape(lon))], axis=-1)


def station_positions_eci(
    lat_deg: np.ndarray,
    lon_deg: np.ndarray,
    altitude_m: np.ndarray,
    t_s: float | np.ndarray,
) -> np.ndarray:
    """Batched :func:`station_position_eci`; shape (n_st, ...t, 3).

    ``lat_deg`` / ``lon_deg`` / ``altitude_m`` are ``(n_st,)`` arrays; one
    broadcasted evaluation rotates every station to every query time.
    """
    lat = np.radians(np.asarray(lat_deg, dtype=np.float64))[:, None]
    lon0 = np.radians(np.asarray(lon_deg, dtype=np.float64))[:, None]
    r = (EARTH_RADIUS_M
         + np.asarray(altitude_m, dtype=np.float64))[:, None]
    t = np.asarray(t_s, dtype=np.float64)
    t_shape = t.shape
    lon = lon0 + EARTH_ROTATION_RAD_S * t.reshape(1, -1)
    x = r * np.cos(lat) * np.cos(lon)
    y = r * np.cos(lat) * np.sin(lon)
    z = (r * np.sin(lat)) * np.ones_like(lon)
    return np.stack([x, y, z], axis=-1).reshape(lat.shape[0], *t_shape, 3)
