"""Deterministic fault-injection plane for the timeline simulator.

Every fault the simulator can suffer — satellite safe-mode windows, HAP
outages, failed ISL terminals, corrupted/lost uploads — is resolved
here into **time-indexed tables** at engine construction, from
counter-keyed deterministic streams (same discipline as
``repro.clients.plane``: ``default_rng((seed, salt, counter))``).
Because the tables are indexed by *grid time*, not by call order, the
fused plan-ahead driver and the per-round reference loop consume
bit-identical fault schedules regardless of how queries are batched.

Grammar (``SimConfig.faults``)::

    faults:sat_outage=0.02,isl_drop=0.05,upload_loss=0.1,hap_outage=0.01
          [,mtbf_h=6,mttr_h=0.5]

- ``sat_outage``  — steady-state fraction of time a satellite spends in
  safe mode (all its station links sever for the window; it keeps
  training on board).
- ``hap_outage``  — same, for HAP stations (ground stations are assumed
  hardened and never fault).
- ``isl_drop``    — probability an (a, b) ISL terminal pair failed
  acquisition for the whole run: a time-constant symmetric edge mask
  handed to ``build_contact_graph(fault_mask=...)``.
- ``upload_loss`` — per-(satellite, grid-step) probability that an
  upload attempted at that contact step is lost and must retry through
  the next contact.
- ``mtbf_h`` / ``mttr_h`` — mean up/down window lengths (hours) of the
  alternating-renewal outage process. When ``mttr_h`` is omitted it is
  derived so the steady-state unavailability matches the outage rate:
  ``mttr = mtbf * p / (1 - p)``.

The ``faults:`` prefix is optional; an empty spec means no fault plane
at all (the engine takes the exact pre-fault code path).
"""
from __future__ import annotations

import dataclasses

import numpy as np

_FAULT_SALT = 0xFA17B10C
_STREAM_SAT, _STREAM_HAP, _STREAM_ISL, _STREAM_UPLOAD = range(4)

#: Upload-loss retries are capped: after this many consecutive lost
#: contacts (or the grid horizon, whichever first) the upload prices inf
#: and the scheduler treats the cycle/round leg as undeliverable.
MAX_UPLOAD_RETRIES = 8

_KEYS = ("sat_outage", "isl_drop", "upload_loss", "hap_outage",
         "mtbf_h", "mttr_h")


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """Parsed ``SimConfig.faults`` grammar (all rates in [0, 1))."""
    sat_outage: float = 0.0
    isl_drop: float = 0.0
    upload_loss: float = 0.0
    hap_outage: float = 0.0
    mtbf_h: float = 6.0
    mttr_h: float = 0.0          # 0 = derive from the outage fraction

    @property
    def any_faults(self) -> bool:
        return (self.sat_outage > 0 or self.isl_drop > 0
                or self.upload_loss > 0 or self.hap_outage > 0)


def parse_faults(spec: str) -> FaultSpec:
    """Parse the ``faults:k=v,...`` grammar into a :class:`FaultSpec`."""
    s = spec.strip()
    if s.startswith("faults:"):
        s = s[len("faults:"):]
    if not s:
        return FaultSpec()
    kw: dict[str, float] = {}
    for part in s.split(","):
        key, sep, val = part.partition("=")
        key = key.strip()
        if not sep or key not in _KEYS:
            raise ValueError(
                f"bad faults entry {part!r}: expected key=value with key "
                f"in {_KEYS}")
        kw[key] = float(val)
    for key in ("sat_outage", "isl_drop", "upload_loss", "hap_outage"):
        if not 0.0 <= kw.get(key, 0.0) < 1.0:
            raise ValueError(f"faults: {key} must be in [0, 1)")
    if kw.get("mtbf_h", 1.0) <= 0:
        raise ValueError("faults: mtbf_h must be positive")
    return FaultSpec(**kw)


def _outage_timeline(p: float, n: int, grid_t: np.ndarray,
                     mtbf_s: float, mttr_s: float,
                     rng: np.random.Generator) -> np.ndarray:
    """``(n, T)`` up/down timeline from an alternating renewal process.

    Each entity starts up, stays up ~Exp(mtbf), goes down ~Exp(mttr),
    repeats; steady-state unavailability is mttr/(mtbf+mttr) = ``p``
    when ``mttr_s`` was derived from ``p``. Down intervals are marked on
    the grid with a searchsorted per entity.
    """
    T = len(grid_t)
    if p <= 0.0 or n == 0:
        return np.ones((n, T), dtype=bool)
    horizon = float(grid_t[-1])
    n_seg = max(8, int(np.ceil(horizon / (mtbf_s + mttr_s) * 3)) + 8)
    while True:
        ups = rng.exponential(mtbf_s, (n, n_seg))
        downs = rng.exponential(mttr_s, (n, n_seg))
        cycle_end = np.cumsum(ups + downs, axis=1)
        if float(cycle_end[:, -1].min()) > horizon:
            break
        n_seg *= 2                     # rare: redraw with more segments
    down_start = cycle_end - downs
    up = np.ones((n, T), dtype=bool)
    for i in range(n):
        k = np.searchsorted(down_start[i], grid_t, side="right") - 1
        in_down = (k >= 0) & (grid_t < cycle_end[i, np.maximum(k, 0)])
        up[i] = ~in_down
    return up


class FaultPlane:
    """Eagerly resolved per-entity fault tables for one engine run.

    Stateless after construction — all tables are keyed by grid time,
    so the plane needs no counters checkpointed for bit-exact resume.

    Attributes:
        sat_up:    ``(n_sats, T)`` bool — satellite NOT in safe mode.
        st_up:     ``(n_stations, T)`` bool — station reachable (only
                   HAP rows ever go down).
        isl_fault: ``(n_sats, n_sats)`` bool — symmetric, True where an
                   ISL terminal pair failed acquisition for the run.
        upload_ok: ``(n_sats, T)`` bool — upload attempted by that
                   satellite at that grid step survives.
    """

    def __init__(self, spec: FaultSpec, *, seed: int, n_sats: int,
                 st_is_hap: np.ndarray, grid_t: np.ndarray):
        self.spec = spec
        T = len(grid_t)
        st_is_hap = np.asarray(st_is_hap, dtype=bool)
        n_st = len(st_is_hap)
        mtbf_s = spec.mtbf_h * 3600.0

        def mttr_s(p: float) -> float:
            if spec.mttr_h > 0:
                return spec.mttr_h * 3600.0
            return mtbf_s * p / max(1.0 - p, 1e-12)

        self.sat_up = _outage_timeline(
            spec.sat_outage, n_sats, grid_t, mtbf_s,
            mttr_s(spec.sat_outage), self._rng(_STREAM_SAT, seed))

        self.st_up = np.ones((n_st, T), dtype=bool)
        n_haps = int(st_is_hap.sum())
        if spec.hap_outage > 0 and n_haps:
            self.st_up[st_is_hap] = _outage_timeline(
                spec.hap_outage, n_haps, grid_t, mtbf_s,
                mttr_s(spec.hap_outage), self._rng(_STREAM_HAP, seed))

        self.isl_fault = np.zeros((n_sats, n_sats), dtype=bool)
        if spec.isl_drop > 0:
            r = self._rng(_STREAM_ISL, seed).random((n_sats, n_sats))
            upper = np.triu(r < spec.isl_drop, 1)
            self.isl_fault = upper | upper.T

        self.upload_ok = np.ones((n_sats, T), dtype=bool)
        if spec.upload_loss > 0:
            r = self._rng(_STREAM_UPLOAD, seed).random((n_sats, T))
            self.upload_ok = r >= spec.upload_loss

    @staticmethod
    def _rng(stream: int, seed: int) -> np.random.Generator:
        return np.random.default_rng((seed, _FAULT_SALT, stream))

    @property
    def has_isl_faults(self) -> bool:
        return bool(self.isl_fault.any())

    def link_up(self) -> np.ndarray:
        """``(n_stations, n_sats, T)`` bool station-link availability."""
        return self.st_up[:, None, :] & self.sat_up[None, :, :]

    def describe(self) -> dict:
        return {
            "spec": dataclasses.asdict(self.spec),
            "sat_downtime": round(1.0 - float(self.sat_up.mean()), 4),
            "st_downtime": round(1.0 - float(self.st_up.mean()), 4),
            "isl_failed_pairs": int(self.isl_fault.sum()) // 2,
            "upload_loss": round(1.0 - float(self.upload_ok.mean()), 4),
        }
