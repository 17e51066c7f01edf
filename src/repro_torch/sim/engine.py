"""FL-Satcom round engine on PyTorch (port of ``repro.sim.engine``).

Reproduces the paper's evaluation methodology: satellites move on a
Walker constellation, visibility windows against GS/HAP stations gate
when models can move, link budgets (Table I) convert model payloads into
transfer delays, and satellites run *real* local SGD on their partition
of the digits dataset. The output is accuracy vs. *simulated* hours.

The plan half is the reference's numpy, unchanged and held bit-equal to
it by the tests: the batched visibility grid, the SHL-delay tables, the
next-contact tables, the Eq. 14-16 weights and the client plane. The
execute half runs on tensors on ``SimConfig.device`` — the card by
default (``"cuda"``); ``"cpu"`` only when the caller asks for it. A
missing card raises; there is no fallback to the CPU.

Not in this slice (each raises ``NotImplementedError`` naming its
ROADMAP item): strategies other than ``fedhap``, the satellite-sharded
mesh (``data_shards > 1`` / ``mesh``), checkpoint and resume
(``run(checkpoint_dir=...)``), and the ISL routing substrate that only
the routed strategies use.

``SimConfig.clients`` and ``SimConfig.faults`` take the reference's
grammars (``static | sampled:FRAC[xCLIENTS] | geo:REGIONSxCLIENTS[@FRAC]``
and ``faults:sat_outage=..,isl_drop=..,upload_loss=..,hap_outage=..``);
see ``repro_torch.clients.plane`` and ``repro_torch.faults.plane``.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Any, Optional, Union

import numpy as np
import torch

from repro_torch.clients import build_plane, load_dataset
from repro_torch.configs.paper_cnn import CONFIG as CNN_CONFIG
from repro_torch.configs.paper_mlp import CONFIG as MLP_CONFIG
from repro_torch.core.treeops import tree_broadcast
from repro_torch.data import (
    FederatedData,
    partition_iid,
    partition_noniid_by_orbit,
)
from repro_torch.faults import FaultPlane, parse_faults
from repro_torch.kernels.ops import fold_stacked_tree
from repro_torch.models import CNN, MLP, params_from_numpy
from repro_torch.orbits import (
    MultiShellConstellation,
    Station,
    WalkerConstellation,
    effective_min_elevation_deg,
    iter_distance_chunks,
    mask_from_positions,
    model_transfer_delay_s,
    next_contact_table,
    parse_shells,
    stations_eci,
)
from repro_torch.orbits.visibility import DALLAS, ROLLA
from repro_torch.sim.strategies import RunState, Strategy, get_strategy
from repro_torch.sim.trainer import LocalTrainer


@dataclasses.dataclass(frozen=True)
class SimConfig:
    strategy: str = "fedhap"
    stations: str = "one_hap"     # see _make_stations for the spec grammar
    model_kind: str = "cnn"       # cnn | mlp
    iid: bool = False
    partial_mode: str = "paper"   # Eq. 14 gamma mode
    orbit_weighting: str = "paper"
    # execution: fused plan-ahead blocks (device-resident model, one
    # run_block per `plan_block` planned rounds) vs the per-round
    # reference path (host-synced every round)
    fused: bool = True
    plan_block: int = 8
    # where the execute phase runs: "cuda" (the card) or "cpu"
    device: str = "cuda"
    # multi-device execution (not ported yet: ROADMAP Queue A item 12)
    data_shards: int = 0
    mesh: Any = None
    # constellation (paper §IV-A)
    num_orbits: int = 5
    sats_per_orbit: int = 8
    altitude_m: float = 2_000_000.0
    inclination_deg: float = 80.0
    # multi-shell constellation spec ("shells:LxK@ALT_KM[/INC]+...");
    # when set, overrides num_orbits/sats_per_orbit/altitude_m
    shells: str = ""
    # training
    dataset: str = "digits"       # repro_torch.clients.registry spec
    num_samples: int = 70_000
    local_steps: int = 54         # ~1 epoch of a 1750-sample shard @ bs 32
    batch_size: int = 32
    # client plane: "static" | "sampled:FRAC[xCLIENTS]" |
    # "geo:REGIONSxCLIENTS[@FRAC]"
    clients: str = "static"
    client_partitioner: str = "iid"
    learning_rate: float = 0.01
    compute_s_per_step: float = 0.1
    # timeline
    horizon_h: float = 72.0
    max_rounds: int = 2000
    time_step_s: float = 30.0
    eval_every_rounds: int = 1
    eval_samples: int = 4000
    target_accuracy: float = 0.995
    seed: int = 0
    # fault-injection plane ("" = none, the exact pre-fault path)
    faults: str = ""
    # geometry engine: budget for the eager (n_st, n_sat, T) float32
    # SHL-delay table; grids past it fall back to lazy per-column compute
    delay_table_max_bytes: int = 512 * 2**20
    # LRU capacity (in columns) of the lazy per-column delay cache
    delay_column_cache: int = 4096

    def __post_init__(self):
        # `shells:` specs are the source of truth for the constellation
        # layout: derive the plane counts here (dataclasses.replace
        # re-runs this, keeping copies consistent).
        if self.shells:
            specs = parse_shells(self.shells)
            object.__setattr__(
                self, "num_orbits", sum(s.num_orbits for s in specs))
            object.__setattr__(
                self, "sats_per_orbit", specs[0].sats_per_orbit)
            object.__setattr__(self, "altitude_m", specs[0].altitude_m)
            object.__setattr__(
                self, "inclination_deg", specs[0].inclination_deg)


@dataclasses.dataclass
class SimResult:
    history: list[tuple[float, int, float]]   # (sim_hours, round, accuracy)
    final_accuracy: float
    rounds: int
    sim_hours: float

    def time_to_accuracy(self, acc: float) -> Optional[float]:
        for t, _, a in self.history:
            if a >= acc:
                return t
        return None


def _make_stations(kind: str) -> list[Station]:
    """Parse a station-scenario spec into PS stations.

    Named setups (paper §IV): ``gs`` | ``one_hap`` | ``two_hap`` |
    ``gs_np`` | ``meo``. Parametric setups:

    - ``haps:N`` — N HAPs evenly spread in longitude at Rolla's latitude;
    - ``grid:RxC`` — an RxC ground-station grid over lat [-60, 60] x
      lon [-180, 180).
    """
    if kind == "gs":
        return [Station("gs-rolla", *ROLLA, altitude_m=0.0)]
    if kind == "one_hap":
        return [Station("hap-rolla", *ROLLA, altitude_m=20e3)]
    if kind == "two_hap":
        return [Station("hap-rolla", *ROLLA, altitude_m=20e3),
                Station("hap-dallas", *DALLAS, altitude_m=20e3)]
    if kind == "gs_np":   # FedSat/FedISL ideal: GS at the North Pole
        return [Station("gs-np", 89.9, 0.0, altitude_m=0.0)]
    if kind == "meo":     # FedISL ideal: MEO PS above the equator
        return [Station("meo", 0.0, 0.0, altitude_m=8_000_000.0,
                        min_elevation_deg=0.0)]
    if kind.startswith("haps:"):
        n = int(kind.split(":", 1)[1])
        lat = ROLLA[0]
        return [Station(f"hap-{i}", lat, ROLLA[1] + 360.0 * i / n,
                        altitude_m=20e3) for i in range(n)]
    if kind.startswith("grid:"):
        try:
            rows, cols = (int(x) for x in kind.split(":", 1)[1].split("x"))
        except ValueError:
            raise ValueError(
                f"bad station grid spec {kind!r}: expected 'grid:RxC', "
                f"e.g. 'grid:3x6'") from None
        sts = []
        for r in range(rows):
            lat = -60.0 + 120.0 * (r + 0.5) / rows
            for c in range(cols):
                lon = -180.0 + 360.0 * c / cols
                sts.append(Station(f"gs-{r}-{c}", lat, lon, altitude_m=0.0))
        return sts
    raise ValueError(kind)


def _resolve_device(name: str) -> torch.device:
    """``SimConfig.device`` as a torch device; a CUDA device without a
    card raises (the port never falls back to the CPU)."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"SimConfig.device={name!r} but torch.cuda.is_available() is "
            f"False; pass device='cpu' to run on the CPU")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {name!r}")
    return device


class RoundEngine:
    """Holds the physical world + dataset and drives one strategy."""

    def __init__(self, cfg: SimConfig):
        if cfg.data_shards > 1 or cfg.mesh is not None:
            raise NotImplementedError(
                "data_shards > 1 / mesh: the satellite-sharded executor is "
                "not ported yet (ROADMAP Queue A item 12)")
        self.cfg = cfg
        self.device = _resolve_device(cfg.device)
        if cfg.shells:
            self.constellation = MultiShellConstellation(cfg.shells)
        else:
            self.constellation = WalkerConstellation(
                cfg.num_orbits, cfg.sats_per_orbit, cfg.altitude_m,
                cfg.inclination_deg)
        self.stations = _make_stations(cfg.stations)
        self.n_sats = len(self.constellation)
        rng = np.random.default_rng(cfg.seed)
        self.rng = rng

        images, labels = load_dataset(
            cfg.dataset, num_samples=cfg.num_samples, seed=cfg.seed)
        n_eval = cfg.eval_samples
        self.eval_images, self.eval_labels = images[:n_eval], labels[:n_eval]
        tr_img, tr_lab = images[n_eval:], labels[n_eval:]
        if cfg.iid:
            parts = partition_iid(tr_lab, self.n_sats, cfg.seed)
        else:
            # Multi-shell layouts key the 60/40 orbit class-group split
            # per shell (the stacked plane table), not globally.
            shell_of = getattr(self.constellation, "shell_of", None)
            orbit_shells = None if shell_of is None else np.asarray(
                shell_of)[::cfg.sats_per_orbit]
            parts = partition_noniid_by_orbit(
                tr_lab, cfg.num_orbits, cfg.sats_per_orbit, cfg.seed,
                orbit_shells=orbit_shells)
        self.fd = FederatedData(tr_img, tr_lab, parts)
        self.sizes = self.fd.client_sizes().astype(np.float64)

        model = (CNN(CNN_CONFIG) if cfg.model_kind == "cnn"
                 else MLP(MLP_CONFIG))
        self.trainer = LocalTrainer(model, cfg.learning_rate, cfg.batch_size,
                                    device=self.device)
        self.model_bits = model.count_params() * 32

        # Precompute visibility + SHL-delay tables on the timeline grid:
        # one stacked station/satellite propagation feeds both.
        n_steps = int(cfg.horizon_h * 3600 / cfg.time_step_s) + 2
        self.grid_t = np.arange(n_steps) * cfg.time_step_s
        st_pos = stations_eci(self.stations, self.grid_t)   # (n_st, T, 3)
        sat_pos = self.constellation.positions_eci(self.grid_t)  # (S, T, 3)
        self.vis = mask_from_positions(
            st_pos, sat_pos,
            effective_min_elevation_deg(self.stations))  # (n_st, n_sat, T)

        self._st_is_hap = np.array([s.is_hap for s in self.stations])

        # Fault plane: station/satellite outages mask `vis` before any
        # derived table exists; upload losses are priced in the plan
        # phase. faults="" builds no plane: the pre-fault code path.
        fault_spec = parse_faults(cfg.faults)
        self.fault_plane: Optional[FaultPlane] = None
        if fault_spec.any_faults:
            self.fault_plane = FaultPlane(
                fault_spec, seed=cfg.seed, n_sats=self.n_sats,
                st_is_hap=self._st_is_hap, grid_t=self.grid_t)
            self.vis &= self.fault_plane.st_up[:, None, :]
            self.vis &= self.fault_plane.sat_up[None, :, :]

        table_bytes = len(self.stations) * self.n_sats * n_steps * 4
        if table_bytes <= cfg.delay_table_max_bytes:
            self.shl_table = self._build_delay_table(st_pos, sat_pos)
        else:
            self.shl_table = None       # mega grids: lazy per-column cache
        self._delay_cols: OrderedDict[int, np.ndarray] = OrderedDict()

        # Any-station visibility, per-orbit series + next-contact tables:
        # contact queries are O(1) lookups instead of per-round scans.
        L, k = cfg.num_orbits, cfg.sats_per_orbit
        self.any_vis = self.vis.any(axis=0)                 # (n_sat, T)
        self.orbit_vis = self.any_vis.reshape(L, k, -1).any(axis=1)  # (L, T)
        self.orbit_next = next_contact_table(self.orbit_vis)     # (L, T)
        self.sat_next = next_contact_table(self.any_vis)         # (S, T)

        # Static intra-orbit ISL geometry (circular orbits: constant).
        a, b = (self.constellation.orbit_members(0)[0],
                self.constellation.orbit_members(0)[1])
        self.isl_dist = self.constellation.isl_distance_m(a, b, 0.0)

        # Virtual-client plane: resolves per-round sample-index tables
        # for every training point ("static" wraps the shared-rng
        # sampler bit-identically).
        self.client_plane = build_plane(
            cfg.clients, trainer=self.trainer, fd=self.fd, rng=self.rng,
            local_steps=cfg.local_steps, seed=cfg.seed,
            partitioner=cfg.client_partitioner,
            grid_t=self.grid_t, sat_positions=sat_pos,
            time_step_s=cfg.time_step_s)

        # Fused execute backend (built on first use; see `executor`).
        self._executor = None

    # ------------------------------------------------------------ helpers
    @property
    def horizon_s(self) -> float:
        return self.cfg.horizon_h * 3600.0

    @property
    def executor(self):
        """Lazily-built fused execute backend (``repro_torch.sim.executor``):
        device-resident dataset/eval set + the block program."""
        if self._executor is None:
            from repro_torch.sim.executor import FusedExecutor
            self._executor = FusedExecutor(
                self.trainer, self.fd, self.eval_images, self.eval_labels)
        return self._executor

    def tidx(self, t_s) -> np.ndarray:
        """Batched grid-time index: floor(t/step) clamped to the grid."""
        t = np.asarray(t_s, dtype=np.float64)
        return np.minimum((t / self.cfg.time_step_s).astype(np.int64),
                          self.vis.shape[2] - 1)

    def _tidx(self, t_s: float) -> int:
        return min(int(t_s / self.cfg.time_step_s), self.vis.shape[2] - 1)

    def vis_at(self, t_s: float) -> np.ndarray:
        """(n_stations, n_sats) bool."""
        return self.vis[:, :, self._tidx(t_s)]

    # ------------------------------------------------ SHL-delay tables
    def _delays_from_dist(self, dist: np.ndarray) -> np.ndarray:
        """Station->satellite transfer delays from a (n_st, ...) distance
        block; FSO rows for HAPs, RF rows for ground stations."""
        out = np.empty_like(dist)
        hap = self._st_is_hap
        n_params = self.model_bits // 32
        if hap.any():
            out[hap] = model_transfer_delay_s(n_params, dist[hap], "fso")
        if (~hap).any():
            out[~hap] = model_transfer_delay_s(n_params, dist[~hap], "rf")
        return out

    def _build_delay_table(self, st_pos: np.ndarray,
                           sat_pos: np.ndarray) -> np.ndarray:
        """(n_st, n_sat, T) float32 SHL delays over the whole grid."""
        out = np.empty((st_pos.shape[0], sat_pos.shape[0],
                        st_pos.shape[1]), dtype=np.float32)
        for sl, dist in iter_distance_chunks(st_pos, sat_pos):
            out[:, :, sl] = self._delays_from_dist(dist)
        return out

    def _delay_column(self, tidx: int) -> np.ndarray:
        """Lazy path for grids past ``delay_table_max_bytes``: one
        (n_st, n_sat) delay column, memoized in an LRU of
        ``SimConfig.delay_column_cache`` columns."""
        col = self._delay_cols.get(tidx)
        if col is not None:
            self._delay_cols.move_to_end(tidx)
            return col
        t = float(self.grid_t[tidx])
        sp = stations_eci(self.stations, t)               # (n_st, 3)
        kp = self.constellation.positions_eci(t)          # (S, 3)
        dist = np.linalg.norm(sp[:, None, :] - kp[None, :, :], axis=-1)
        col = self._delays_from_dist(dist).astype(np.float32)
        self._delay_cols[tidx] = col
        if len(self._delay_cols) > max(1, self.cfg.delay_column_cache):
            self._delay_cols.popitem(last=False)
        return col

    def shl_delay(self, st_i: int, sat_i: int, t_s: float) -> float:
        """Station->satellite model-transfer delay at the nearest grid
        time (an O(1) table lookup)."""
        tidx = self._tidx(t_s)
        if self.shl_table is not None:
            return float(self.shl_table[st_i, sat_i, tidx])
        return float(self._delay_column(tidx)[st_i, sat_i])

    def shl_delays(self, st_idx, sat_idx, t_idx) -> np.ndarray:
        """Batched SHL-delay gather: broadcastable int arrays of station,
        satellite, and *grid-time* indices -> float delays."""
        st_idx = np.asarray(st_idx)
        sat_idx = np.asarray(sat_idx)
        t_idx = np.asarray(t_idx)
        if self.shl_table is not None:
            return self.shl_table[st_idx, sat_idx, t_idx].astype(np.float64)
        st_idx, sat_idx, t_idx = np.broadcast_arrays(st_idx, sat_idx, t_idx)
        out = np.empty(st_idx.shape, dtype=np.float64)
        for tcol in np.unique(t_idx):
            m = t_idx == tcol
            out[m] = self._delay_column(int(tcol))[st_idx[m], sat_idx[m]]
        return out

    def isl_delay(self) -> float:
        return model_transfer_delay_s(self.model_bits // 32, self.isl_dist,
                                      "fso")

    def ihl_delay(self) -> float:
        if len(self.stations) < 2:
            return 0.0
        d = float(np.linalg.norm(
            self.stations[0].position_eci(0.0)
            - self.stations[1].position_eci(0.0)))
        return model_transfer_delay_s(self.model_bits // 32, d, "fso")

    def ring_delay(self) -> float:
        """Inter-station dissemination ring (down + up every IHL hop)
        paid between rounds."""
        return 2 * (len(self.stations) - 1) * self.ihl_delay()

    def train_time(self) -> float:
        return self.cfg.local_steps * self.cfg.compute_s_per_step

    def orbit_slice(self, l: int) -> slice:
        k = self.cfg.sats_per_orbit
        return slice(l * k, (l + 1) * k)

    # --------------------------------------------------- contact queries
    def first_orbit_contacts(self, t_s: float) -> np.ndarray:
        """Earliest grid time >= t_s at which each orbit sees any station.

        Returns (num_orbits,) times in seconds, NaN where no contact
        remains before the horizon (one table lookup per orbit).
        """
        step = self.cfg.time_step_s
        T = self.orbit_next.shape[1]
        i0 = int(t_s / step)
        j = self.orbit_next[:, min(i0, T - 1)]
        tt = t_s + np.maximum(0, j - i0) * step
        ok = (j < T) & (tt <= self.horizon_s)
        return np.where(ok, tt, np.nan)

    # ------------------------------------------------- training/agg ops
    def sample_indices(self, sats, t_s: float = 0.0) -> np.ndarray:
        """Resolve the ``(len(sats), local_steps * batch)`` sample-index
        tables the given satellites train on at sim time ``t_s``."""
        return self.client_plane.sample_indices(sats, t_s)

    def train_all(self, params: dict, t_s: float = 0.0) -> dict:
        """One local-SGD burst on every satellite; returns the stacked
        per-satellite params."""
        stacked = tree_broadcast(params, self.n_sats)
        sel = self.sample_indices(np.arange(self.n_sats), t_s)
        stacked, _ = self.trainer.train_selection(stacked, self.fd, sel)
        return stacked

    def combine(self, stacked: dict, weights: Any) -> dict:
        """Σ_s weights[s]·stacked[s] — the fold (the ``fedagg`` kernel on
        the card, the plain fold on CPU)."""
        return fold_stacked_tree(stacked, np.asarray(weights, np.float32))

    def eval_and_record(self, s: RunState) -> None:
        s.acc = self.trainer.evaluate(s.params, self.eval_images,
                                      self.eval_labels)
        s.history.append((s.t / 3600.0, s.events, s.acc))

    # -------------------------------------------------------------- run
    def run(self, strategy: Union[str, Strategy, None] = None,
            fused: Optional[bool] = None, *,
            init_params: Optional[dict] = None,
            checkpoint_dir: Any = None) -> SimResult:
        """Drive the configured (or given) strategy to completion.

        ``fused`` selects the execution path (default
        ``SimConfig.fused``): the plan-ahead block loop — K planned
        rounds per :meth:`FusedExecutor.run_block`, host only between
        blocks — or the per-round reference loop.

        ``init_params`` is a numpy param tree (for example the JAX
        package's init, exported leaf by leaf) to start from instead of
        the port's own seeded init; it is carried over with
        :func:`repro_torch.models.params_from_numpy`.
        """
        if checkpoint_dir is not None:
            raise NotImplementedError(
                "checkpoint_dir: checkpoint and resume are not ported yet "
                "(ROADMAP Queue A item 9)")
        strat = strategy if isinstance(strategy, Strategy) else \
            get_strategy(strategy or self.cfg.strategy)()
        cfg = self.cfg
        use_fused = cfg.fused if fused is None else fused
        params = (self.trainer.init(cfg.seed) if init_params is None
                  else params_from_numpy(init_params, self.device))
        s = RunState(params=params)
        if use_fused:
            strat.run_fused(self, s)
        else:
            while (s.events < cfg.max_rounds and s.t <= self.horizon_s
                   and s.acc < cfg.target_accuracy):
                if not strat.step(self, s):
                    break
        return SimResult(s.history, s.acc, len(s.history), s.t / 3600.0)


__all__ = ["SimConfig", "SimResult", "RoundEngine", "_make_stations"]
