"""FL-Satcom round engine on PyTorch (port of ``repro.sim.engine``).

Reproduces the paper's evaluation methodology: satellites move on a
Walker constellation, visibility windows against GS/HAP stations gate
when models can move, link budgets (Table I) convert model payloads into
transfer delays, and satellites run *real* local SGD on their partition
of the digits dataset. The output is accuracy vs. *simulated* hours.

The plan half is the reference's numpy, unchanged and held bit-equal to
it by the tests: the batched visibility grid, the SHL-delay tables, the
next-contact tables, the Eq. 14-16 weights, the client plane, and the
ISL routing substrate of the routed strategies (contact-graph windows
over ``SimConfig.isl_grid_max_bytes``, stitched past it; routed exits;
station-upload pricing with lost-upload retries; memoized sink
elections). The execute half runs on tensors on ``SimConfig.device`` —
the card by default (``"cuda"``); ``"cpu"`` only when the caller asks
for it. A missing card raises; there is no fallback to the CPU.

Strategies: fedhap | fedisl | fedisl_ideal | fedsat | fedspace |
fedsink | fedhap_async | fedhap_buffered, resolved through the registry
in ``repro_torch.sim.strategies``. ``run(checkpoint_dir=, resume=)``
snapshots and resumes a run in the JAX package's checkpoint format
(:mod:`repro_torch.checkpoint`). ``SimConfig.data_shards > 1`` (or a
``DeviceMesh`` in ``SimConfig.mesh``) shards the satellite axis of the
fused blocks over the ranks of an initialised process group, one engine
per rank, every rank planning the same run
(:class:`repro_torch.sim.executor.FusedExecutor`); each rank's history
is the same.

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

from repro_torch.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.clients import build_plane, load_dataset
from repro_torch.configs.paper_cnn import CONFIG as CNN_CONFIG
from repro_torch.configs.paper_mlp import CONFIG as MLP_CONFIG
from repro_torch.core.treeops import tree_broadcast
from repro_torch.data import (
    FederatedData,
    partition_iid,
    partition_noniid_by_orbit,
)
from repro_torch.faults import MAX_UPLOAD_RETRIES, FaultPlane, parse_faults
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
from repro_torch.orbits.routing import (
    ContactGraph,
    SinkElection,
    SparseContactGraph,
    WindowedRouter,
    build_contact_graph,
    earliest_arrival,
    elect_sinks,
    extract_paths,
    onehot_chain_weights,
    predecessors,
    subgraph,
)
from repro_torch.orbits.visibility import DALLAS, ROLLA
from repro_torch.sim.strategies import (
    RoundStrategy, RunState, Strategy, get_strategy)
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
    # multi-rank execution: shard the satellite axis of the fused blocks
    # over `data_shards` ranks of the process group
    # (`repro_torch.launch.mesh.make_sim_mesh`), or over the `data` axis
    # of the given DeviceMesh
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
    # fedhap_async / fedhap_buffered knobs
    buffer_fraction: float = 0.5
    staleness_power: float = 0.5
    # geometry engine: budget for the eager (n_st, n_sat, T) float32
    # SHL-delay table; grids past it fall back to lazy per-column compute
    delay_table_max_bytes: int = 512 * 2**20
    # LRU capacity (in columns) of the lazy per-column delay cache
    delay_column_cache: int = 4096
    # routing subsystem: budget for one windowed (S, S, W) contact graph
    # (ISL LoS grid + int16 edge table); grids past it route over a
    # stitched chain of half-overlapping windows (WindowedRouter) —
    # exact against the whole-grid oracle, windows built lazily
    isl_grid_max_bytes: int = 256 * 2**20
    isl_grazing_altitude_m: float = 80_000.0
    # LRU capacity (in windows) of the compiled contact-graph cache
    contact_graph_cache: int = 4

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
class _CkptState:
    """Live checkpoint state for one ``run(checkpoint_dir=)``.

    The engine owns the cadence (save every ``every`` events at safe
    block boundaries); strategies only hand their device-state template
    to :meth:`RoundEngine.ckpt_resume` / :meth:`RoundEngine.ckpt_tick`.
    """
    directory: Any
    every: int
    resume: bool
    step: int = 0            # monotonically increasing save counter
    last_saved: int = 0      # s.events at the last snapshot
    strategy_meta: Any = None  # host-side plan state restored on resume


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
    if (device.type == "cuda" and device.index is None
            and torch.distributed.is_available()
            and torch.distributed.is_initialized()):
        # each rank's own card (launch.mesh.init_ranks sets it)
        device = torch.device("cuda", torch.cuda.current_device())
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {name!r}")
    return device


class RoundEngine:
    """Holds the physical world + dataset and drives one strategy."""

    def __init__(self, cfg: SimConfig):
        self.cfg = cfg
        self.device = _resolve_device(cfg.device)
        self.mesh = cfg.mesh
        if self.mesh is None and cfg.data_shards > 1:
            from repro_torch.launch.mesh import make_sim_mesh
            self.mesh = make_sim_mesh(cfg.data_shards)
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
        self._isl_fault: Optional[np.ndarray] = None
        if fault_spec.any_faults:
            self.fault_plane = FaultPlane(
                fault_spec, seed=cfg.seed, n_sats=self.n_sats,
                st_is_hap=self._st_is_hap, grid_t=self.grid_t)
            self.vis &= self.fault_plane.st_up[:, None, :]
            self.vis &= self.fault_plane.sat_up[None, :, :]
            if self.fault_plane.has_isl_faults:
                self._isl_fault = self.fault_plane.isl_fault

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

        # Routing substrate: the stacked satellite ephemeris is kept for
        # windowed contact-graph builds; graphs, per-orbit intra-plane
        # subgraphs, and sink elections are built lazily and memoized
        # (route/sink caches). The one-hot Eq.-14 chain weights behind
        # sink scoring are time-independent: computed once per orbit.
        self._sat_pos = sat_pos                             # (S, T, 3)
        self._contact_graphs: OrderedDict[int, ContactGraph] = OrderedDict()
        self._orbit_graphs: OrderedDict[Any, ContactGraph] = OrderedDict()
        self._intra_graphs: OrderedDict[int, SparseContactGraph] = \
            OrderedDict()
        self._sink_cache: OrderedDict[Any, SinkElection] = OrderedDict()
        # Intra-plane locality mask: the CSR candidate filter that turns
        # election routing into L independent k x k blocks (E = L*k^2
        # candidate pairs instead of S^2) relaxed in ONE call.
        self._same_plane = self.constellation.same_plane_mask()
        # Window length (grid steps) of one compiled contact graph under
        # the byte budget; the whole horizon when it fits. Windows stay
        # under the int16 sentinel so the edge table never silently
        # widens to int32 (which would bust the byte budget).
        per_step = self.n_sats * self.n_sats * 3   # 1B LoS + 2B int16
        self._window_steps = int(max(32, min(
            n_steps, np.iinfo(np.int16).max,
            cfg.isl_grid_max_bytes // max(1, per_step))))
        self._router: Optional[WindowedRouter] = None
        self._orbit_routers: dict[int, WindowedRouter] = {}
        self._intra_router: Optional[WindowedRouter] = None
        self._onehot_lam = onehot_chain_weights(
            self.sizes.reshape(L, k), cfg.partial_mode)     # (L, k, k)

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
        # Checkpoint state, live only inside run(checkpoint_dir=).
        self._ckpt: Optional[_CkptState] = None
        # Optional context-manager factory wrapped around the fused
        # block loop only (params init / dataset staging stay outside).
        # Installed by repro_torch.debug.sanitize to run the loop under
        # its transfer, dtype and rank guards.
        self._fused_cm: Optional[Any] = None

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
                self.trainer, self.fd, self.eval_images, self.eval_labels,
                mesh=self.mesh)
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

    # ----------------------------------------------- routing subsystem
    @staticmethod
    def _find_reuse(cache: OrderedDict, i0: int):
        """The cached window with the largest head overlap into a new
        window at ``i0`` — the incremental-advance donor
        (``build_contact_graph(reuse=...)``). None when no cached window
        starts at or before ``i0`` and reaches past it."""
        best, best_ov = None, 0
        for p0, g in cache.items():
            if p0 <= i0:
                ov = p0 + g.n_steps - i0
                if ov > best_ov:
                    best, best_ov = g, ov
        return best

    def _window_graph(self, i0: int) -> ContactGraph:
        """Compile (or fetch) the contact-graph window starting at grid
        index ``i0``, memoized in an LRU of
        ``SimConfig.contact_graph_cache`` windows (mirrors the lazy
        delay-column cache: stitched sweeps revisit neighboring windows,
        eviction drops the least-recently routed one). A miss advances
        incrementally from the cached window with the largest overlap —
        the stitched chain steps by half a window, so typically only
        half the LoS geometry is ever recomputed (bit-equal either way)."""
        graph = self._contact_graphs.get(i0)
        if graph is None:
            sl = slice(i0, min(i0 + self._window_steps, len(self.grid_t)))
            graph = build_contact_graph(
                self.constellation, self.grid_t[sl],
                self.model_bits // 32,
                grazing_altitude_m=self.cfg.isl_grazing_altitude_m,
                positions=self._sat_pos[:, sl],
                fault_mask=self._isl_fault,
                reuse=self._find_reuse(self._contact_graphs, i0))
            self._contact_graphs[i0] = graph
            if len(self._contact_graphs) > max(1,
                                               self.cfg.contact_graph_cache):
                self._contact_graphs.popitem(last=False)
        else:
            self._contact_graphs.move_to_end(i0)
        return graph

    def _intra_window(self, i0: int) -> SparseContactGraph:
        """One CSR *intra-plane* window at grid index ``i0``: the
        block-diagonal contact graph over the same-plane candidate
        pairs only (``E = L*k^2`` instead of ``S^2``), LRU-cached and
        incrementally advanced like the full windows. Disjoint blocks
        relax independently, so routing global member ids over this
        graph is bit-equal to routing each orbit's induced subgraph —
        which is what lets one relaxation score a whole batch of sink
        elections."""
        graph = self._intra_graphs.get(i0)
        if graph is None:
            sl = slice(i0, min(i0 + self._window_steps, len(self.grid_t)))
            graph = build_contact_graph(
                self.constellation, self.grid_t[sl],
                self.model_bits // 32,
                grazing_altitude_m=self.cfg.isl_grazing_altitude_m,
                positions=self._sat_pos[:, sl],
                sparse=True, pair_mask=self._same_plane,
                fault_mask=self._isl_fault,
                reuse=self._find_reuse(self._intra_graphs, i0))
            self._intra_graphs[i0] = graph
            if len(self._intra_graphs) > max(1,
                                             self.cfg.contact_graph_cache):
                self._intra_graphs.popitem(last=False)
        else:
            self._intra_graphs.move_to_end(i0)
        return graph

    def intra_plane_graph(self, t_s: float = 0.0) \
            -> Union[SparseContactGraph, WindowedRouter]:
        """The block-diagonal intra-plane routing substrate covering
        ``t_s``: one CSR graph when a window spans the horizon, else a
        stitched router over the LRU-cached intra windows (the election
        path cuts its chain once the member columns settle — see
        :func:`repro_torch.orbits.routing.elect_sinks`)."""
        if self._window_steps >= len(self.grid_t):
            return self._intra_window(0)
        if self._intra_router is None:
            self._intra_router = WindowedRouter(
                self.grid_t, self.n_sats, self._window_steps,
                self._intra_window)
        return self._intra_router

    def contact_graph(self, t_s: float = 0.0) -> Union[ContactGraph,
                                                       WindowedRouter]:
        """The routing substrate covering ``t_s`` (route cache).

        When the whole-horizon ``(S, S, T)`` structures fit
        ``SimConfig.isl_grid_max_bytes`` one :class:`ContactGraph` is
        built and reused for every query. Past the budget the engine
        hands out a :class:`WindowedRouter` instead: half-overlapping
        windows of the grid are compiled on demand (through the
        ``contact_graph_cache`` LRU) and arrival frontiers are stitched
        across them, so mega-constellation shells route exactly like
        the single-graph oracle — including routes that cross a window
        boundary — without materializing the full edge table. Both
        returns answer the same `repro_torch.orbits.routing` API
        (``earliest_arrival`` / ``predecessors`` / ``subgraph`` /
        ``elect_sinks`` dispatch on the type).
        """
        if self._window_steps >= len(self.grid_t):
            return self._window_graph(0)
        if self._router is None:
            self._router = WindowedRouter(
                self.grid_t, self.n_sats, self._window_steps,
                self._window_graph)
        return self._router

    def full_contact_graph(self) -> ContactGraph:
        """Single-graph oracle over the whole horizon grid, ignoring
        ``isl_grid_max_bytes`` — the stitched-equivalence baseline for
        the tests. Built fresh on every call; not part of the route caches."""
        return build_contact_graph(
            self.constellation, self.grid_t, self.model_bits // 32,
            grazing_altitude_m=self.cfg.isl_grazing_altitude_m,
            positions=self._sat_pos, fault_mask=self._isl_fault)

    def route_exit_end(self, sat_idx: int, t_s: float) -> float:
        """Earliest completed station upload reachable from ``sat_idx``
        holding a model at ``t_s``, allowed to ride cross-plane ISL
        routes — the routed exit decision behind ``fedhap_buffered``;
        the scalar form of :meth:`route_exit_ends`. Returns inf when no
        route completes before the horizon."""
        return float(self.route_exit_ends([int(sat_idx)], [t_s])[0])

    def route_exit_ends(self, sat_idx, t_s) -> np.ndarray:
        """Batched routed exits: ``(N,)`` earliest completed station
        uploads of models held at satellites ``sat_idx`` from times
        ``t_s`` (per-row). One shared frontier-masked earliest-arrival
        sweep over all rows plus one exit-pricing gather
        (:meth:`station_upload_end`) over the landings — the whole
        batch of a plan block's exit decisions in one relaxation. The
        sweep is bound-pruned (``cap``): a label at or past its row's
        current best upload end cannot seed a better exit (arrivals
        propagate monotonically and upload ends never precede
        arrival), so the frontier collapses to the labels that can
        still matter — exact for the returned ends. On a stitched
        router the chain is additionally cut (``stop``) as soon as
        every row's best exit already beats the next window's start:
        any later candidate lands at or after that start, so its
        upload ends no earlier. Rows with non-finite ``t_s`` price
        inf."""
        sats = np.atleast_1d(np.asarray(sat_idx, dtype=np.int64))
        ts = np.atleast_1d(np.asarray(t_s, dtype=np.float64))
        ends = np.full(len(sats), np.inf)
        ok = np.isfinite(ts)
        if not ok.any():
            return ends
        sats, tv = sats[ok], ts[ok]
        graph = self.contact_graph(float(tv.min()))
        allsat = np.arange(self.n_sats)[None, :]

        def best_ends(a: np.ndarray) -> np.ndarray:
            # Lost-upload-aware pricing: under a fault plane a routed
            # exit retries through later contacts (upload_end is still
            # monotone in arrival time, so bound-pruning stays exact).
            return self.upload_end(allsat, a).min(axis=1)

        if isinstance(graph, WindowedRouter):
            def exits_settled(a: np.ndarray, t_next: float) -> bool:
                best = best_ends(a)
                return bool(np.all(np.isfinite(best) & (best <= t_next)))

            arr = graph.earliest_arrival(sats, tv, stop=exits_settled,
                                         cap=best_ends)
        else:
            arr = earliest_arrival(graph, sats, tv, cap=best_ends)
        ends[ok] = best_ends(arr)
        return ends

    def route_exit_plan(self, sat_idx: int,
                        t_s: float) -> tuple[float, int, list[int]]:
        """The routed exit of :meth:`route_exit_end` *with its path*:
        ``(end, exit_sat, hops)`` where ``hops`` is the ISL hop list
        from ``sat_idx`` to the exit satellite (``[]`` when no route
        completes). One stitched sweep, one spliced predecessor table,
        one vectorized ``extract_paths`` walk — the diagnostic behind
        the mega-shell benches' hop-count reporting."""
        graph = self.contact_graph(float(t_s))
        arr = earliest_arrival(graph, [int(sat_idx)], float(t_s))
        ends = self.station_upload_end(np.arange(self.n_sats), arr[0])
        exit_sat = int(np.argmin(ends))
        end = float(ends[exit_sat])
        if not np.isfinite(end):
            return end, -1, []
        pred = predecessors(graph, [int(sat_idx)], arr)
        hops = extract_paths(pred, [int(sat_idx)], [exit_sat])[0, 0]
        return end, exit_sat, [int(h) for h in hops[hops >= 0]]

    def station_upload_end(self, sat_idx, t_s) -> np.ndarray:
        """Earliest completion of an upload from satellite(s) ready at
        ``t_s``: wait for the satellite's next station contact, then one
        SHL transfer through the first station that sees it. Inputs
        broadcast; returns absolute end times (inf when no contact
        remains before the horizon) — the batched per-segment pricing
        behind the routed strategies' exit decisions.
        """
        step = self.cfg.time_step_s
        T = self.sat_next.shape[1]
        sat, t = np.broadcast_arrays(np.asarray(sat_idx, dtype=np.int64),
                                     np.asarray(t_s, dtype=np.float64))
        fin = np.isfinite(t) & (t <= self.horizon_s)
        ti = np.where(fin, t, 0.0)
        i0 = self.tidx(ti)
        j = self.sat_next[sat, i0]
        tt = ti + np.maximum(0, j - i0) * step
        ok = fin & (j < T) & (tt <= self.horizon_s)
        jj = np.minimum(j, T - 1)
        owner = self.vis[:, sat, jj].argmax(axis=0)
        shl = self.shl_delays(owner, sat, jj)
        return np.where(ok, tt + shl, np.inf)

    def upload_survives(self, sat_idx, t_s) -> np.ndarray:
        """True where an upload attempted by ``sat_idx`` at sim time
        ``t_s`` is NOT lost (fault plane ``upload_loss`` stream; inputs
        broadcast). All-True when no fault plane is configured — the
        plan phases gate on :attr:`fault_plane` first, so the no-fault
        path never even asks."""
        sat = np.asarray(sat_idx, dtype=np.int64)
        if self.fault_plane is None:
            return np.ones(np.broadcast_shapes(
                sat.shape, np.shape(t_s)), dtype=bool)
        return self.fault_plane.upload_ok[sat, self.tidx(t_s)]

    def upload_end(self, sat_idx, t_s) -> np.ndarray:
        """:meth:`station_upload_end` made lost-upload aware: an upload
        whose contact step is marked lost by the fault plane retries
        through the *next* contact, up to ``MAX_UPLOAD_RETRIES``
        consecutive losses (then inf — the next-contact-horizon
        timeout). Monotone nondecreasing in ``t_s`` like the base
        pricer, so ``cap=``-pruned routed sweeps stay exact. Delegates
        untouched (bit-identical) when no upload losses are configured.
        The cycle strategies price their exits through this; round
        strategies instead drop lost uploads from the fold weights at
        plan time (a round barrier can't wait on a straggler retry).
        """
        plane = self.fault_plane
        if plane is None or plane.spec.upload_loss <= 0.0:
            return self.station_upload_end(sat_idx, t_s)
        step = self.cfg.time_step_s
        T = self.sat_next.shape[1]
        sat, t = np.broadcast_arrays(np.asarray(sat_idx, dtype=np.int64),
                                     np.asarray(t_s, dtype=np.float64))
        scalar = sat.ndim == 0
        sat = np.atleast_1d(np.ascontiguousarray(sat))
        t = np.atleast_1d(t)
        cur = np.array(t, dtype=np.float64)
        out = np.full(sat.shape, np.inf)
        pending = np.ones(sat.shape, dtype=bool)
        for _ in range(MAX_UPLOAD_RETRIES):
            fin = pending & np.isfinite(cur) & (cur <= self.horizon_s)
            if not fin.any():
                break
            ti = np.where(fin, cur, 0.0)
            i0 = self.tidx(ti)
            j = self.sat_next[sat, i0]
            tt = ti + np.maximum(0, j - i0) * step
            ok = fin & (j < T) & (tt <= self.horizon_s)
            jj = np.minimum(j, T - 1)
            survives = plane.upload_ok[sat, jj]
            done = ok & survives
            if done.any():
                owner = self.vis[:, sat, jj].argmax(axis=0)
                shl = self.shl_delays(owner, sat, jj)
                out = np.where(done, tt + shl, out)
            # Lost attempts restart after the contact step they burned;
            # everything else (no contact left / out of horizon) stays
            # inf and stops retrying.
            pending = ok & ~survives
            cur = np.where(pending, (jj + 1) * step, cur)
        return out[0] if scalar else out

    def _orbit_window(self, l: int, i0: int) -> ContactGraph:
        """One induced intra-plane window of orbit ``l`` (LRU-cached
        gathers of the compiled full window at ``i0``)."""
        key = (l, i0)
        sub = self._orbit_graphs.get(key)
        if sub is None:
            sub = subgraph(self._window_graph(i0),
                           self.constellation._orbit_table[l])
            self._orbit_graphs[key] = sub
            if len(self._orbit_graphs) > 4 * self.cfg.num_orbits:
                self._orbit_graphs.popitem(last=False)
        else:
            self._orbit_graphs.move_to_end(key)
        return sub

    def orbit_subgraph(self, l: int, t_s: float = 0.0) \
            -> Union[ContactGraph, WindowedRouter]:
        """Induced intra-plane contact graph of orbit ``l`` covering
        ``t_s`` (cached): the ring members plus every intra-plane chord
        with line of sight — the substrate of sink-election routing.
        Past the grid byte budget this is a stitched sub-router whose
        windows gather lazily from the full-shell windows."""
        if self._window_steps >= len(self.grid_t):
            return self._orbit_window(l, 0)
        sub = self._orbit_routers.get(l)
        if sub is None:
            sub = WindowedRouter(
                self.grid_t, self.cfg.sats_per_orbit, self._window_steps,
                lambda i0, l=l: self._orbit_window(l, i0))
            self._orbit_routers[l] = sub
        return sub

    def _sink_cache_put(self, key: Any, el: SinkElection) -> None:
        self._sink_cache[key] = el
        if len(self._sink_cache) > 1024:
            self._sink_cache.popitem(last=False)

    def _elect_rows(self, ls, ts) -> list[SinkElection]:
        """Per-(orbit, time) election rows for a batch of cycle events:
        cache-hit rows come from the sink cache, every miss is scored in
        ONE :func:`repro_torch.orbits.routing.elect_sinks` call over the
        block-diagonal intra-plane graph (global member ids, per-orbit
        ``t0`` vector) — the batched plan-phase path. Disjoint blocks
        relax independently, so each returned row is bit-equal to the
        orbit's own induced-subgraph election."""
        cfg = self.cfg
        L, k = cfg.num_orbits, cfg.sats_per_orbit
        table = self.constellation._orbit_table
        out: list[Optional[SinkElection]] = [None] * len(ls)
        miss: dict[tuple, list[int]] = {}
        for i, (l, t) in enumerate(zip(ls, ts)):
            key = ((int(l),), round(float(t), 6))
            el = self._sink_cache.get(key)
            if el is not None:
                self._sink_cache.move_to_end(key)
                out[i] = el
            else:
                miss.setdefault(key, []).append(i)
        if miss:
            keys = list(miss)
            ml = [key[0][0] for key in keys]
            mt = np.array([float(ts[miss[key][0]]) for key in keys])
            members = table[ml]                              # (M, k)
            sizes = self.sizes.reshape(L, k)[ml]

            def exit_cost(mem, ready):
                # contact wait + SHL from the candidate's own delivery
                # time (the delivery delta itself is already in the
                # chain-weighted arrival-delay term of the score).
                ok = np.isfinite(ready)
                rf = np.where(ok, ready, 0.0)
                end = self.station_upload_end(mem, rf)
                return np.where(ok, end - rf, np.inf)

            el = elect_sinks(
                self.intra_plane_graph(float(mt.min())), members, sizes,
                mt, exit_cost, cfg.partial_mode,
                lam=self._onehot_lam[ml])
            for j, key in enumerate(keys):
                row = SinkElection(
                    sinks=el.sinks[j:j + 1],
                    sink_slots=el.sink_slots[j:j + 1],
                    scores=el.scores[j:j + 1],
                    lam=el.lam[j:j + 1],
                    delivery=el.delivery[j:j + 1],
                    all_scores=el.all_scores[j:j + 1])
                self._sink_cache_put(key, row)
                for i in miss[key]:
                    out[i] = row
        return out

    @staticmethod
    def _concat_elections(rows) -> SinkElection:
        return SinkElection(
            sinks=np.concatenate([r.sinks for r in rows]),
            sink_slots=np.concatenate([r.sink_slots for r in rows]),
            scores=np.concatenate([r.scores for r in rows]),
            lam=np.concatenate([r.lam for r in rows]),
            delivery=np.concatenate([r.delivery for r in rows]),
            all_scores=np.concatenate([r.all_scores for r in rows]),
        )

    def elect_sinks_batch(self, orbits, ts) -> SinkElection:
        """Sink elections for a *batch* of cycle events — orbit ``i``
        ready at ``ts[i]`` — scored in one vectorized call over the
        block-diagonal intra-plane graph (cache-missing rows only);
        the known remaining host cost of the async/buffered plan phase.
        Rows concatenate in event order; ``sinks`` are global ids."""
        rows = self._elect_rows([int(l) for l in orbits],
                                [float(t) for t in ts])
        return self._concat_elections(rows)

    def elect_sinks(self, t_s: float,
                    orbits: Optional[Any] = None) -> SinkElection:
        """Per-orbit sink election at ``t_s`` (memoized — the sink cache).

        Scores every orbit member by Eq.-14-chain-weighted *intra-plane*
        routed arrival delay plus its station exit cost — priced by
        :meth:`station_upload_end` at each candidate's own delivery
        time, so a contact window that closes while the chain is still
        folding never wins an election — and elects the argmin; see
        :func:`repro_torch.orbits.routing.elect_sinks`. All selected orbits
        are scored by one vectorized call over the block-diagonal
        intra-plane graph (:meth:`intra_plane_graph`) — bit-equal to
        routing each orbit's induced subgraph (:meth:`orbit_subgraph`,
        the blocks are disjoint) with the per-orbit Python eliminated.
        ``orbits`` restricts the election (e.g. one orbit of an async
        cycle); default all. Returned ``sinks`` are global ids.
        """
        L = self.cfg.num_orbits
        sel = tuple(range(L)) if orbits is None \
            else tuple(int(x) for x in orbits)
        key = (sel, round(float(t_s), 6))
        el = self._sink_cache.get(key)
        if el is not None:
            self._sink_cache.move_to_end(key)
            return el
        el = self._concat_elections(
            self._elect_rows(list(sel), [float(t_s)] * len(sel)))
        self._sink_cache_put(key, el)
        return el

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

    # ----------------------------------------------------- checkpointing
    def ckpt_resume(self, s: RunState, tree: Any) -> Optional[Any]:
        """Restore run state from the latest snapshot, if resuming.

        Called once by every fused loop (and the per-round loop) before
        its first block, with ``tree`` the strategy's device-state
        template (matching what it hands :meth:`ckpt_tick`). Returns the
        loaded tree, its leaves on the template's device — the caller
        swaps its device state in — or None when there is nothing to
        resume. Restores the run counters (t/acc/events/history), the
        engine rng stream (the static plane's sampler), the sampled/geo
        client-plane call counter, and stashes the strategy's host plan
        state for :meth:`ckpt_meta`. The fault plane and all
        contact/election caches are pure functions of (config, grid
        time) and rebuild identically.
        """
        ck = self._ckpt
        if ck is None or not ck.resume:
            return None
        try:
            loaded, manifest = load_checkpoint(ck.directory, tree)
        except FileNotFoundError:
            return None          # nothing saved yet: fresh start
        meta = manifest["metadata"]
        s.t = float(meta["t"])
        s.acc = float(meta["acc"])
        s.events = int(meta["events"])
        s.history = [(float(t), int(e), float(a))
                     for t, e, a in meta["history"]]
        self.rng.bit_generator.state = meta["rng_state"]
        if meta.get("plane_calls") is not None and \
                hasattr(self.client_plane, "_calls"):
            self.client_plane._calls = int(meta["plane_calls"])
        ck.strategy_meta = meta.get("strategy_meta")
        ck.step = int(manifest["step"])
        ck.last_saved = s.events
        return loaded

    def ckpt_meta(self) -> Any:
        """The resumed strategy's host plan state (``strategy_meta`` of
        the loaded snapshot); None outside a resume."""
        return None if self._ckpt is None else self._ckpt.strategy_meta

    def ckpt_tick(self, s: RunState, tree: Any, meta: Any = None) -> None:
        """Snapshot at a safe block boundary when the cadence is due
        (every ``checkpoint_every`` events since the last save). No-op
        outside a ``run(checkpoint_dir=)``. ``tree`` is the strategy's
        full device state; ``meta`` its JSON-able host plan state."""
        ck = self._ckpt
        if ck is None or s.events - ck.last_saved < ck.every:
            return
        ck.step += 1
        md = {
            "t": float(s.t), "acc": float(s.acc), "events": int(s.events),
            "history": [[float(t), int(e), float(a)]
                        for t, e, a in s.history],
            "rng_state": self.rng.bit_generator.state,
            "plane_calls": getattr(self.client_plane, "_calls", None),
            "strategy_meta": meta,
        }
        save_checkpoint(ck.directory, tree, ck.step, metadata=md)
        ck.last_saved = s.events

    # -------------------------------------------------------------- run
    def run(self, strategy: Union[str, Strategy, None] = None,
            fused: Optional[bool] = None, *,
            init_params: Optional[dict] = None,
            checkpoint_dir: Any = None, resume: bool = False,
            checkpoint_every: int = 8) -> SimResult:
        """Drive the configured (or given) strategy to completion.

        ``fused`` selects the execution path (default
        ``SimConfig.fused``): the plan-ahead block loop — K planned
        rounds or events per executor call, host only between blocks —
        or the per-round reference loop.

        ``init_params`` is a numpy param tree (for example the JAX
        package's init, exported leaf by leaf) to start from instead of
        the port's own seeded init; it is carried over with
        :func:`repro_torch.models.params_from_numpy`.

        ``checkpoint_dir`` turns on crash recovery: every
        ``checkpoint_every`` events the loop snapshots params (plus any
        strategy device state), run counters, rng/plane counters, and
        history through :mod:`repro_torch.checkpoint`; ``resume=True``
        picks up from the latest snapshot, and the resumed run is
        bit-identical to an uninterrupted one (the planes are
        time-indexed, so replanning from the restored clock reproduces
        the schedule; on the card the executor restricts cuDNN to its
        deterministic algorithms). On the per-round reference path only
        the round-barrier strategies checkpoint (cycle/tick strategies
        keep per-event host trees there; use the fused loop).
        """
        strat = strategy if isinstance(strategy, Strategy) else \
            get_strategy(strategy or self.cfg.strategy)()
        cfg = self.cfg
        use_fused = cfg.fused if fused is None else fused
        if checkpoint_dir is not None:
            if not use_fused and not isinstance(strat, RoundStrategy):
                raise ValueError(
                    "checkpoint_dir on the per-round reference path is "
                    "only supported for round-barrier strategies; the "
                    f"{type(strat).__name__} event loop checkpoints "
                    "through the fused loop (fused=True)")
            self._ckpt = _CkptState(checkpoint_dir,
                                    max(1, int(checkpoint_every)), resume)
        params = (self.trainer.init(cfg.seed) if init_params is None
                  else params_from_numpy(init_params, self.device))
        s = RunState(params=params)
        try:
            if use_fused:
                if self._fused_cm is not None:
                    with self._fused_cm():
                        strat.run_fused(self, s)
                else:
                    strat.run_fused(self, s)
            else:
                loaded = self.ckpt_resume(s, {"params": s.params})
                if loaded is not None:
                    s.params = loaded["params"]
                while (s.events < cfg.max_rounds and s.t <= self.horizon_s
                       and s.acc < cfg.target_accuracy):
                    if not strat.step(self, s):
                        break
                    self.ckpt_tick(s, {"params": s.params})
        finally:
            self._ckpt = None
        return SimResult(s.history, s.acc, len(s.history), s.t / 3600.0)


# The engine is API-compatible with the pre-registry monolith.
SatcomSimulator = RoundEngine

__all__ = ["SimConfig", "SimResult", "RoundEngine", "SatcomSimulator",
           "_make_stations"]
