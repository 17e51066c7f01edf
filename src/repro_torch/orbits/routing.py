"""Time-expanded contact-graph routing over ISL line-of-sight grids.

FedHAP's speedup comes from models hopping between satellites over
inter-satellite links; the successor work (Elmahallawy & Luo,
arXiv:2302.13447) shows that *which* satellite sinks an orbit's model and
along *which* ISL path it travels is the next lever. This module is that
routing subsystem, built on the batched geometry engine:

- :class:`ContactGraph` — the dense time-expanded graph: the all-pairs
  ``(S, S, T)`` ISL LoS grid (`repro.orbits.sat_sat_visibility_mask` /
  `isl_mask_from_positions`) compiled into a next-contact *edge table*
  (one ``minimum.accumulate`` per edge series, the same trick as the
  engine's station contact tables), plus the stacked ``(S, T, 3)``
  positions used to price each edge at its actual contact geometry.
- :class:`SparseContactGraph` — the CSR form of the same graph: only
  pairs with *any* contact in the window (optionally pre-filtered by a
  locality ``pair_mask``, e.g. the intra-plane block diagonal) store an
  ``(E, T)`` LoS series + next-contact row. Lossless by construction —
  a pair absent from the table has no contact in the window, exactly
  the edges the dense relaxation prices at ``inf`` — so sparse routing
  is bit-equal to dense. Dense ``isl_vis`` / ``edge_next`` views
  materialize lazily (equivalence oracle + diagnostics).
- :func:`earliest_arrival` — batched shortest-delay search: a
  label-correcting Bellman-Ford over time slices with **sparse frontier
  masking** — each sweep expands only the (row, satellite) labels that
  improved in the previous sweep (gather next contact -> price edge ->
  scatter/segment min-reduce), instead of the full ``(N, S, S)``
  product. Waiting at a satellite is free; a transmission departs at
  the edge's next contact on the grid. The relaxation is *resumable*:
  ``init`` warm-starts it from a previous arrival frontier, so it can
  be chained across grid windows. ``t0`` may be per-source.
  :func:`earliest_arrival_dense` retains the full dense relaxation as
  the equivalence oracle the frontier must bit-match.
- :func:`predecessors` / :func:`extract_path` / :func:`extract_paths` —
  routed multi-hop paths recovered from the converged arrival table
  (``extract_paths`` replays whole predecessor tables as one vectorized
  backward walk).
- :class:`WindowedRouter` — the stitched window chain for grids too
  large to materialize whole (``SimConfig.isl_grid_max_bytes``):
  half-overlapping windows of the horizon are compiled lazily (through
  the engine's LRU, incrementally advanced from their overlapping
  predecessor — see ``build_contact_graph(reuse=...)``) and relaxed in
  order, each warm-started from the previous window's frontier, until
  no later departure can improve any arrival (callers with a narrower
  objective pass ``stop`` to cut the chain as soon as *their* labels
  settle). Per-window predecessor tables are spliced into one global
  hop list, so windowed routing is exact against the single-graph
  oracle (`build_contact_graph` over the full horizon) — routes that
  cross a window boundary are no longer dropped.
- :func:`earliest_arrival_reference` — the per-edge Python
  label-correcting reference the batched search must match (allclose).
- :func:`elect_sinks` — per-orbit sink election: each candidate is
  scored by the Eq.-14 chain weights of its members
  (`repro.core.weights.chain_stats` with a one-hot visible ring — the
  closed-form intra-plane propagation weighting) applied to the members'
  routed arrival delays, plus a caller-supplied exit cost (e.g. wait
  until the candidate's next station contact + SHL transfer). Accepts a
  per-orbit ``t0`` vector, so one call scores a whole *batch* of cycle
  events (different orbits ready at different times) over one shared
  (block-diagonal) graph.

Delay model: every ISL is FSO (paper §III-A); an edge departing at
contact index ``j`` costs ``model_transfer_delay_s(n_params, |r_a(t_j) -
r_b(t_j)|, "fso")`` and arrives at ``grid_t[j] + delay``.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional, Sequence, Union

import numpy as np

from repro_torch.core.weights import chain_stats
from repro_torch.orbits.constellation import WalkerConstellation
from repro_torch.orbits.links import model_transfer_delay_s
from repro_torch.orbits.visibility import (
    isl_mask_from_positions,
    isl_pairs_visible,
    next_contact_table,
)

_EPS_S = 1e-9      # arrival-improvement tolerance (seconds)


class _GraphOps:
    """Shared grid/pricing surface of the dense and CSR contact graphs
    (both carry ``grid_t``/``positions``/``n_params`` fields)."""

    @property
    def n_sats(self) -> int:
        return self.positions.shape[0]

    @property
    def n_steps(self) -> int:
        return len(self.grid_t)

    @property
    def step_s(self) -> float:
        return float(self.grid_t[1] - self.grid_t[0]) if self.n_steps > 1 \
            else 1.0

    def time_index(self, t_s) -> np.ndarray:
        """Smallest grid index with ``grid_t[i] >= t`` (ceil); the
        sentinel ``n_steps`` past the grid end or for non-finite t."""
        t = np.asarray(t_s, dtype=np.float64)
        T = self.n_steps
        fin = np.isfinite(t)
        rel = (np.where(fin, t, 0.0) - self.grid_t[0]) / self.step_s
        i = np.clip(np.ceil(rel - 1e-9).astype(np.int64), 0, T)
        return np.where(fin, i, T)

    def edge_delay(self, a_idx, b_idx, t_idx) -> np.ndarray:
        """FSO transfer delay of edges (a, b) departing at grid index
        ``t_idx``; all three index arrays broadcast together."""
        pa = self.positions[a_idx, t_idx]
        pb = self.positions[b_idx, t_idx]
        dist = np.linalg.norm(pa - pb, axis=-1)
        return model_transfer_delay_s(self.n_params, dist, "fso")

    @functools.cached_property
    def delay_tab(self) -> np.ndarray:
        """Lazily cached ``(S, S, T)`` float64 FSO delay table: the
        whole window's edge pricing computed once, so every frontier
        sweep is a pure table gather instead of a position-gather +
        norm per candidate (the dominant relaxation cost at mega
        scale). Built by the same elementwise float64 pipeline as
        :meth:`edge_delay`, so gathers from the table are bit-identical
        to on-the-fly pricing — frontier results stay bit-equal to the
        dense oracle. Costs 8/3x the bool+int grid tables in RAM, per
        LRU-cached window, and only materializes when a relaxation
        actually runs on the graph."""
        S, T = self.n_sats, self.n_steps
        out = np.empty((S, S, T))
        chunk = max(1, (1 << 27) // max(1, S * S * 8 * 3))
        for lo in range(0, T, chunk):
            sl = slice(lo, min(T, lo + chunk))
            dist = np.linalg.norm(self.positions[:, None, sl, :]
                                  - self.positions[None, :, sl, :],
                                  axis=-1)
            out[:, :, sl] = model_transfer_delay_s(self.n_params, dist,
                                                   "fso")
        return out


@dataclasses.dataclass(frozen=True)
class ContactGraph(_GraphOps):
    """Dense time-expanded ISL contact graph over a uniform time grid.

    ``grid_t``: ``(T,)`` seconds (uniform step); ``positions``:
    ``(S, T, 3)`` ECI; ``isl_vis``: ``(S, S, T)`` bool LoS grid (zero
    diagonal); ``edge_next``: ``(S, S, T)`` int — ``edge_next[a, b, i]``
    is the smallest grid index ``j >= i`` with the (a, b) ISL up, or the
    sentinel ``T``; ``n_params`` prices edges via the FSO link budget.
    """
    grid_t: np.ndarray
    positions: np.ndarray
    isl_vis: np.ndarray
    edge_next: np.ndarray
    n_params: int
    fault_mask: Optional[np.ndarray] = None  # as passed to the builder


@dataclasses.dataclass(frozen=True)
class SparseContactGraph(_GraphOps):
    """CSR time-expanded ISL contact graph: per-satellite neighbor lists.

    Row ``a``'s feasible neighbors are ``nbr_ids[nbr_ptr[a]:
    nbr_ptr[a+1]]`` (ascending); edge ``e`` carries its LoS series
    ``nbr_vis[e]`` and next-contact row ``nbr_next[e]`` (sentinel ``T``).
    Only pairs with at least one contact in the window are stored — and
    only pairs a ``pair_mask`` locality filter admitted were ever
    *tested* — so ``E`` tracks the graph's true connectivity (e.g. the
    intra-plane block diagonal stores ``L*k^2`` candidates instead of
    ``S^2``). Dense ``isl_vis``/``edge_next`` views materialize lazily
    on first access (``functools.cached_property`` writes the instance
    dict directly, so the dataclass may stay frozen): the CSR graph
    answers every dense diagnostic and the dense relaxation oracle
    (:func:`earliest_arrival_dense`) runs on it unchanged.
    """
    grid_t: np.ndarray
    positions: np.ndarray
    nbr_ptr: np.ndarray        # (S+1,) int64 CSR row pointers
    nbr_row: np.ndarray        # (E,) int32 source satellite per edge
    nbr_ids: np.ndarray        # (E,) int32 neighbor satellite per edge
    nbr_vis: np.ndarray        # (E, T) bool LoS series
    nbr_next: np.ndarray       # (E, T) int16/int32 next-contact rows
    n_params: int
    pair_mask: Optional[np.ndarray] = None   # (S, S) candidate filter
    fault_mask: Optional[np.ndarray] = None  # as passed to the builder

    @property
    def n_edges(self) -> int:
        return len(self.nbr_ids)

    @functools.cached_property
    def isl_vis(self) -> np.ndarray:
        """Lazily densified ``(S, S, T)`` LoS grid (oracle/diagnostics;
        identical to the dense build restricted to tested pairs)."""
        S, T = self.n_sats, self.n_steps
        out = np.zeros((S, S, T), dtype=bool)
        out[self.nbr_row, self.nbr_ids] = self.nbr_vis
        return out

    @functools.cached_property
    def edge_next(self) -> np.ndarray:
        """Lazily densified ``(S, S, T)`` next-contact table (untested /
        contact-free pairs hold the sentinel ``T`` everywhere)."""
        S, T = self.n_sats, self.n_steps
        out = np.full((S, S, T), T, dtype=self.nbr_next.dtype)
        out[self.nbr_row, self.nbr_ids] = self.nbr_next
        return out

    @functools.cached_property
    def edge_delay_tab(self) -> np.ndarray:
        """Lazily cached ``(E, T)`` float64 FSO delay table of the
        stored edges — the CSR counterpart of
        :attr:`_GraphOps.delay_tab`, same bit-identical elementwise
        pipeline as :meth:`edge_delay`."""
        E, T = self.n_edges, self.n_steps
        out = np.empty((E, T))
        chunk = max(1, (1 << 27) // max(1, T * 8 * 3))
        for lo in range(0, E, chunk):
            sl = slice(lo, min(E, lo + chunk))
            dist = np.linalg.norm(self.positions[self.nbr_row[sl]]
                                  - self.positions[self.nbr_ids[sl]],
                                  axis=-1)
            out[sl] = model_transfer_delay_s(self.n_params, dist, "fso")
        return out


AnyContactGraph = Union[ContactGraph, SparseContactGraph]


def _edge_dtype(n_steps: int):
    # The sentinel is T itself, so the dtype must represent T+1 values
    # (0..T inclusive): int16 is good through exactly T = 32767.
    return np.int16 if n_steps <= np.iinfo(np.int16).max else np.int32


def _reuse_offset(prev: Optional[AnyContactGraph],
                  grid_t: np.ndarray) -> Optional[int]:
    """Grid offset of ``grid_t`` inside ``prev``'s grid when the two
    windows overlap head-to-tail (prev starts earlier, same step and
    phase); None when no reusable overlap exists."""
    if prev is None or prev.n_steps < 2 or len(grid_t) < 1:
        return None
    step = prev.step_s
    off_f = (float(grid_t[0]) - float(prev.grid_t[0])) / step
    off = int(round(off_f))
    if abs(off_f - off) > 1e-9 or not (0 <= off < prev.n_steps):
        return None
    n_ov = min(prev.n_steps - off, len(grid_t))
    if n_ov < 1 or not np.array_equal(prev.grid_t[off:off + n_ov],
                                      grid_t[:n_ov]):
        return None
    return off


def _fault_edges(fault_mask: Optional[np.ndarray],
                 n_sats: int) -> Optional[np.ndarray]:
    """Normalize a builder ``fault_mask`` to an ``(S, S)`` bool edge-dead
    matrix: a 1-D ``(S,)`` mask marks whole satellites failed (every
    incident edge dies), a 2-D ``(S, S)`` mask marks edge pairs
    directly. None when nothing is actually masked."""
    if fault_mask is None:
        return None
    fm = np.asarray(fault_mask, dtype=bool)
    if fm.ndim == 1:
        if fm.shape != (n_sats,):
            raise ValueError(f"fault_mask shape {fm.shape} != ({n_sats},)")
        dead = fm[:, None] | fm[None, :]
    elif fm.shape == (n_sats, n_sats):
        dead = fm
    else:
        raise ValueError(
            f"fault_mask must be ({n_sats},) or ({n_sats}, {n_sats}), "
            f"got {fm.shape}")
    return dead if dead.any() else None


def _mask_compat(a: Optional[np.ndarray], b: Optional[np.ndarray]) -> bool:
    """Reuse compatibility of two builder masks (pair or fault): both
    absent, the same object, or elementwise equal."""
    if (a is None) != (b is None):
        return False
    return a is None or a is b or (a.shape == np.shape(b)
                                   and np.array_equal(a, b))


def _csr_compile(a_ids: np.ndarray, b_ids: np.ndarray, vis: np.ndarray,
                 grid_t: np.ndarray, positions: np.ndarray, n_params: int,
                 pair_mask: Optional[np.ndarray],
                 fault_mask: Optional[np.ndarray] = None
                 ) -> SparseContactGraph:
    """Compact an (E0, T) candidate-pair LoS block into CSR form: drop
    contact-free pairs, sort rows by (a, b), build row pointers and the
    per-edge next-contact table."""
    S = positions.shape[0]
    keep = vis.any(axis=1)
    a_ids, b_ids, vis = a_ids[keep], b_ids[keep], vis[keep]
    order = np.lexsort((b_ids, a_ids))
    a_ids, b_ids, vis = a_ids[order], b_ids[order], np.ascontiguousarray(
        vis[order])
    ptr = np.zeros(S + 1, dtype=np.int64)
    np.cumsum(np.bincount(a_ids, minlength=S), out=ptr[1:])
    return SparseContactGraph(
        grid_t=grid_t, positions=positions, nbr_ptr=ptr,
        nbr_row=a_ids.astype(np.int32), nbr_ids=b_ids.astype(np.int32),
        nbr_vis=vis,
        nbr_next=next_contact_table(vis, dtype=_edge_dtype(len(grid_t))),
        n_params=n_params, pair_mask=pair_mask, fault_mask=fault_mask)


def _pair_overlap_vis(prev: SparseContactGraph, off: int, n_ov: int,
                      a_ids: np.ndarray, b_ids: np.ndarray) -> np.ndarray:
    """Reconstruct the overlap LoS columns of a candidate pair list from
    a previous CSR window: stored pairs copy their series, absent pairs
    had no contact anywhere in ``prev`` (hence none in the overlap) and
    stay False. Bit-equal to recomputing the geometry."""
    S = prev.n_sats
    keys = prev.nbr_row.astype(np.int64) * S + prev.nbr_ids
    cand = a_ids.astype(np.int64) * S + b_ids
    pos = np.searchsorted(keys, cand)
    pos_c = np.minimum(pos, max(0, len(keys) - 1))
    hit = (len(keys) > 0) & (keys[pos_c] == cand)
    out = np.zeros((len(a_ids), n_ov), dtype=bool)
    if hit.any():
        out[hit] = prev.nbr_vis[pos_c[hit], off:off + n_ov]
    return out


def build_contact_graph(
    constellation: WalkerConstellation,
    grid_t: np.ndarray,
    n_params: int,
    grazing_altitude_m: float = 80_000.0,
    positions: Optional[np.ndarray] = None,
    sparse: bool = False,
    pair_mask: Optional[np.ndarray] = None,
    reuse: Optional[AnyContactGraph] = None,
    fault_mask: Optional[np.ndarray] = None,
) -> AnyContactGraph:
    """Compile the time-expanded ISL contact graph for a constellation.

    One stacked propagation (reused when ``positions`` is supplied, e.g.
    a window of the engine's cached ephemeris), one chunked LoS build,
    and one vectorized next-contact sweep per edge series. The edge
    table is int16 when the grid fits (it does for every simulator
    horizon under ~32k steps), halving the dominant allocation on
    mega-constellation shells.

    ``sparse`` compiles a :class:`SparseContactGraph` instead of the
    dense tables; ``pair_mask`` (sparse only) restricts the *candidate*
    pairs whose geometry is evaluated at all — e.g.
    ``WalkerConstellation.same_plane_mask`` turns the build into ``L``
    independent ``k x k`` blocks, the batched-election substrate.

    ``reuse`` advances a window **incrementally**: when the previous
    graph's grid overlaps this one's head (the stitched chain always
    steps by half a window), the overlap's LoS columns are copied from
    the previous window and only the fresh tail steps' geometry is
    recomputed — bit-equal to a cold build, since the LoS test is
    elementwise on identical position slices. Incompatible ``reuse``
    (different step/phase, dense vs sparse, different mask) is ignored.

    ``fault_mask`` degrades the graph for fault injection
    (``repro.faults``): a 1-D ``(S,)`` bool marks whole satellites
    failed (every incident edge severed), a 2-D ``(S, S)`` bool marks
    edge pairs directly (e.g. failed ISL terminal acquisitions). The
    mask is time-constant, applied to the LoS series before the
    next-contact compile on both the dense and CSR paths, and recorded
    on the graph: incremental ``reuse`` is honored only when the
    previous window carried the same mask — overlap columns copied from
    such a window are already masked, so re-masking is idempotent and
    the advance stays bit-equal to a cold masked build.
    """
    grid_t = np.asarray(grid_t, dtype=np.float64)
    if positions is None:
        positions = constellation.positions_eci(grid_t)
    S, T = positions.shape[0], len(grid_t)
    if pair_mask is not None and not sparse:
        raise ValueError("pair_mask requires sparse=True (a dense graph "
                         "with silently missing pairs would break the "
                         "oracle semantics)")
    dead = _fault_edges(fault_mask, S)

    if not sparse:
        off = None
        if isinstance(reuse, ContactGraph) and \
                _mask_compat(reuse.fault_mask, fault_mask):
            off = _reuse_offset(reuse, grid_t)
        if off is None:
            isl = isl_mask_from_positions(positions, grazing_altitude_m)
        else:
            n_ov = min(reuse.n_steps - off, T)
            isl = np.empty((S, S, T), dtype=bool)
            isl[:, :, :n_ov] = reuse.isl_vis[:, :, off:off + n_ov]
            if n_ov < T:
                isl[:, :, n_ov:] = isl_mask_from_positions(
                    positions[:, n_ov:], grazing_altitude_m)
        if dead is not None:
            isl &= ~dead[:, :, None]     # idempotent on reused columns
        edge_next = next_contact_table(isl, dtype=_edge_dtype(T))
        return ContactGraph(grid_t=grid_t, positions=positions,
                            isl_vis=isl, edge_next=edge_next,
                            n_params=n_params, fault_mask=fault_mask)

    prev = reuse if isinstance(reuse, SparseContactGraph) else None
    if prev is not None and not (
            _mask_compat(prev.pair_mask, pair_mask)
            and _mask_compat(prev.fault_mask, fault_mask)):
        prev = None
    off = _reuse_offset(prev, grid_t)

    if pair_mask is not None:
        pm = np.array(pair_mask, dtype=bool)
        pm[np.arange(S), np.arange(S)] = False
        a_ids, b_ids = np.nonzero(pm)
        if off is None:
            vis = isl_pairs_visible(positions, a_ids, b_ids,
                                    grazing_altitude_m)
        else:
            n_ov = min(prev.n_steps - off, T)
            vis = np.empty((len(a_ids), T), dtype=bool)
            vis[:, :n_ov] = _pair_overlap_vis(prev, off, n_ov,
                                              a_ids, b_ids)
            if n_ov < T:
                vis[:, n_ov:] = isl_pairs_visible(
                    positions[:, n_ov:], a_ids, b_ids, grazing_altitude_m)
        if dead is not None:
            vis[dead[a_ids, b_ids]] = False
        return _csr_compile(a_ids, b_ids, vis, grid_t, positions,
                            n_params, pair_mask, fault_mask)

    # Unmasked sparse build: any-contact adjacency over all pairs.
    if off is None:
        isl = isl_mask_from_positions(positions, grazing_altitude_m)
        if dead is not None:
            isl &= ~dead[:, :, None]
        a_ids, b_ids = np.nonzero(isl.any(axis=-1))
        return _csr_compile(a_ids, b_ids, isl[a_ids, b_ids], grid_t,
                            positions, n_params, None, fault_mask)
    # Incremental: union of the previous window's pairs and pairs with
    # contact in the fresh tail; peak memory is S^2 * tail, not S^2 * T.
    n_ov = min(prev.n_steps - off, T)
    if n_ov < T:
        tail = isl_mask_from_positions(positions[:, n_ov:],
                                       grazing_altitude_m)
        if dead is not None:
            tail &= ~dead[:, :, None]
        adj = tail.any(axis=-1)
    else:
        tail, adj = None, np.zeros((S, S), dtype=bool)
    adj[prev.nbr_row, prev.nbr_ids] = True
    a_ids, b_ids = np.nonzero(adj)
    vis = np.empty((len(a_ids), T), dtype=bool)
    vis[:, :n_ov] = _pair_overlap_vis(prev, off, n_ov, a_ids, b_ids)
    if tail is not None:
        vis[:, n_ov:] = tail[a_ids, b_ids]
    return _csr_compile(a_ids, b_ids, vis, grid_t, positions,
                        n_params, None, fault_mask)


def subgraph(graph: "AnyContactGraph | WindowedRouter",
             sat_ids: Sequence[int]) -> "AnyContactGraph | WindowedRouter":
    """Induced contact graph over a subset of satellites (local ids
    0..n-1 in ``sat_ids`` order). Edge series are per-pair independent,
    so the sub-tables are plain gathers of the compiled full tables —
    used for intra-plane routing (sink election propagates models inside
    one orbit ring) where relaxing over the whole shell would be waste.
    A :class:`WindowedRouter` induces a sub-router whose windows are
    gathered lazily from the parent's; a :class:`SparseContactGraph`
    induces the renumbered CSR block of its surviving edges.
    """
    if isinstance(graph, WindowedRouter):
        return graph.subgraph(sat_ids)
    ids = np.asarray(sat_ids, dtype=np.int64)
    if isinstance(graph, SparseContactGraph):
        inv = np.full(graph.n_sats, -1, dtype=np.int64)
        inv[ids] = np.arange(len(ids))
        keep = (inv[graph.nbr_row] >= 0) & (inv[graph.nbr_ids] >= 0)
        return _csr_compile(
            inv[graph.nbr_row[keep]], inv[graph.nbr_ids[keep]],
            graph.nbr_vis[keep], graph.grid_t, graph.positions[ids],
            graph.n_params, None)
    return ContactGraph(
        grid_t=graph.grid_t,
        positions=graph.positions[ids],
        isl_vis=graph.isl_vis[np.ix_(ids, ids)],
        edge_next=graph.edge_next[np.ix_(ids, ids)],
        n_params=graph.n_params,
    )


def earliest_arrival(
    graph: "AnyContactGraph | WindowedRouter",
    sources: Sequence[int],
    t0,
    max_hops: Optional[int] = None,
    init: Optional[np.ndarray] = None,
    cap: Optional[Callable[[np.ndarray], np.ndarray]] = None,
) -> np.ndarray:
    """Batched earliest-arrival over the time-expanded graph.

    ``sources``: ``(N,)`` satellite ids, each holding a model at time
    ``t0`` (a scalar, or an ``(N,)`` per-source vector — the batched
    form one sink election uses to score a whole block of cycle events).
    Returns ``(N, S)`` float arrival times (``inf`` where unreachable
    within the grid); ``arr[n, sources[n]] == t0[n]``.

    Label-correcting relaxation with **sparse frontier masking**: each
    sweep expands only labels that improved in the previous sweep —
    gather their edges' next contacts, price them at the contact
    geometry, and min-reduce per destination (segment-reduce on dense
    graphs, scatter-min on CSR graphs). A label that did not improve
    regenerates exactly the candidates already folded into ``arr`` by
    an earlier sweep, so skipping it is bit-exact against the full
    dense relaxation (:func:`earliest_arrival_dense`); convergence
    takes at most the hop diameter of the graph (capped at
    ``max_hops``, default S), the same bound as the dense loop.

    ``init`` warm-starts the relaxation from an ``(N, S)`` arrival
    frontier of a previous run instead of the point sources (every
    finite label seeds the first frontier) — the resumable form
    :class:`WindowedRouter` chains across grid windows (frontier
    entries before the window wait at their satellite for the window's
    first contact; entries past the window end cannot depart but can
    still be improved). A :class:`WindowedRouter` passed as ``graph``
    routes through its stitched window chain, where ``max_hops`` caps
    each *window's* relaxation; warm-starting a router is not
    supported — it owns its chain's frontiers.

    ``cap(arr) -> (N,)`` bound-prunes the frontier: after each sweep
    (and at seeding), labels at or past their row's cap are dropped
    from the frontier. Arrivals propagate monotonically (a candidate
    departs no earlier than its label), so every contribution routed
    through a pruned label lands at or past the cap — callers whose
    result only depends on sub-cap labels (e.g. a min of
    monotone-in-arrival exit prices whose current best IS the cap) get
    bit-exact answers while the frontier collapses to the labels that
    can still matter. Labels at or past the cap may keep pessimistic
    (or inf) values, so the full ``arr`` is NOT the uncapped result.
    """
    if isinstance(graph, WindowedRouter):
        if init is not None:
            raise ValueError(
                "init= warm-starts a single ContactGraph relaxation; a "
                "WindowedRouter chains its own frontiers")
        return graph.earliest_arrival(sources, t0, max_hops=max_hops,
                                      cap=cap)
    S = graph.n_sats
    src = np.atleast_1d(np.asarray(sources, dtype=np.int64))
    N = len(src)
    if init is None:
        arr = np.full((N, S), np.inf)
        arr[np.arange(N), src] = np.asarray(t0, dtype=np.float64)
    else:
        arr = np.array(init, dtype=np.float64, copy=True)
    expand = _expand_csr if isinstance(graph, SparseContactGraph) \
        else _expand_dense
    active = np.isfinite(arr)
    if cap is not None:
        active &= arr < np.asarray(cap(arr), dtype=np.float64)[:, None]
    for _ in range(max_hops or S):
        if not active.any():
            break
        nn, aa = np.nonzero(active)
        best = expand(graph, arr, nn, aa)
        improved = best < arr - _EPS_S
        if not improved.any():
            break
        arr = np.where(improved, best, arr)
        active = improved
        if cap is not None:
            active &= arr < np.asarray(cap(arr),
                                       dtype=np.float64)[:, None]
    return arr


def _expand_dense(graph: ContactGraph, arr: np.ndarray, nn: np.ndarray,
                  aa: np.ndarray) -> np.ndarray:
    """One frontier sweep over a dense graph: price every edge leaving
    the ``(F,)`` frontier labels ``arr[nn, aa]`` and segment-min-reduce
    back to ``(N, S)`` best candidates (inf where none)."""
    T = graph.n_steps
    best = np.full(arr.shape, np.inf)
    ia = graph.time_index(arr[nn, aa])                       # (F,)
    ok = ia < T
    if not ok.any():
        return best
    nn, aa, ia = nn[ok], aa[ok], ia[ok]
    nxt = graph.edge_next[aa, :, ia]                         # (F, S)
    j = np.minimum(nxt, T - 1)
    cand = np.where(
        nxt < T,
        graph.grid_t[j] + graph.delay_tab[aa[:, None],
                                          np.arange(graph.n_sats)[None, :],
                                          j],
        np.inf)
    # np.nonzero is row-major, so nn is non-decreasing: one reduceat
    # per frontier row-group folds all of a row's expansions at once.
    uniq, start = np.unique(nn, return_index=True)
    best[uniq] = np.minimum.reduceat(cand, start, axis=0)
    return best


def _expand_csr(graph: SparseContactGraph, arr: np.ndarray, nn: np.ndarray,
                aa: np.ndarray) -> np.ndarray:
    """One frontier sweep over a CSR graph: flatten the frontier's
    ragged neighbor lists, price each stored edge once, and scatter-min
    back to ``(N, S)``. Work is O(sum of frontier degrees), not O(F*S)."""
    T = graph.n_steps
    best = np.full(arr.shape, np.inf)
    ia = graph.time_index(arr[nn, aa])
    ok = ia < T
    if not ok.any():
        return best
    nn, aa, ia = nn[ok], aa[ok], ia[ok]
    ptr = graph.nbr_ptr
    deg = ptr[aa + 1] - ptr[aa]                              # (F,)
    tot = int(deg.sum())
    if tot == 0:
        return best
    # Flat CSR edge ids of every (frontier entry, neighbor) pair.
    ends = np.cumsum(deg)
    off = np.arange(tot) - np.repeat(ends - deg, deg)
    e = np.repeat(ptr[aa], deg) + off
    b = graph.nbr_ids[e].astype(np.int64)
    nxt = graph.nbr_next[e, np.repeat(ia, deg)]
    j = np.minimum(nxt, T - 1)
    cand = np.where(
        nxt < T,
        graph.grid_t[j] + graph.edge_delay_tab[e, j],
        np.inf)
    np.minimum.at(best, (np.repeat(nn, deg), b), cand)
    return best


def earliest_arrival_dense(
    graph: AnyContactGraph,
    sources: Sequence[int],
    t0,
    max_hops: Optional[int] = None,
    init: Optional[np.ndarray] = None,
) -> np.ndarray:
    """The retained full dense relaxation (equivalence oracle): every
    sweep evaluates the whole ``(N, S, S)`` candidate product, no
    frontier masking. Runs on CSR graphs too (through their lazily
    densified tables). :func:`earliest_arrival` must bit-match this."""
    S = graph.n_sats
    src = np.atleast_1d(np.asarray(sources, dtype=np.int64))
    N = len(src)
    if init is None:
        arr = np.full((N, S), np.inf)
        arr[np.arange(N), src] = np.asarray(t0, dtype=np.float64)
    else:
        arr = np.array(init, dtype=np.float64, copy=True)
    aidx = np.arange(S)[None, :, None]
    bidx = np.arange(S)[None, None, :]
    for _ in range(max_hops or S):
        cand = _relax_candidates(graph, arr, aidx, bidx)
        best = cand.min(axis=1)
        improved = best < arr - _EPS_S
        if not improved.any():
            break
        arr = np.where(improved, best, arr)
    return arr


def _relax_candidates(graph: AnyContactGraph, arr: np.ndarray,
                      aidx: np.ndarray, bidx: np.ndarray) -> np.ndarray:
    """One dense relaxation sweep: candidate arrivals ``(N, S, S)`` of
    every model at ``a`` (arrival ``arr[n, a]``) forwarded over (a, b)."""
    T = graph.n_steps
    ia = graph.time_index(arr)                            # (N, S)
    nxt = graph.edge_next[aidx, bidx,
                          np.minimum(ia, T - 1)[:, :, None]]
    nxt = np.where((ia < T)[:, :, None], nxt, T).astype(np.int64)
    j = np.minimum(nxt, T - 1)
    start = graph.grid_t[j]
    return np.where(nxt < T, start + graph.edge_delay(aidx, bidx, j),
                    np.inf)


def predecessors(graph: "AnyContactGraph | WindowedRouter",
                 sources: Sequence[int], arr: np.ndarray,
                 carry: Optional[np.ndarray] = None) -> np.ndarray:
    """Predecessor table of a converged :func:`earliest_arrival` result.

    One extra relaxation sweep against the final arrival times; returns
    ``(N, S)`` int — the satellite the shortest-delay route enters
    ``b`` from, or -1 at sources and unreachable satellites. Settled
    labels are judged under the same ``_EPS_S`` tolerance the arrival
    relaxation converges on — a looser (or tighter) epsilon here would
    let a frontier read settled in one pass and unsettled in the other,
    yielding spurious ``-1`` predecessors on converged tables. Ties
    break to the smallest predecessor id on both the dense and the CSR
    path (the CSR sweep's per-destination groups are scanned in
    ascending-``a`` order, matching the dense argmin).

    ``carry`` splices window chains: an ``(N, S)`` predecessor table
    from earlier windows whose non-negative entries (labels settled by
    an earlier window's contacts) take precedence over this sweep. A
    :class:`WindowedRouter` passed as ``graph`` walks its whole window
    chain and returns the spliced table (``carry`` is the per-window
    mechanism and cannot be combined with a router).
    """
    if isinstance(graph, WindowedRouter):
        if carry is not None:
            raise ValueError(
                "carry= splices single-window sweeps; a WindowedRouter "
                "builds the spliced table itself")
        return graph.predecessors(sources, arr)
    S = graph.n_sats
    src = np.atleast_1d(np.asarray(sources, dtype=np.int64))
    if isinstance(graph, SparseContactGraph):
        best, pred = _predecessor_sweep_csr(graph, arr)
    else:
        aidx = np.arange(S)[None, :, None]
        bidx = np.arange(S)[None, None, :]
        cand = _relax_candidates(graph, arr, aidx, bidx)
        best = cand.min(axis=1)
        pred = cand.argmin(axis=1)
    settled = np.isfinite(arr) & (best <= arr + _EPS_S)
    pred = np.where(settled, pred, -1)
    if carry is not None:
        pred = np.where(carry >= 0, carry, pred)
    pred[np.arange(len(src)), src] = -1
    return pred


def _predecessor_sweep_csr(graph: SparseContactGraph,
                           arr: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """CSR analogue of the dense predecessor sweep: per-destination
    ``(best, argmin-a)`` over the stored edges only (absent pairs price
    inf in the dense sweep and can never win)."""
    N = arr.shape[0]
    T, E = graph.n_steps, graph.n_edges
    best = np.full(arr.shape, np.inf)
    pred = np.zeros(arr.shape, dtype=np.int64)
    if E == 0:
        return best, pred
    a = graph.nbr_row.astype(np.int64)
    b = graph.nbr_ids.astype(np.int64)
    ia = graph.time_index(arr[:, a])                         # (N, E)
    nxt = graph.nbr_next[np.arange(E)[None, :],
                         np.minimum(ia, T - 1)]
    nxt = np.where(ia < T, nxt, T).astype(np.int64)
    j = np.minimum(nxt, T - 1)
    cand = np.where(nxt < T,
                    graph.grid_t[j] + graph.edge_delay(a[None, :],
                                                       b[None, :], j),
                    np.inf)
    # Group edges by destination, ascending source: first-match argmin
    # reproduces the dense argmin's smallest-a tie-break bit for bit.
    order = np.lexsort((a, b))
    b_ord, a_ord, cand = b[order], a[order], cand[:, order]
    b_uniq, start = np.unique(b_ord, return_index=True)
    gmin = np.minimum.reduceat(cand, start, axis=1)          # (N, U)
    width = np.diff(np.append(start, len(b_ord)))
    gid = np.repeat(np.arange(len(b_uniq)), width)
    pos = np.where(cand == gmin[:, gid], np.arange(len(b_ord))[None, :],
                   len(b_ord))
    first = np.minimum.reduceat(pos, start, axis=1)
    first = np.minimum(first, len(b_ord) - 1)
    best[:, b_uniq] = gmin
    pred[:, b_uniq] = a_ord[first]
    return best, pred


def extract_path(pred_row: np.ndarray, source: int, dest: int) -> list[int]:
    """Walk one predecessor row back from ``dest``; returns the hop list
    ``[source, ..., dest]`` or ``[]`` when ``dest`` is unreachable."""
    if dest == source:
        return [source]
    path = [dest]
    cur = dest
    for _ in range(len(pred_row)):
        cur = int(pred_row[cur])
        if cur < 0:
            return []
        path.append(cur)
        if cur == source:
            return path[::-1]
    return []


def extract_paths(pred: np.ndarray, sources: Sequence[int],
                  dests: Optional[Sequence[int]] = None) -> np.ndarray:
    """Vectorized :func:`extract_path` over whole predecessor tables.

    ``pred``: ``(N, S)`` spliced predecessor rows; ``sources``: ``(N,)``
    the row sources; ``dests``: destination ids applied to every row
    (default: all S satellites). Returns an ``(N, D, H)`` int hop table,
    left-aligned and -1 padded (H = longest recovered path):
    ``out[n, d, :len] == [source, ..., dest]``, an all ``-1`` row where
    ``dest`` is unreachable (the batched encoding of ``[]``), and the
    single hop ``[source]`` where ``dest == source`` — one backward
    walk of every (row, dest) pair at once instead of one Python loop
    per pair (the stitched splice and buffered exit pricing replay
    hundreds of them).
    """
    pred = np.asarray(pred, dtype=np.int64)
    N, S = pred.shape
    src = np.atleast_1d(np.asarray(sources, dtype=np.int64))
    d = np.arange(S, dtype=np.int64) if dests is None \
        else np.atleast_1d(np.asarray(dests, dtype=np.int64))
    D = len(d)
    rows = np.broadcast_to(np.arange(N)[:, None], (N, D))
    cols = np.broadcast_to(np.arange(D)[None, :], (N, D))
    dest = np.broadcast_to(d[None, :], (N, D))
    src_g = np.broadcast_to(src[:, None], (N, D))

    # Pass 1: hop counts (and reachability) of every (row, dest) walk.
    cur = dest.copy()
    hops = np.zeros((N, D), dtype=np.int64)
    done = cur == src_g
    dead = np.zeros((N, D), dtype=bool)
    for _ in range(S):
        walk = ~done & ~dead
        if not walk.any():
            break
        p = pred[rows, np.where(walk, cur, 0)]
        dead |= walk & (p < 0)
        step = walk & (p >= 0)
        cur = np.where(step, p, cur)
        hops += step
        done |= step & (cur == src_g)
    dead |= ~done                       # cycle safeguard: treat as missing
    lens = np.where(dead, 0, hops + 1)
    H = max(1, int(lens.max()))
    out = np.full((N, D, H), -1, dtype=np.int64)

    # Pass 2: walk again, scattering hop k (from the dest end) into its
    # forward-order slot lens-1-k.
    cur = dest.copy()
    for k in range(H):
        write = ~dead & (k < lens)
        if not write.any():
            break
        idx = np.clip(lens - 1 - k, 0, H - 1)
        out[rows[write], cols[write], idx[write]] = cur[write]
        p = pred[rows, np.where(write, cur, 0)]
        cur = np.where(write & (p >= 0), p, cur)
    return out


def earliest_arrival_reference(graph: AnyContactGraph, source: int,
                               t0: float) -> np.ndarray:
    """Per-edge Python label-correcting reference (equivalence baseline
    for :func:`earliest_arrival`); returns ``(S,)`` arrival times."""
    S, T = graph.n_sats, graph.n_steps
    arr = np.full(S, np.inf)
    arr[source] = float(t0)
    changed = True
    while changed:
        changed = False
        for a in range(S):
            ia = int(graph.time_index(arr[a]))
            if ia >= T:
                continue
            for b in range(S):
                j = int(graph.edge_next[a, b, ia])
                if j >= T:
                    continue
                cand = float(graph.grid_t[j]) \
                    + float(graph.edge_delay(a, b, j))
                if cand < arr[b] - _EPS_S:
                    arr[b] = cand
                    changed = True
    return arr


class WindowedRouter:
    """Stitched routing over a chain of half-overlapping grid windows.

    When the whole-horizon ``(S, S, T)`` contact structures blow the
    byte budget, the engine compiles *windows* of ``window_steps`` grid
    indices starting every ``window_steps // 2`` (the final start is
    clamped to the grid end, so most departure indices get at least
    half a window of lookahead and the chain always covers the grid
    contiguously). A query is answered
    by relaxing window after window, warm-starting each from the
    previous frontier (:func:`earliest_arrival` with ``init``): an
    arrival labelled near a window's end simply waits, and departs at
    its edge's first contact inside the next window — exactly the routes
    the old single-window lookup dropped as unreachable.

    The chain stops as soon as every arrival is finite and earlier than
    the next window's start time: any candidate a later window could
    generate departs at or after that start, so no label can improve.
    Callers whose *objective* depends on fewer labels may pass ``stop``
    (see :meth:`earliest_arrival`) to cut the chain sooner — e.g. exit
    pricing stops once the best station upload beats the next window,
    and block-diagonal elections stop once the member columns settle
    (cross-plane labels stay inf forever there, so the default
    all-finite rule alone would walk every window). Arrival values are
    computed by the same float ops on the same position slices as the
    full-horizon oracle, so stitched results match
    :func:`build_contact_graph` over the whole grid allclose
    (bit-equal in practice).

    ``build_window``: ``i0 -> ContactGraph`` over grid indices
    ``[i0, i0 + window_steps)`` — the engine backs it with its contact
    LRU (``SimConfig.contact_graph_cache``), advancing each window
    incrementally from its cached half-overlapping predecessor
    (``build_contact_graph(reuse=...)``), so windows are built lazily,
    evicted under memory pressure, and only pay fresh geometry for the
    steps that actually changed.
    """

    def __init__(self, grid_t: np.ndarray, n_sats: int, window_steps: int,
                 build_window: Callable[[int], AnyContactGraph]):
        self.grid_t = np.asarray(grid_t, dtype=np.float64)
        self._n_sats = int(n_sats)
        self.window_steps = int(window_steps)
        self.half = max(1, self.window_steps // 2)
        self._build = build_window

    @property
    def n_sats(self) -> int:
        return self._n_sats

    @property
    def n_steps(self) -> int:
        return len(self.grid_t)

    @property
    def step_s(self) -> float:
        return float(self.grid_t[1] - self.grid_t[0]) if self.n_steps > 1 \
            else 1.0

    def _tidx(self, t_s: float) -> int:
        rel = (float(t_s) - float(self.grid_t[0])) / self.step_s
        return int(np.clip(int(rel), 0, self.n_steps - 1))

    def window_starts(self, t_s: float) -> list[int]:
        """Window start indices covering ``t_s`` through the grid end:
        multiples of ``half`` from the window containing ``t_s``, with
        the last start clamped so the final window reaches the end. A
        penultimate start whose window the clamped final one would
        subsume (``start >= last - half``) is skipped — the two
        neighbors already cover every grid index, so emitting it would
        compile one redundant window per chain traversal."""
        T, W, half = self.n_steps, self.window_steps, self.half
        last = max(0, T - W)
        i0 = min((self._tidx(t_s) // half) * half, last)
        starts = []
        while True:
            starts.append(i0)
            if i0 >= last:
                return starts
            nxt = i0 + half
            i0 = nxt if nxt + half < last else last

    def window(self, i0: int) -> AnyContactGraph:
        """The compiled window starting at grid index ``i0``."""
        return self._build(int(i0))

    def window_covering(self, t_s: float) -> AnyContactGraph:
        """The single window the pre-stitching lookup would have used
        for a query at ``t_s`` (kept for diagnostics and the boundary
        regression tests)."""
        return self.window(self.window_starts(t_s)[0])

    def subgraph(self, sat_ids: Sequence[int]) -> "WindowedRouter":
        ids = np.asarray(sat_ids, dtype=np.int64)
        return WindowedRouter(
            self.grid_t, len(ids), self.window_steps,
            lambda i0: subgraph(self._build(i0), ids))

    def earliest_arrival(
            self, sources: Sequence[int], t0,
            max_hops: Optional[int] = None,
            stop: Optional[Callable[[np.ndarray, float], bool]] = None,
            cap: Optional[Callable[[np.ndarray], np.ndarray]] = None,
    ) -> np.ndarray:
        """Stitched ``(N, S)`` earliest arrivals (see class docstring).

        ``t0`` may be per-source (``(N,)``): the chain starts at the
        window covering the earliest source; later sources simply have
        no departures until their own window (their labels sit past the
        early windows' ends), so mixed-time batches stay exact.

        ``stop(arr, t_next) -> bool`` cuts the chain early when the
        *caller's* labels of interest are settled: returning True
        asserts that no arrival at or after ``t_next`` (the next
        window's start time — the earliest any later candidate can
        land) could change the caller's result. The default all-finite
        rule still applies either way. ``cap`` is forwarded to every
        window's relaxation (see :func:`earliest_arrival`): labels at
        or past their row's cap stop expanding, so arrivals beyond the
        cap may stay pessimistic — exact only for results that depend
        on sub-cap labels alone.
        """
        src = np.atleast_1d(np.asarray(sources, dtype=np.int64))
        t0v = np.broadcast_to(
            np.asarray(t0, dtype=np.float64), src.shape)
        arr = np.full((len(src), self.n_sats), np.inf)
        arr[np.arange(len(src)), src] = t0v
        t_min = float(t0v.min())
        starts = self.window_starts(t_min)
        for k, i0 in enumerate(starts):
            arr = earliest_arrival(self.window(i0), src, t_min,
                                   max_hops=max_hops, init=arr, cap=cap)
            if k + 1 < len(starts):
                t_next = float(self.grid_t[starts[k + 1]])
                if (np.isfinite(arr).all()
                        and float(arr.max()) <= t_next) \
                        or (stop is not None and stop(arr, t_next)):
                    break  # later windows' candidates all depart too late
        return arr

    def predecessors(self, sources: Sequence[int],
                     arr: np.ndarray) -> np.ndarray:
        """Splice per-window predecessor tables of a stitched arrival
        result into one global ``(N, S)`` table: each label keeps the
        predecessor from the first window whose contacts settle it
        (earlier windows' contacts are what the label actually rode).
        ``extract_path`` / ``extract_paths`` walk the spliced table
        unchanged."""
        src = np.atleast_1d(np.asarray(sources, dtype=np.int64))
        arr = np.asarray(arr, dtype=np.float64)
        t0 = float(arr[np.arange(len(src)), src].min())
        finite = arr[np.isfinite(arr)]
        t_hi = float(finite.max()) if finite.size else t0
        pred = np.full(arr.shape, -1, dtype=np.int64)
        for i0 in self.window_starts(t0):
            if float(self.grid_t[i0]) > t_hi:
                break      # this window's candidates all arrive past arr
            pred = predecessors(self.window(i0), src, arr, carry=pred)
            if (pred >= 0).sum() == np.isfinite(arr).sum() - len(src):
                break      # every reachable non-source label settled
        return pred


@dataclasses.dataclass(frozen=True)
class SinkElection:
    """Per-orbit sink election result (all arrays over L orbits).

    ``sinks``: elected satellite ids; ``sink_slots``: their in-ring
    slots; ``scores``: the winning aggregate-reachability scores (inf
    when no candidate of the orbit can exit before the horizon);
    ``lam``: ``(L, K)`` Eq.-14 chain weights of each orbit's members for
    the elected sink's chain; ``delivery``: when the last member's
    contribution reaches the elected sink; ``all_scores``: ``(L, K)``
    scores of every candidate (diagnostics/benchmarks).
    """
    sinks: np.ndarray
    sink_slots: np.ndarray
    scores: np.ndarray
    lam: np.ndarray
    delivery: np.ndarray
    all_scores: np.ndarray


def onehot_chain_weights(sizes: np.ndarray,
                         partial_mode: str = "paper") -> np.ndarray:
    """Eq.-14 chain weights of every sink candidacy: ``lam[..., c, m]``
    is member ``m``'s weight in the ring where only candidate ``c`` is
    visible (the intra-plane propagation chain delivering to ``c``).
    Time-independent — engines precompute this once per orbit.
    """
    sizes = np.asarray(sizes, dtype=np.float64)
    K = sizes.shape[-1]
    shape = sizes.shape[:-1] + (K, K)
    onehot = np.broadcast_to(np.eye(K, dtype=bool), shape)
    lam, _ = chain_stats(onehot,
                         np.broadcast_to(sizes[..., None, :], shape),
                         partial_mode)
    return lam


ExitCost = Union[np.ndarray, Callable[[np.ndarray, np.ndarray], np.ndarray]]


def elect_sinks(
    graph: "AnyContactGraph | WindowedRouter",
    members: np.ndarray,
    sizes: np.ndarray,
    t0,
    exit_cost_s: ExitCost,
    partial_mode: str = "paper",
    lam: Optional[np.ndarray] = None,
) -> SinkElection:
    """Elect one sink satellite per orbit by aggregate reachability delay.

    ``members``: ``(L, K)`` satellite ids in ring-slot order; ``sizes``:
    ``(L, K)`` data masses; ``t0``: when each orbit's members hold their
    models — a scalar, or an ``(L,)`` vector scoring a *batch* of cycle
    events (each orbit ready at its own time) in one shared relaxation;
    ``exit_cost_s``: the cost of getting the folded model off each
    candidate (wait for station contact + SHL transfer; inf when the
    candidate has none left) — either a ``(L, K)`` array, or a callable
    ``(members, delivery) -> (L, K)`` receiving each candidate's *own*
    delivery time (when the last member's contribution reaches it), so
    exits are priced at the moment the model is actually ready, not at
    election time (a contact window can close while the chain is still
    folding).

    Candidate ``c``'s score is the Eq.-style weighted mean of its
    members' routed arrival delays — weights are the closed-form Eq.-14
    chain weights of the ring with only ``c`` visible
    (:func:`onehot_chain_weights`, precomputable via ``lam``), i.e.
    exactly the weights the intra-plane propagation chain gives each
    member's model — plus the candidate's exit cost. The argmin
    candidate per orbit wins; **equal scores resolve to the lowest ring
    slot** (``np.argmin`` returns the first minimum), so elections —
    including fault-induced re-elections, where a downed sink's exit
    prices inf and several survivors may tie — are deterministic and
    reproducible across backends and batch shapes
    (``RoundEngine.elect_sinks_batch`` scores through this same argmin).

    On a :class:`WindowedRouter`, the chain is cut as soon as every
    *member-column* label is settled (a ``stop`` hook): the scores only
    read arrivals at the orbits' own members, so on block-diagonal
    (e.g. intra-plane) graphs — where cross-plane labels stay inf
    forever and the default all-finite rule would walk every window —
    the chain still stops after the windows that matter.
    """
    members = np.asarray(members, dtype=np.int64)
    sizes = np.asarray(sizes, dtype=np.float64)
    L, K = members.shape
    t0v = np.asarray(t0, dtype=np.float64)
    t0_rows = np.repeat(t0v, K) if t0v.ndim == 1 else t0v
    if isinstance(graph, WindowedRouter):
        rows = np.arange(L * K)[:, None]
        cols = np.repeat(members, K, axis=0)               # (L*K, K)

        def members_settled(a: np.ndarray, t_next: float) -> bool:
            rel = a[rows, cols]
            return bool(np.isfinite(rel).all()
                        and float(rel.max()) <= t_next)

        arr = graph.earliest_arrival(members.reshape(-1), t0_rows,
                                     stop=members_settled)
    else:
        arr = earliest_arrival(graph, members.reshape(-1), t0_rows)
    arr = arr.reshape(L, K, graph.n_sats)
    # arrd[l, c, m]: member m's arrival time at candidate c's satellite.
    arrd = arr[np.arange(L)[:, None, None],
               np.arange(K)[None, :, None],
               members[:, None, :]].transpose(0, 2, 1)
    delivery = arrd.max(axis=-1)                           # (L, c)
    if callable(exit_cost_s):
        exit_cost_s = exit_cost_s(members, delivery)
    exit_cost_s = np.asarray(exit_cost_s, dtype=np.float64)
    if lam is None:
        lam = onehot_chain_weights(sizes, partial_mode)
    delay = arrd - (t0v[:, None, None] if t0v.ndim == 1 else t0v)
    score = np.where(lam > 0, lam * delay, 0.0).sum(axis=-1) + exit_cost_s
    # Deterministic tie-break: argmin takes the FIRST minimum, i.e. the
    # lowest ring slot — documented contract, relied on for reproducible
    # fault-induced re-elections (tests/test_faults.py).
    slots = np.argmin(score, axis=1).astype(np.int64)
    l_idx = np.arange(L)
    return SinkElection(
        sinks=members[l_idx, slots],
        sink_slots=slots,
        scores=score[l_idx, slots],
        lam=lam[l_idx, slots],
        delivery=delivery[l_idx, slots],
        all_scores=score,
    )


__all__ = [
    "ContactGraph", "SparseContactGraph", "SinkElection", "WindowedRouter",
    "build_contact_graph", "earliest_arrival", "earliest_arrival_dense",
    "earliest_arrival_reference", "elect_sinks", "extract_path",
    "extract_paths", "onehot_chain_weights", "predecessors", "subgraph",
]
