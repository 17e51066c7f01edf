"""Strategy registry and base classes for the timeline simulator (port of
``repro.sim.strategies.base``).

A *strategy* supplies only the scheduling + weighting rules of one
FL-Satcom method; the shared round loop, the physical world, the routing
substrate, local training, and aggregation live in
:class:`repro_torch.sim.engine.RoundEngine`.

Every strategy's round (or cycle event) is split into a **pure-numpy
plan phase** (contact times, routed exits, Eq. 14-16 weights, staleness
discounts — no rng, no params) and an execute phase on tensors. Two
loops consume the split:

- ``step`` — the per-round reference path: one plan, one training burst,
  one fold, one eval per call;
- ``run_fused`` — the plan-ahead loop: batches K planned rounds (or
  cycle events) into schedule tensors and executes them through
  :meth:`repro_torch.sim.executor.FusedExecutor.run_block` (the round
  family) or :meth:`~repro_torch.sim.executor.FusedExecutor.cycle_block`
  (the cycle family), with the model resident on the device and one
  host transfer per block, returning to the host only between blocks
  for history recording and termination checks (horizon,
  ``target_accuracy``, ``max_rounds``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple, Type

import numpy as np

from repro_torch.core.weights import staleness_discount

_REGISTRY: Dict[str, Type["Strategy"]] = {}

def register_strategy(name: str) -> Callable[[type], type]:
    """Class decorator: register a Strategy under ``name``."""
    def deco(cls: type) -> type:
        if not issubclass(cls, Strategy):
            raise TypeError(f"{cls!r} is not a Strategy")
        if name in _REGISTRY and _REGISTRY[name] is not cls:
            raise ValueError(f"strategy {name!r} already registered")
        cls.name = name
        _REGISTRY[name] = cls
        return cls
    return deco


def get_strategy(name: str) -> Type["Strategy"]:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown strategy {name!r}; available: "
            f"{sorted(_REGISTRY)}") from None


def available_strategies() -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


@dataclasses.dataclass
class RunState:
    """Mutable per-run state threaded through ``Strategy.step`` calls.

    ``events`` is the strategy's round/event counter (checked against
    ``SimConfig.max_rounds``); ``scratch`` holds strategy-private state
    of the per-round path (per-orbit base models, staleness buffers).
    """
    params: Any
    t: float = 0.0
    acc: float = 0.0
    events: int = 0
    history: list = dataclasses.field(default_factory=list)
    scratch: dict = dataclasses.field(default_factory=dict)


class Strategy:
    """One FL-Satcom method's scheduling + weighting rules."""

    name: str = "?"

    def step(self, eng: Any, s: RunState) -> bool:
        """Advance one round (round family) or one event (cycle family).

        Must advance ``s.t`` and, when a global model is produced,
        update ``s.params``/``s.events`` and record accuracy via
        ``eng.eval_and_record``. Return False to terminate the run
        (e.g. no remaining contact before the horizon).
        """
        raise NotImplementedError

    def run_fused(self, eng: Any, s: RunState) -> None:
        """Drive the run through the fused execute phase; the default is
        the per-round loop (:class:`RoundStrategy` and
        :class:`CycleStrategy` override it)."""
        cfg = eng.cfg
        while (s.events < cfg.max_rounds and s.t <= eng.horizon_s
               and s.acc < cfg.target_accuracy):
            if not self.step(eng, s):
                break


class RoundStrategy(Strategy):
    """Shared machinery for the synchronous whole-constellation family: a
    round plans in pure numpy (:meth:`plan_round` — per-orbit report
    times, Eq. 14-16 weights, a total round latency; no params, no rng),
    trains every satellite, and folds with the planned ``mu``.

    The plan object must expose ``mu`` (the (n_sats,) global weights)
    and ``t_next`` (the absolute time the *next* round can start).
    ``step`` executes one plan per call; ``run_fused`` chains up to
    ``SimConfig.plan_block`` plans into schedule tensors and executes
    them as one :meth:`FusedExecutor.run_block` call.
    """

    def plan_round(self, eng: Any, t: float) -> Optional[Any]:
        """Pure-numpy schedule for the round starting at ``t`` (None
        when the run can no longer proceed before the horizon)."""
        raise NotImplementedError

    def eval_due(self, cfg: Any, events: int) -> bool:
        """Whether the round bringing the counter to ``events`` ends
        with an accuracy eval."""
        return (events - 1) % cfg.eval_every_rounds == 0

    def step(self, eng: Any, s: RunState) -> bool:
        plan = self.plan_round(eng, s.t)
        if plan is None:
            s.t = eng.horizon_s + 1.0
            return False
        stacked = eng.train_all(s.params, s.t)
        # A round that lost every upload (fault plane) has an all-zero
        # mu: fold nothing and carry params forward. Training still ran
        # so the client-plane stream stays aligned with the fused
        # loop's per-round resolves.
        if np.any(plan.mu):
            s.params = eng.combine(stacked, plan.mu)
        s.t = plan.t_next
        s.events += 1
        if self.eval_due(eng.cfg, s.events):
            eng.eval_and_record(s)
        return True

    def run_fused(self, eng: Any, s: RunState) -> None:
        cfg = eng.cfg
        ex = eng.executor
        K = max(1, cfg.plan_block)
        n_sats = eng.n_sats
        all_clients = list(range(n_sats))
        need = cfg.local_steps * eng.trainer.batch_size
        loaded = eng.ckpt_resume(s, {"params": s.params})
        if loaded is not None:
            s.params = loaded["params"]
        while (s.events < cfg.max_rounds and s.t <= eng.horizon_s
               and s.acc < cfg.target_accuracy):
            # Plan ahead: chain K rounds (plans are param-independent).
            plans, t_starts, t, terminal = [], [], s.t, False
            while (len(plans) < K and s.events + len(plans) < cfg.max_rounds
                   and t <= eng.horizon_s):
                plan = self.plan_round(eng, t)
                if plan is None:
                    terminal = True
                    break
                plans.append(plan)
                t_starts.append(t)
                t = plan.t_next
            if not plans:
                s.t = eng.horizon_s + 1.0
                return
            # Schedule tensors (padded to the fixed block size K) + the
            # host-resolved batch indices (same plane stream as `step`:
            # one resolve per planned round, at that round's start time).
            n = len(plans)
            idx = np.zeros((K, n_sats, need), dtype=np.int64)
            for i in range(n):
                idx[i] = eng.sample_indices(all_clients, t_starts[i])
            mu = np.zeros((K, n_sats), dtype=np.float32)
            do_eval = np.zeros(K, dtype=bool)
            fold_ok = np.zeros(K, dtype=bool)
            for i, plan in enumerate(plans):
                mu[i] = plan.mu
                fold_ok[i] = bool(np.any(plan.mu))
                do_eval[i] = self.eval_due(cfg, s.events + i + 1)
            # Rounds that lost every upload (all-zero mu) are invalid:
            # the executor carries params through and skips the device
            # eval; their due evals run host-side below.
            valid = (np.arange(K) < n) & fold_ok
            s.params, accs = ex.run_block(s.params, idx, mu,
                                          do_eval & fold_ok, valid)
            # Host side: history + termination between blocks only.
            for i, plan in enumerate(plans):
                s.t = plan.t_next
                s.events += 1
                if do_eval[i]:
                    if fold_ok[i]:
                        s.acc = float(accs[i])
                        s.history.append((s.t / 3600.0, s.events, s.acc))
                    else:
                        eng.eval_and_record(s)
                    if s.acc >= cfg.target_accuracy:
                        return
            eng.ckpt_tick(s, {"params": s.params})
            if terminal:
                s.t = eng.horizon_s + 1.0
                return


class CycleStrategy(Strategy):
    """Shared event machinery for the routed asynchronous FedHAP family.

    Every orbit runs independent train -> route -> upload *cycles*
    against the engine's contact-graph router: a cycle starts from the
    global model the orbit last saw, trains all members, folds them
    along the Eq.-14 intra-plane chain, routes the folded model to a
    station (how is the subclass's :meth:`schedule_cycle`), and lands at
    an absolute arrival time. All routed pricing goes through the
    engine's stitched routing API (``elect_sinks`` /
    ``station_upload_end`` / ``route_exit_end``), so cycle plans on
    mega shells — where contact graphs are windowed under
    ``SimConfig.isl_grid_max_bytes`` — are exact against the
    whole-horizon oracle, window boundaries included. ``step`` pops the
    earliest inflight arrival, materializes the training it priced (one
    replica-stacked burst), hands the orbit model to the subclass's
    :meth:`fold` (immediate async fold vs buffer-then-flush), and
    relaunches the orbit's next cycle from the new global — a pure event
    loop, no wall of ``time_step_s`` ticks.

    The whole event stream is param-independent (arrival times, chain
    weights, staleness tags), so ``run_fused`` plans K events ahead —
    per-event ``(orbit, lam, rhos, slot, flush)`` tensors from
    :meth:`plan_fold` — and executes them as one
    :meth:`FusedExecutor.cycle_block` call: per-orbit cycle bases and
    the staleness buffer stay resident on the device, with no per-event
    host tree-stacking, and each event's member fold is one ``fedagg``
    launch on the card. On a mesh-backed executor the block tensors
    named by :attr:`sat_axis_tensors` shard their member axis (axis 1)
    over the ``data`` ranks; everything else stays replicated.
    """

    # Block tensors whose axis 1 is the satellite (cycle-member) dim: the
    # axes a mesh-backed executor shards over "data". Subclasses adding
    # per-member event tensors must list them here.
    sat_axis_tensors: tuple = ("idx", "lam")

    def schedule_cycle(self, eng: Any, l: int,
                       t_s: float) -> Optional[Tuple[float, np.ndarray]]:
        """Price one cycle of orbit ``l`` starting at ``t_s``.

        Returns ``(arrival_s, lam)`` — the absolute time the orbit's
        routed model lands on a station and the ``(K,)`` Eq.-14 chain
        weights of its members — or None when the orbit can no longer
        deliver before the horizon. Pure scheduling: no training.
        """
        raise NotImplementedError

    def schedule_cycle_batch(self, eng: Any, ls, ts) -> list:
        """Price a batch of cycles — orbit ``ls[i]`` starting at
        ``ts[i]`` — returning one :meth:`schedule_cycle` result
        (``(arrival, lam)`` or None) per entry. The default loops the
        scalar hook; strategies whose pricing is pure routing (sink
        election + exit pricing) override it with one vectorized
        engine call over the block-diagonal intra-plane graph."""
        return [self.schedule_cycle(eng, int(l), float(t))
                for l, t in zip(ls, ts)]

    def fold(self, eng: Any, s: RunState, l: int, orbit_model: Any,
             base_tag: int) -> None:
        """Absorb one arrived orbit model into the global state.

        ``base_tag`` is the aggregation tag the cycle trained against
        (staleness = current tag - base_tag). Must bump ``s.events`` /
        ``scratch['tag']`` and eval when a new global is produced.
        """
        raise NotImplementedError

    # ------------------------------------------------- plan-phase hooks
    def buffer_slots(self, eng: Any) -> int:
        """Device staleness-buffer capacity (1 = immediate folds)."""
        return 1

    def plan_fold(self, eng: Any, st: dict, l: int) -> dict:
        """Pure-numpy fold decision for one arrived cycle of orbit
        ``l``: the staleness-discounted weights the execute phase will
        apply. Returns ``{rhos (B,), keep, slot, flush, folds}`` and
        advances the plan-side tag/buffer bookkeeping in ``st`` exactly
        as :meth:`fold` advances ``scratch``."""
        raise NotImplementedError

    # -------------------------------------------------- per-round path
    def _launch(self, eng: Any, s: RunState, l: int) -> None:
        sc = s.scratch
        nxt = self.schedule_cycle(eng, l, s.t)
        if nxt is None or nxt[0] > eng.horizon_s:
            sc["inflight"].pop(l, None)
            return
        sc["inflight"][l] = nxt
        sc["cycle_base"][l] = s.params
        sc["cycle_tag"][l] = sc["tag"]

    def step(self, eng: Any, s: RunState) -> bool:
        sc = s.scratch
        if "inflight" not in sc:
            sc.update(inflight={}, cycle_base={}, cycle_tag={}, tag=0)
            for l in range(eng.cfg.num_orbits):
                self._launch(eng, s, l)
        if not sc["inflight"]:
            s.t = eng.horizon_s + 1.0
            return False
        l = min(sc["inflight"], key=lambda x: sc["inflight"][x][0])
        arrival, lam = sc["inflight"].pop(l)
        k = eng.cfg.sats_per_orbit
        clients = list(range(l * k, (l + 1) * k))
        stacked = eng.trainer.stack([sc["cycle_base"][l]] * k)
        sel = eng.sample_indices(clients, float(arrival))
        stacked, _ = eng.trainer.train_selection(stacked, eng.fd, sel)
        s.t = float(arrival)
        self.fold(eng, s, l, eng.combine(stacked, lam), sc["cycle_tag"][l])
        self._launch(eng, s, l)
        return True

    # ------------------------------------------------------ fused loop
    def _plan_launch_batch(self, eng: Any, st: dict, batch) -> None:
        """Relaunch a batch of popped cycles. ``batch`` rows are
        ``(l, t, tag)`` — orbit, pop time, and the plan tag recorded
        right after that event's own fold (later batch members fold
        before earlier members' relaunches, so the launch-time tag must
        be snapshotted per event, not read at relaunch). One
        :meth:`schedule_cycle_batch` call prices the whole batch."""
        if not batch:
            return
        nxts = self.schedule_cycle_batch(
            eng, [l for l, _, _ in batch], [t for _, t, _ in batch])
        for (l, _, tag), nxt in zip(batch, nxts):
            if nxt is None or nxt[0] > eng.horizon_s:
                continue
            st["inflight"][l] = nxt
            st["base_tag"][l] = tag

    def init_plan_state(self, eng: Any, t: float) -> dict:
        """Plan-side event-loop state: inflight cycle schedule plus the
        tag/buffer bookkeeping mirrored from the reference ``scratch``.
        Launches every orbit's first cycle from ``t`` (one batched
        pricing call)."""
        st = {"inflight": {}, "base_tag": {}, "tag": 0, "fill": 0,
              "meta": []}
        self._plan_launch_batch(
            eng, st, [(l, float(t), 0) for l in range(eng.cfg.num_orbits)])
        return st

    def plan_events(self, eng: Any, st: dict, n_max: int,
                    max_folds: Optional[int] = None) -> list[dict]:
        """Plan up to ``n_max`` cycle events ahead: pop arrivals in
        order, price each fold (:meth:`plan_fold`), and relaunch the
        orbit's next cycle — the reference event loop minus the
        training. Pops run-batched: a cycle relaunched from a pop at
        time ``a`` lands at ``>= a + train_time``, so every pending
        arrival strictly below ``min(pending) + train_time`` pops
        before any relaunch of this batch can — the whole run is
        popped first and its relaunches priced in one
        :meth:`schedule_cycle_batch` call, preserving the reference
        event order (ties break on dict insertion order, identical in
        both loops). Stops early once ``max_folds`` aggregation events
        have been planned."""
        events, folds = [], 0
        while (len(events) < n_max and st["inflight"]
               and (max_folds is None or folds < max_folds)):
            bound = (min(a for a, _ in st["inflight"].values())
                     + eng.train_time())
            batch = []
            while (st["inflight"] and len(events) < n_max
                   and (max_folds is None or folds < max_folds)):
                l = min(st["inflight"], key=lambda x: st["inflight"][x][0])
                arrival, lam = st["inflight"][l]
                if batch and float(arrival) >= bound:
                    break
                st["inflight"].pop(l)
                e = self.plan_fold(eng, st, l)
                e.update(l=l, lam=np.asarray(lam, dtype=np.float64),
                         t=float(arrival), do_eval=False)
                folds += e["folds"]
                events.append(e)
                batch.append((l, float(arrival), st["tag"]))
            self._plan_launch_batch(eng, st, batch)
        return events

    # Checkpoint plan-state codec: the inflight schedule and buffer
    # bookkeeping round-trip through JSON (repr-exact for float64), in
    # dict insertion order — arrival ties break on it in plan_events.
    @staticmethod
    def _encode_plan_state(st: dict) -> dict:
        return {
            "inflight": [[int(l), float(a), [float(x) for x in lam]]
                         for l, (a, lam) in st["inflight"].items()],
            "base_tag": [[int(l), int(t)]
                         for l, t in st["base_tag"].items()],
            "tag": int(st["tag"]), "fill": int(st["fill"]),
            "meta": [[int(l), int(bt)] for l, bt in st["meta"]],
        }

    @staticmethod
    def _decode_plan_state(d: dict) -> dict:
        return {
            "inflight": {int(l): (float(a),
                                  np.asarray(lam, dtype=np.float64))
                         for l, a, lam in d["inflight"]},
            "base_tag": {int(l): int(t) for l, t in d["base_tag"]},
            "tag": int(d["tag"]), "fill": int(d["fill"]),
            "meta": [(int(l), int(bt)) for l, bt in d["meta"]],
        }

    def event_tensors(self, eng: Any, events: list[dict], K: int) -> dict:
        """The schedule tensors of planned ``events`` (their ``do_eval``
        set), padded to ``K``, with the host-sampled batch indices of
        each event's orbit members in arrival order — the same rng
        stream as ``step``; what :meth:`FusedExecutor.cycle_block`
        takes."""
        cfg = eng.cfg
        k, B = cfg.sats_per_orbit, self.buffer_slots(eng)
        need = cfg.local_steps * eng.trainer.batch_size
        tensors = {
            "l": np.zeros(K, dtype=np.int64),
            "idx": np.zeros((K, k, need), dtype=np.int64),
            "lam": np.zeros((K, k), dtype=np.float32),
            "rhos": np.zeros((K, B), dtype=np.float32),
            "keep": np.ones(K, dtype=np.float32),
            "slot": np.zeros(K, dtype=np.int64),
            "flush": np.zeros(K, dtype=bool),
            "do_eval": np.zeros(K, dtype=bool),
            "valid": np.arange(K) < len(events),
        }
        for i, e in enumerate(events):
            sl = eng.orbit_slice(e["l"])
            tensors["idx"][i] = eng.sample_indices(
                list(range(sl.start, sl.stop)), e["t"])
            for f in ("l", "lam", "rhos", "keep", "slot", "flush",
                      "do_eval"):
                tensors[f][i] = e[f]
        return tensors

    def run_fused(self, eng: Any, s: RunState) -> None:
        cfg = eng.cfg
        ex = eng.executor
        L = cfg.num_orbits
        K = max(1, cfg.plan_block)
        B = self.buffer_slots(eng)
        bases = ex.broadcast_rows(s.params, L)
        buf = ex.zero_rows(s.params, B)
        st = None
        loaded = eng.ckpt_resume(
            s, {"params": s.params, "bases": bases, "buf": buf})
        if loaded is not None:
            s.params, bases, buf = (loaded["params"], loaded["bases"],
                                    loaded["buf"])
            st = self._decode_plan_state(eng.ckpt_meta())
        if st is None:
            st = self.init_plan_state(eng, s.t)
        while (s.events < cfg.max_rounds and s.t <= eng.horizon_s
               and s.acc < cfg.target_accuracy):
            if not st["inflight"]:
                s.t = eng.horizon_s + 1.0
                return
            events = self.plan_events(eng, st, K,
                                      cfg.max_rounds - s.events)
            if not events:
                break
            folds = 0
            for e in events:
                if e["folds"]:
                    e["do_eval"] = \
                        (s.events + folds) % cfg.eval_every_rounds == 0
                    folds += 1
            tensors = self.event_tensors(eng, events, K)
            s.params, bases, buf, accs = ex.cycle_block(
                s.params, bases, buf, tensors, self.sat_axis_tensors)
            for i, e in enumerate(events):
                s.t = e["t"]
                if e["folds"]:
                    s.events += 1
                    if e["do_eval"]:
                        s.acc = float(accs[i])
                        s.history.append((s.t / 3600.0, s.events, s.acc))
                        if s.acc >= cfg.target_accuracy:
                            return
            eng.ckpt_tick(s, {"params": s.params, "bases": bases,
                              "buf": buf},
                          meta=self._encode_plan_state(st))


class AsyncFoldPlan:
    """Mixin supplying the immediate staleness-discounted fold plan
    shared by the async family: ``rho = orbit_mass/total *
    staleness_discount(tag - base_tag)``, folded the moment the routed
    model arrives (buffer of one slot, always flushed)."""

    def plan_fold(self, eng: Any, st: dict, l: int) -> dict:
        cfg = eng.cfg
        rho = float(eng.sizes[eng.orbit_slice(l)].sum() / eng.sizes.sum()
                    * staleness_discount(st["tag"] - st["base_tag"][l],
                                         cfg.staleness_power))
        st["tag"] += 1
        return dict(rhos=np.array([rho]), keep=1.0 - rho, slot=0,
                    flush=True, folds=1)


__all__ = [
    "AsyncFoldPlan", "CycleStrategy", "RoundStrategy", "RunState",
    "Strategy", "available_strategies", "get_strategy",
    "register_strategy",
]
