"""Strategy registry and base classes for the timeline simulator (port of
the round family of ``repro.sim.strategies.base``).

A *strategy* supplies only the scheduling + weighting rules of one
FL-Satcom method; the shared round loop, the physical world, local
training, and aggregation live in :class:`repro_torch.sim.engine
.RoundEngine`.

Every strategy's round is split into a **pure-numpy plan phase**
(contact times, Eq. 14-16 weights — no rng, no params) and an execute
phase on tensors. Two loops consume the split:

- ``step`` — the per-round reference path: one plan, one training burst,
  one fold, one eval per call;
- ``run_fused`` — the plan-ahead loop: batches K planned rounds into
  schedule tensors and executes them through
  :meth:`repro_torch.sim.executor.FusedExecutor.run_block` (model
  resident on the device, one host transfer per block), returning to
  the host only between blocks for history recording and termination
  checks (horizon, ``target_accuracy``, ``max_rounds``).

The cycle family (``CycleStrategy``) comes with the routed strategies
(ROADMAP Queue A item 7).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Type

import numpy as np

_REGISTRY: Dict[str, Type["Strategy"]] = {}

# Strategies of the JAX package that this port does not have yet, with
# the ROADMAP item that brings each.
NOT_PORTED = {
    "fedisl": "ROADMAP Queue A item 6",
    "fedisl_ideal": "ROADMAP Queue A item 6",
    "fedsink": "ROADMAP Queue A item 6",
    "fedhap_async": "ROADMAP Queue A item 7",
    "fedhap_buffered": "ROADMAP Queue A item 7",
    "fedsat": "ROADMAP Queue A item 8",
    "fedspace": "ROADMAP Queue A item 8",
}


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
        if name in NOT_PORTED:
            raise NotImplementedError(
                f"strategy {name!r} is not ported to PyTorch yet "
                f"({NOT_PORTED[name]})") from None
        raise ValueError(
            f"unknown strategy {name!r}; available: "
            f"{sorted(_REGISTRY)}") from None


def available_strategies() -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


@dataclasses.dataclass
class RunState:
    """Mutable per-run state threaded through ``Strategy.step`` calls.

    ``events`` is the strategy's round counter (checked against
    ``SimConfig.max_rounds``).
    """
    params: Any
    t: float = 0.0
    acc: float = 0.0
    events: int = 0
    history: list = dataclasses.field(default_factory=list)


class Strategy:
    """One FL-Satcom method's scheduling + weighting rules."""

    name: str = "?"

    def step(self, eng: Any, s: RunState) -> bool:
        """Advance one round.

        Must advance ``s.t`` and, when a global model is produced,
        update ``s.params``/``s.events`` and record accuracy via
        ``eng.eval_and_record``. Return False to terminate the run
        (e.g. no remaining contact before the horizon).
        """
        raise NotImplementedError

    def run_fused(self, eng: Any, s: RunState) -> None:
        """Drive the run through the fused execute phase; the default is
        the per-round loop (:class:`RoundStrategy` overrides it)."""
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
            if terminal:
                s.t = eng.horizon_s + 1.0
                return
