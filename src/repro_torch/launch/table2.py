"""The paper's Table II on the port: accuracy and convergence time of every
FL-Satcom method of ``TABLE2_SETUPS`` on one constellation (port of the
Table II half of ``benchmarks/bench_table2.py``), on the card unless the
caller asks for the CPU.

  PYTHONPATH=src python examples/paper_reproduction_torch.py          # quick
  PYTHONPATH=src python examples/paper_reproduction_torch.py --full   # paper

Two tiers, the reference's settings kept here as data (the port imports
nothing of the JAX package):

- ``QUICK``: the MLP on 8,000 samples (1,500 held out), 40 local steps,
  12 rounds (``QUICK_ASYNC_ROUNDS``, 60, for fedsat's orbit-events and
  fedspace's flushes), a 72 h horizon at ``time_step_s=60``, non-IID;
- ``FULL``: the paper's CNN on 70,000 samples (6,000 held out), 54 local
  steps, 120 rounds, a 72 h horizon, non-IID.

Each row is one ``SatcomSimulator`` run of its setup in the tier, and
comes back as the reference's row: ``method``, ``final_acc``,
``hours_to_<target>pct``, ``rounds``, ``sim_hours``, ``wall_s`` (the
engine's build included) and ``history`` (hours, accuracy), rounded as
the reference rounds them.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Mapping, Optional, Sequence

from repro_torch.core.strategies import TABLE2_SETUPS
from repro_torch.sim import SatcomSimulator, SimConfig

QUICK = dict(model_kind="mlp", num_samples=8000, eval_samples=1500,
             local_steps=40, max_rounds=12, horizon_h=72.0,
             time_step_s=60.0, iid=False)
FULL = dict(model_kind="cnn", num_samples=70000, eval_samples=6000,
            local_steps=54, max_rounds=120, horizon_h=72.0, iid=False)
# The quick tier's max_rounds for the asynchronous baselines, which count
# orbit-events (fedsat) and flushes (fedspace) against it.
QUICK_ASYNC_ROUNDS = 60
ASYNC = ("fedsat", "fedspace")


def configs(quick: bool = True, methods: Optional[Sequence[str]] = None,
            device: str = "cuda", **overrides) -> dict[str, SimConfig]:
    """The rows' configs in the tier, on ``device``, in the paper's order
    (only ``methods`` if given); ``overrides`` replace any of their
    fields last."""
    out = {}
    for name, base in TABLE2_SETUPS.items():
        if methods and name not in methods:
            continue
        tier = dict(QUICK if quick else FULL)
        if quick and base.strategy in ASYNC:
            tier["max_rounds"] = QUICK_ASYNC_ROUNDS
        out[name] = dataclasses.replace(
            base, **{**tier, "device": device, **overrides})
    return out


def run(quick: bool = True, target: float = 0.80,
        methods: Optional[Sequence[str]] = None, device: str = "cuda",
        init_params: Optional[Mapping] = None, **overrides) -> list[dict]:
    """Run every row (or ``methods``) and return the reference's rows.

    ``init_params`` is a numpy param tree that every row starts from
    instead of the port's seeded init (the tests carry the JAX package's
    across); ``overrides`` replace fields of every row's config."""
    rows = []
    for name, cfg in configs(quick, methods, device, **overrides).items():
        t0 = time.perf_counter()
        res = SatcomSimulator(cfg).run(init_params=init_params)
        tta = res.time_to_accuracy(target)
        wall = time.perf_counter() - t0
        rows.append({
            "method": name,
            "final_acc": round(res.final_accuracy, 4),
            f"hours_to_{int(target*100)}pct":
                round(tta, 2) if tta else None,
            "rounds": res.rounds,
            "sim_hours": round(res.sim_hours, 2),
            "wall_s": round(wall, 1),
            "history": [(round(t, 2), round(a, 4))
                        for t, _, a in res.history],
        })
        units = res.history[-1][1] if res.history else 0
        print(f"  {name}: acc={rows[-1]['final_acc']} "
              f"rounds={rows[-1]['rounds']} "
              f"sim_h={rows[-1]['sim_hours']} aggregations={units} "
              f"wall_s={wall:.1f} "
              f"({wall / max(units, 1):.4f} s per aggregation)",
              flush=True)
    return rows


__all__ = ["ASYNC", "FULL", "QUICK", "QUICK_ASYNC_ROUNDS", "configs",
           "run"]
