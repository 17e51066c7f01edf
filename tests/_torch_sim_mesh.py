"""Rank side of the sharded-simulator tests
(``tests/test_torch_sim_sharded.py``), the port's counterpart of
``tests/helpers/check_sim_sharded.py``: every rank runs the same
engines with ``data_shards`` equal to the world size, and rank 0 then
runs the unsharded programs on the same inputs (the reference results),
in the same process, so both sides share its thread settings. No jax.
"""
from __future__ import annotations

import numpy as np

QUICK = dict(model_kind="mlp", num_samples=1500, eval_samples=300,
             local_steps=2, horizon_h=36.0, time_step_s=120.0,
             max_rounds=4, device="cpu")

SCENARIOS = [
    ("fedhap", "one_hap"),
    ("fedisl", "gs"),
    ("fedisl_ideal", "meo"),
    ("fedsat", "gs_np"),
    ("fedspace", "gs"),
    ("fedsink", "haps:2"),
    ("fedhap_async", "haps:2"),
    ("fedhap_buffered", "haps:2"),
]
QUICK_SET = ("fedhap", "fedhap_async")


def round_inputs(eng, K: int, S: int, seed: int):
    rng = np.random.default_rng(seed)
    need = eng.cfg.local_steps * eng.trainer.batch_size
    idx = rng.integers(0, len(eng.fd.images), (K, S, need))
    mu = rng.random((K, S)).astype(np.float32)
    mu /= mu.sum(axis=1, keepdims=True)
    return idx, mu, np.ones(K, dtype=bool), np.ones(K, dtype=bool)


def cycle_inputs(eng, k: int) -> dict:
    rng = np.random.default_rng(7)
    K, B, L = 4, 2, 3
    need = eng.cfg.local_steps * eng.trainer.batch_size
    lam = rng.random((K, k)).astype(np.float32)
    return {
        "l": rng.integers(0, L, K),
        "idx": rng.integers(0, len(eng.fd.images), (K, k, need)),
        "lam": lam / lam.sum(axis=1, keepdims=True),
        "rhos": 0.5 * rng.random((K, B)).astype(np.float32),
        "keep": 0.5 + 0.5 * rng.random(K).astype(np.float32),
        "slot": rng.integers(0, B, K),
        "flush": np.array([True, False, True, True]),
        "do_eval": np.ones(K, dtype=bool),
        "valid": np.array([True, True, True, False]),
    }


def _np(tree: dict) -> dict:
    return {k: v.numpy() for k, v in tree.items()}


def blocks(eng, ex) -> dict:
    """``run_block`` at S = every satellite and at S = 5 (padded when the
    rank count does not divide it), ``cycle_block`` at k = 5 and k = 8
    members, all from ``trainer.init(0)``."""
    out = {}
    for S in (eng.n_sats, 5):
        idx, mu, do_eval, valid = round_inputs(eng, 3, S, seed=42)
        p, accs = ex.run_block(eng.trainer.init(0), idx, mu, do_eval,
                               valid)
        out[f"run_block/S{S}"] = (_np(p), accs)
    for k in (5, 8):
        ev = cycle_inputs(eng, k)
        p = eng.trainer.init(0)
        bases = ex.broadcast_rows(p, 3)
        buf = ex.zero_rows(p, 2)
        g, bases, buf, accs = ex.cycle_block(p, bases, buf, dict(ev))
        out[f"cycle_block/k{k}"] = (_np(g), _np(bases), _np(buf), accs)
    return out


def histories(scenarios, **kw) -> dict:
    from repro_torch.sim import RoundEngine, SimConfig
    return {s: RoundEngine(SimConfig(strategy=s, stations=st, **QUICK,
                                     **kw)).run().history
            for s, st in SCENARIOS if s in scenarios}


def sim_ranks(rank: int, world: int, scenarios=QUICK_SET) -> dict:
    """Histories of ``scenarios`` and the blocks with ``data_shards =
    world``; rank 0 adds the unsharded ones under ``"ref"``."""
    from repro_torch.sim import RoundEngine, SimConfig
    from repro_torch.sim.executor import FusedExecutor
    out = {"hist": histories(scenarios, data_shards=world)}
    eng = RoundEngine(SimConfig(data_shards=world, **QUICK))
    out["blocks"] = blocks(eng, eng.executor)
    if rank == 0:
        ex1 = FusedExecutor(eng.trainer, eng.fd, eng.eval_images,
                            eng.eval_labels)
        out["ref"] = {"hist": histories(scenarios),
                      "blocks": blocks(eng, ex1)}
    return out


def sim_ranks_all(rank: int, world: int) -> dict:
    """:func:`sim_ranks` over all 8 strategies."""
    return sim_ranks(rank, world, tuple(s for s, _ in SCENARIOS))
