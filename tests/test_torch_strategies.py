"""The routed strategies (fedisl, fedisl_ideal, fedsink, fedhap_async,
fedhap_buffered) of the port against the JAX package's, on the CPU.

- Plans are bit-equal (``np.array_equal``): a chain of round plans of
  ``FedIsl`` / ``FedSink`` and an event stream of ``FedHapAsync`` /
  ``FedHapBuffered`` (``init_plan_state`` + ``plan_events``), on the
  strategies' scenarios, with a fault plane and with stitched routing
  windows.
- Histories of all five, fused and per-round, match the JAX package's
  from the same JAX init: equal times and event counts, accuracy within
  one eval sample; within the port, fused equals per-round.
- The cycle executor's helpers (``tree_combine_many``, ``fold_block``,
  ``cycle_fold_block``, ``tree_add`` / ``tree_scale``) match the JAX
  package's within f32 reduction order, and on CPU tensors every member
  fold of ``cycle_block`` takes the plain fold, one per valid event.

fedisl runs on 2 planes of 4; the routed strategies on 2 planes of 8,
since a plane of 4 at 2,000 km has no intra-plane line of sight
(``test_torch_routing.py``). The CNN ``cycle_block`` is in
``test_torch_cycle.py``.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.treeops import tree_add as jax_tree_add
from repro.core.treeops import tree_scale as jax_tree_scale
from repro.sim import RoundEngine as JaxEngine, SimConfig as JaxConfig
from repro.sim.executor import tree_combine_many as jax_combine_many
from repro.sim.strategies import get_strategy as jax_get_strategy
from repro_torch.core.treeops import tree_add, tree_scale
from repro_torch.kernels import fedagg as fedagg_mod
from repro_torch.kernels import ops
from repro_torch.models import params_from_numpy
from repro_torch.sim import RoundEngine, SimConfig
from repro_torch.sim import executor as executor_mod
from repro_torch.sim.executor import tree_combine_many
from repro.sim.strategies import STRATEGIES as JAX_STRATEGIES
from repro_torch.sim.strategies import (
    STRATEGIES, CycleStrategy, available_strategies, get_strategy)
from test_torch_sim import _assert_histories

torch.set_num_threads(2)

QUICK = dict(model_kind="mlp", num_samples=1500, eval_samples=300,
             local_steps=2, horizon_h=36.0, time_step_s=120.0,
             max_rounds=4)
ISL = dict(num_orbits=2, sats_per_orbit=4)
ROUTED = dict(num_orbits=2, sats_per_orbit=8)
FAULTS = "faults:sat_outage=0.02,isl_drop=0.05,upload_loss=0.3"
STITCH_BUDGET = 16 * 16 * 3 * 128       # >= 3 windows of the 1082 steps
F32 = dict(atol=1e-5, rtol=1e-4)

# The scenario pairs of the JAX package's tests/test_sim_fused.py.
SCENARIOS = [
    ("fedisl", "gs"),
    ("fedisl_ideal", "meo"),
    ("fedsink", "haps:2"),
    ("fedhap_async", "haps:2"),
    ("fedhap_buffered", "haps:2"),
]
VARIANTS = {"plain": dict(), "faults": dict(faults=FAULTS),
            "stitched": dict(isl_grid_max_bytes=STITCH_BUDGET)}


def _cfg(strategy, stations, **kw):
    shell = ISL if strategy.startswith("fedisl") else ROUTED
    return dict(QUICK, **shell, strategy=strategy, stations=stations, **kw)


def _engines(strategy, stations, variant="plain"):
    kw = _cfg(strategy, stations, **VARIANTS[variant])
    return JaxEngine(JaxConfig(**kw)), RoundEngine(SimConfig(device="cpu",
                                                            **kw))


def _eq(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, what
    np.testing.assert_array_equal(a, b, err_msg=what)


def test_registry_resolves_the_routed_strategies():
    assert STRATEGIES == JAX_STRATEGIES
    assert available_strategies() == tuple(sorted(STRATEGIES))
    for name in STRATEGIES:
        assert get_strategy(name).name == name
    assert issubclass(get_strategy("fedhap_async"), CycleStrategy)
    with pytest.raises(ValueError, match="unknown strategy"):
        get_strategy("fedavg")


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("strategy,stations", SCENARIOS[:3],
                         ids=[s for s, _ in SCENARIOS[:3]])
def test_round_plan_chain_bit_equal(strategy, stations, variant):
    ref, port = _engines(strategy, stations, variant)
    jstrat, pstrat = jax_get_strategy(strategy)(), get_strategy(strategy)()
    t, n = 0.0, 0
    for _ in range(6):
        want, got = jstrat.plan_round(ref, t), pstrat.plan_round(port, t)
        assert (got is None) == (want is None)
        if want is None:
            break
        for f in ("mu", "round_end", "t_next", "sinks"):
            if hasattr(want, f):
                _eq(getattr(got, f), getattr(want, f), f"round {n}: {f}")
        t, n = want.t_next, n + 1
    assert n >= 3


def _event_stream(eng, strat, blocks=3, K=4):
    st = strat.init_plan_state(eng, 0.0)
    out = []
    for _ in range(blocks):
        out.append(strat.plan_events(eng, st, K))
    return out, strat._encode_plan_state(st)


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("strategy", ["fedhap_async", "fedhap_buffered"])
def test_plan_events_stream_bit_equal(strategy, variant):
    ref, port = _engines(strategy, "haps:2", variant)
    want, want_st = _event_stream(ref, jax_get_strategy(strategy)())
    got, got_st = _event_stream(port, get_strategy(strategy)())
    assert got_st == want_st
    assert sum(len(b) for b in want) >= 6
    for bi, (gb, wb) in enumerate(zip(got, want)):
        assert len(gb) == len(wb)
        for ei, (g, w) in enumerate(zip(gb, wb)):
            assert set(g) == set(w)
            for f in w:
                _eq(g[f], w[f], f"block {bi} event {ei}: {f}")


@functools.cache
def _jax_run(strategy, stations, fused):
    eng = JaxEngine(JaxConfig(**_cfg(strategy, stations)))
    init = {k: np.asarray(v) for k, v in eng.trainer.init(0).items()}
    return init, eng.run(fused=fused)


def _port_run(strategy, stations, fused):
    init, _ = _jax_run(strategy, stations, True)
    eng = RoundEngine(SimConfig(device="cpu", **_cfg(strategy, stations)))
    return eng.run(fused=fused, init_params=init)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "per_round"])
@pytest.mark.parametrize("strategy,stations", SCENARIOS,
                         ids=[s for s, _ in SCENARIOS])
def test_history_matches_jax(strategy, stations, fused):
    want = _jax_run(strategy, stations, fused)[1]
    got = _port_run(strategy, stations, fused)
    assert got.rounds == QUICK["max_rounds"]
    _assert_histories(got, want, QUICK["eval_samples"])


@pytest.mark.parametrize("strategy,stations", SCENARIOS,
                         ids=[s for s, _ in SCENARIOS])
def test_fused_equals_per_round_within_port(strategy, stations):
    fus = _port_run(strategy, stations, True)
    ref = _port_run(strategy, stations, False)
    assert fus.rounds == ref.rounds and fus.sim_hours == ref.sim_hours
    for (t_f, e_f, a_f), (t_r, e_r, a_r) in zip(fus.history, ref.history):
        assert t_f == t_r and e_f == e_r
        np.testing.assert_allclose(a_f, a_r, rtol=1e-4, atol=1e-5)


def _stacked(n, seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((n, 7, 5)).astype(np.float32),
            "b": rng.standard_normal((n, 5)).astype(np.float32)}


def test_tree_add_and_scale_match_jax():
    a, b = _stacked(1, 0), _stacked(1, 1)
    want = jax_tree_add(jax_tree_scale(a, 0.3), jax_tree_scale(b, 0.7))
    got = tree_add(tree_scale(params_from_numpy(a, "cpu"), 0.3),
                   tree_scale(params_from_numpy(b, "cpu"), 0.7))
    for k in a:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   **F32)


def test_tree_combine_many_and_fold_block_match_jax():
    x = _stacked(6, 2)
    rows = np.random.default_rng(4).uniform(size=(3, 6)).astype(np.float32)
    want = jax_combine_many(x, rows)
    ex = RoundEngine(SimConfig(device="cpu", **_cfg("fedhap_buffered",
                                                    "haps:2"))).executor
    for got in (tree_combine_many(params_from_numpy(x, "cpu"), rows),
                ex.fold_block(params_from_numpy(x, "cpu"), rows)):
        for k in x:
            assert got[k].shape == (3,) + x[k].shape[1:]
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       **F32)


def _fold_events(B=2):
    """Four planned events over a 2-slot buffer: unflushed, flushed,
    invalid padding, unflushed."""
    rng = np.random.default_rng(6)
    return {"l": np.array([0, 1, 0, 1]),
            "lam": rng.uniform(size=(4, 8)).astype(np.float32),
            "rhos": np.array([[0, 0], [0.2, 0.3], [0, 0], [0, 0]],
                             np.float32),
            "keep": np.array([1.0, 0.5, 1.0, 1.0], np.float32),
            "slot": np.array([0, 1, 0, 0]),
            "flush": np.array([False, True, False, False]),
            "valid": np.array([True, True, False, True])}


def test_cycle_fold_block_matches_jax():
    from repro.sim.executor import FusedExecutor as JaxExecutor
    jeng = JaxEngine(JaxConfig(**_cfg("fedhap_buffered", "haps:2")))
    peng = RoundEngine(SimConfig(device="cpu",
                                 **_cfg("fedhap_buffered", "haps:2")))
    g0, stacked = _stacked(1, 7), _stacked(8, 8)
    g0 = {k: v[0] for k, v in g0.items()}
    buf0 = {k: np.zeros((2,) + v.shape, np.float32) for k, v in g0.items()}
    ev = _fold_events()
    jex = JaxExecutor(jeng.trainer, jeng.fd, jeng.eval_images,
                      jeng.eval_labels, use_pallas=False)
    jg, jbuf = jex.cycle_fold_block(
        {k: jnp.asarray(v) for k, v in g0.items()},
        {k: jnp.asarray(v) for k, v in buf0.items()},
        {k: jnp.asarray(v) for k, v in stacked.items()}, ev)
    pbuf0 = params_from_numpy(buf0, "cpu")
    pg, pbuf = peng.executor.cycle_fold_block(
        params_from_numpy(g0, "cpu"), pbuf0,
        params_from_numpy(stacked, "cpu"), ev)
    assert all(not x.any() for x in pbuf0.values())   # not written
    for k in g0:
        np.testing.assert_allclose(pg[k].numpy(), np.asarray(jg[k]), **F32)
        np.testing.assert_allclose(pbuf[k].numpy(), np.asarray(jbuf[k]),
                                   **F32)


def test_cycle_block_folds_cpu_leaves_on_the_plain_fold(monkeypatch):
    """On CPU tensors each valid event's member fold is one
    ``fold_stacked_tree`` call of k rows that goes to the plain fold; the
    kernel wrapper is never reached (a mocked launch counter stays 0),
    and the flush does not fold through it."""
    eng = RoundEngine(SimConfig(device="cpu",
                                **_cfg("fedhap_buffered", "haps:2",
                                       buffer_fraction=1.0)))
    folds, plain = [], []

    def counting_fold(stacked, w):
        folds.append(next(iter(stacked.values())).shape[0])
        return ops.fold_stacked_tree(stacked, w)

    def counting_plain(stacked, w):
        plain.append(1)
        return real_plain(stacked, w)

    def no_kernel(*args, **kw):
        no_kernel.launches += 1
        raise AssertionError("the kernel was reached from CPU tensors")
    no_kernel.launches = 0
    real_plain = ops.tree_combine
    monkeypatch.setattr(executor_mod, "fold_stacked_tree", counting_fold)
    monkeypatch.setattr(ops, "tree_combine", counting_plain)
    monkeypatch.setattr(fedagg_mod, "fedagg_leaves", no_kernel)
    monkeypatch.setattr(ops, "fedagg_tree", no_kernel)
    res = eng.run(fused=True)
    k = eng.cfg.sats_per_orbit
    # buffer of 2 slots on 2 orbits: every second event folds the global.
    n_events = 2 * res.rounds
    assert res.rounds == QUICK["max_rounds"]
    assert folds == [k] * n_events
    assert len(plain) == n_events and no_kernel.launches == 0
