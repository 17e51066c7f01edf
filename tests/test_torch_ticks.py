"""The tick baselines (fedsat, fedspace) of the port against the JAX
package's, on the CPU.

- fedsat's tick plans (``_plan_tick``: visited orbits, gateway advance)
  are bit-equal over the whole horizon, with and without lost uploads.
- Histories fused and per round match the JAX package's from the same
  JAX init: equal times and event counts, accuracy within one eval
  sample; within the port, fused equals per round.
- The tick executors on the paper CNN (``fedsat_event``,
  ``fedspace_train`` + ``fedspace_flush``) match the reference's padded
  programs within f32 reduction-order tolerance, at visited-orbit and
  pass counts that are not powers of two (the reference pads them; the
  port does not).
- On CPU tensors every orbit fold and every flush is one
  ``fold_stacked_tree`` call on the plain fold; on the card (``cuda``
  marker) each is one ``fedagg`` launch.

The scenarios and the fault spec are those of ``tests/test_faults.py``.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.sim import RoundEngine as JaxEngine, SimConfig as JaxConfig
from repro.sim.strategies import FedSat as JaxFedSat
from repro_torch.kernels import fedagg as fedagg_mod
from repro_torch.kernels import ops
from repro_torch.models import params_from_numpy, params_to_numpy
from repro_torch.sim import RoundEngine, SimConfig
from repro_torch.sim import executor as executor_mod
from repro_torch.sim.strategies import FedSat, FedSpace
from test_torch_sim import _assert_histories

torch.set_num_threads(2)

QUICK = dict(model_kind="mlp", num_samples=1500, eval_samples=300,
             local_steps=2, horizon_h=36.0, time_step_s=120.0,
             max_rounds=4)
FAULTS = ("sat_outage=0.05,isl_drop=0.1,upload_loss=0.15,"
          "hap_outage=0.05,mtbf_h=2,mttr_h=1")
SCENARIOS = [("fedsat", "gs_np"), ("fedspace", "gs")]
# On the 5x8 shell fedsat's first gs_np tick visits all five orbits and
# ends the run (five events); the 2x4 shell spreads it over ticks.
VARIANTS = {"plain": dict(), "faults": dict(faults=FAULTS),
            "shell_2x4": dict(num_orbits=2, sats_per_orbit=4)}
# The slice test's CNN (batch 8, two local steps) for the executors.
CNN = dict(model_kind="cnn", num_samples=1500, eval_samples=300,
           local_steps=2, batch_size=8, horizon_h=36.0, time_step_s=120.0)
F32 = dict(atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("faults", ["", "upload_loss=0.3"],
                         ids=["plain", "upload_loss"])
def test_plan_tick_bit_equal(faults):
    kw = dict(QUICK, strategy="fedsat", stations="gs_np", faults=faults)
    ref = JaxEngine(JaxConfig(**kw))
    port = RoundEngine(SimConfig(device="cpu", **kw))
    jstrat, pstrat = JaxFedSat(), FedSat()
    n_plans = 0
    for t in ref.grid_t[ref.grid_t <= ref.horizon_s]:
        want, got = jstrat._plan_tick(ref, float(t)), \
            pstrat._plan_tick(port, float(t))
        assert got == want, f"t={t}"
        if want is not None:
            assert type(got[1]) is type(want[1])
            n_plans += 1
    assert n_plans > 10


@functools.cache
def _jax_run(strategy, stations, variant, fused):
    eng = JaxEngine(JaxConfig(strategy=strategy, stations=stations,
                              **VARIANTS[variant], **QUICK))
    init = {k: np.asarray(v) for k, v in eng.trainer.init(0).items()}
    return init, eng.run(fused=fused)


def _port_run(strategy, stations, variant, fused):
    init, _ = _jax_run(strategy, stations, variant, True)
    eng = RoundEngine(SimConfig(strategy=strategy, stations=stations,
                                device="cpu", **VARIANTS[variant], **QUICK))
    return eng.run(fused=fused, init_params=init)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "per_round"])
@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("strategy,stations", SCENARIOS,
                         ids=[s for s, _ in SCENARIOS])
def test_history_matches_jax(strategy, stations, variant, fused):
    want = _jax_run(strategy, stations, variant, fused)[1]
    got = _port_run(strategy, stations, variant, fused)
    assert got.rounds >= 1
    _assert_histories(got, want, QUICK["eval_samples"])


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("strategy,stations", SCENARIOS,
                         ids=[s for s, _ in SCENARIOS])
def test_fused_equals_per_round_within_port(strategy, stations, variant):
    fus = _port_run(strategy, stations, variant, True)
    ref = _port_run(strategy, stations, variant, False)
    assert fus.rounds == ref.rounds and fus.sim_hours == ref.sim_hours
    for (t_f, e_f, a_f), (t_r, e_r, a_r) in zip(fus.history, ref.history):
        assert t_f == t_r and e_f == e_r
        np.testing.assert_allclose(a_f, a_r, rtol=1e-4, atol=1e-5)


def _cnn_engines(L, k):
    kw = dict(CNN, num_orbits=L, sats_per_orbit=k)
    jeng = JaxEngine(JaxConfig(**kw))
    peng = RoundEngine(SimConfig(device="cpu", **kw))
    init = {n: np.asarray(v) for n, v in jeng.trainer.init(0).items()}
    return jeng, peng, init


def _distinct_rows(init, n, seed):
    """``n`` stacked rows of ``init``, each perturbed differently."""
    rng = np.random.default_rng(seed)
    return {k: (v[None] + 0.01 * rng.standard_normal((n,) + v.shape))
            .astype(np.float32) for k, v in init.items()}


def _check(got, want, what):
    got = params_to_numpy(got)
    for k in got:
        np.testing.assert_allclose(got[k], np.asarray(want[k]), **F32,
                                   err_msg=f"{what} {k}")


@pytest.mark.parametrize("L,visited", [(2, [1, 0]), (3, [2, 0, 1])],
                         ids=["V2", "V3_padded_to_4"])
def test_fedsat_event_matches_jax(L, visited):
    k = 4
    jeng, peng, init = _cnn_engines(L, k)
    bases = _distinct_rows(init, L, 1)
    clients = [c for l in visited for c in range(l * k, (l + 1) * k)]
    idx = peng.sample_indices(clients, 0.0)
    sizes = peng.sizes.reshape(L, k)[visited]
    lam_rows = sizes / sizes.sum(axis=1, keepdims=True)
    rhos = sizes.sum(axis=1) / peng.sizes.sum()
    jg, jbases = jeng.executor.fedsat_event(
        {n: jnp.asarray(v) for n, v in init.items()},
        {n: jnp.asarray(v) for n, v in bases.items()},
        np.asarray(visited), idx, lam_rows, rhos)
    pbases = params_from_numpy(bases, "cpu")
    pg, pbases2 = peng.executor.fedsat_event(
        params_from_numpy(init, "cpu"), pbases, np.asarray(visited), idx,
        lam_rows, rhos)
    assert pbases2 is pbases                     # written in place
    _check(pg, jg, "params")
    _check(pbases2, jbases, "bases")


def test_fedspace_train_and_flush_match_jax():
    """Two pass bursts (3 and 2 satellites: the reference pads them to 4
    and 2) on 2 orbits of 4, then one flush of the 5 buffered deltas (the
    reference pads to 8 zero-weight rows)."""
    jeng, peng, init = _cnn_engines(2, 4)
    bases = _distinct_rows(init, peng.n_sats, 2)
    jp = {n: jnp.asarray(v) for n, v in init.items()}
    jb = {n: jnp.asarray(v) for n, v in bases.items()}
    pp = params_from_numpy(init, "cpu")
    pb = params_from_numpy(bases, "cpu")
    jdeltas, pdeltas = [], []
    for t, sats in ((0.0, np.array([0, 3, 5])), (120.0, np.array([1, 6]))):
        idx = peng.sample_indices(sats.tolist(), t)
        jd, jb = jeng.executor.fedspace_train(jp, jb, sats, idx)
        pd, pb2 = peng.executor.fedspace_train(pp, pb, sats, idx)
        assert pb2 is pb
        assert next(iter(pd.values())).shape[0] == len(sats)
        _check(pd, {n: np.asarray(v)[:len(sats)] for n, v in jd.items()},
               "deltas")
        jdeltas.append(jd)
        pdeltas.append(pd)
    _check(pb, jb, "bases")
    wts = np.random.default_rng(3).uniform(0.05, 0.3, size=5)
    jstack = {n: jnp.concatenate([jd[n][:m] for jd, m in
                                  zip(jdeltas, (3, 2))])
              for n in init}
    jg = jeng.executor.fedspace_flush(jp, jstack, wts)
    pstack = {n: torch.cat([d[n] for d in pdeltas]) for n in init}
    pg = peng.executor.fedspace_flush(pp, pstack, wts)
    _check(pg, jg, "flushed params")


def test_tick_folds_cpu_leaves_on_the_plain_fold(monkeypatch):
    """On CPU tensors fedsat folds each visited orbit with one
    ``fold_stacked_tree`` call of k rows and fedspace each flush with one
    call over the buffered rows, all on the plain fold; the kernel
    wrapper is never reached."""
    folds = []

    def counting_fold(stacked, w):
        folds.append(next(iter(stacked.values())).shape[0])
        return real_fold(stacked, w)

    def no_kernel(*args, **kw):
        raise AssertionError("the kernel was reached from CPU tensors")
    real_fold = ops.fold_stacked_tree
    monkeypatch.setattr(executor_mod, "fold_stacked_tree", counting_fold)
    monkeypatch.setattr(fedagg_mod, "fedagg_leaves", no_kernel)
    monkeypatch.setattr(ops, "fedagg_tree", no_kernel)
    for strategy, stations in SCENARIOS:
        folds.clear()
        eng = RoundEngine(SimConfig(strategy=strategy, stations=stations,
                                    device="cpu", **QUICK))
        res = eng.run(fused=True)
        events = res.history[-1][1]
        if strategy == "fedsat":
            assert folds == [eng.cfg.sats_per_orbit] * events
        else:
            assert len(folds) == events == res.rounds
            assert all(n >= FedSpace()._flush_size(eng) for n in folds)


@pytest.mark.cuda
def test_tick_executors_on_card_match_cpu_one_launch_per_fold():
    """On the card fedsat_event launches ``fedagg`` once per visited orbit
    and fedspace_flush once per flush; both agree with the CPU
    executor's."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the fedagg kernel is CUDA C++ "
                    "and has no CPU or interpreter mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    kw = dict(CNN, num_orbits=3, sats_per_orbit=4)
    ceng = RoundEngine(SimConfig(device="cpu", **kw))
    geng = RoundEngine(SimConfig(device="cuda", **kw))
    init = params_to_numpy(ceng.trainer.init(0))
    visited = np.array([2, 0, 1])
    idx = ceng.sample_indices(list(range(12)), 0.0)
    sizes = ceng.sizes.reshape(3, 4)[visited]
    lam_rows = sizes / sizes.sum(axis=1, keepdims=True)
    rhos = sizes.sum(axis=1) / ceng.sizes.sum()
    sats = np.array([0, 3, 5, 7, 10])
    sidx = ceng.sample_indices(sats.tolist(), 0.0)
    wts = np.linspace(0.05, 0.25, len(sats))
    outs = []
    for eng, dev in ((ceng, "cpu"), (geng, "cuda")):
        ex = eng.executor
        p = params_from_numpy(init, dev)
        before = fedagg_mod.fedagg.launches
        g, bases = ex.fedsat_event(p, ex.broadcast_rows(p, 3), visited, idx,
                                   lam_rows, rhos)
        assert fedagg_mod.fedagg.launches - before == \
            (len(visited) if dev == "cuda" else 0)
        before = fedagg_mod.fedagg.launches
        deltas, sbases = ex.fedspace_train(g, ex.broadcast_rows(p, 12), sats,
                                           sidx)
        flushed = ex.fedspace_flush(g, deltas, wts)
        assert fedagg_mod.fedagg.launches - before == \
            (1 if dev == "cuda" else 0)
        outs.append([params_to_numpy(t) for t in
                     (g, bases, deltas, sbases, flushed)])
    for want, got in zip(*outs):
        for k in want:
            np.testing.assert_allclose(got[k], want[k], **F32, err_msg=k)
