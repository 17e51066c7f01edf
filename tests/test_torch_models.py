"""The port's paper CNN and MLP, and its replica-stacked local SGD,
against the JAX package on the same params.

Params are made by the JAX package and carried into the port with
``params_from_numpy`` (the port's own init cannot reproduce
``jax.random``). Inputs come from numpy seeds. Tolerance for f32:
``atol=1e-5, rtol=1e-4`` — both sides are full f32 and differ only in
the order of the convolution and matmul reductions.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.paper_cnn import CONFIG as CNN_CONFIG
from repro.configs.paper_mlp import CONFIG as MLP_CONFIG
from repro.models import CNN as JaxCNN, MLP as JaxMLP
from repro.sim.trainer import LocalTrainer as JaxTrainer
from repro_torch.models import CNN, MLP, params_from_numpy, params_to_numpy
from repro_torch.sim.trainer import LocalTrainer

torch.set_num_threads(2)

F32 = dict(atol=1e-5, rtol=1e-4)
MODELS = {"cnn": (JaxCNN, CNN, CNN_CONFIG), "mlp": (JaxMLP, MLP, MLP_CONFIG)}


@functools.cache
def _pair(kind, seed=0):
    """(JAX model, port model, JAX params, the same params as numpy);
    cached per module, never mutated by the tests."""
    jcls, tcls, cfg = MODELS[kind]
    jm, tm = jcls(cfg), tcls(cfg)
    jp = jm.init(jax.random.key(seed))
    return jm, tm, jp, {k: np.asarray(v) for k, v in jp.items()}


def _batch(n, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.random((n, 28, 28), dtype=np.float32),
            rng.integers(0, 10, n).astype(np.int32))


@pytest.mark.parametrize("kind", ["cnn", "mlp"])
def test_defs_match_reference(kind):
    jcls, tcls, cfg = MODELS[kind]
    jm, tm = jcls(cfg), tcls(cfg)
    assert list(tm.defs()) == list(jm.defs())
    for k, d in tm.defs().items():
        ref = jm.defs()[k]
        assert (d.shape, d.init, d.scale) == (ref.shape, ref.init, ref.scale)
    assert tm.count_params() == jm.count_params()
    params = tm.init(torch.Generator().manual_seed(0), "cpu")
    assert {k: tuple(v.shape) for k, v in params.items()} == \
        {k: d.shape for k, d in jm.defs().items()}
    again = tm.init(torch.Generator().manual_seed(0), "cpu")
    assert all(torch.equal(params[k], again[k]) for k in params)


@pytest.mark.parametrize("kind", ["cnn", "mlp"])
def test_forward_loss_accuracy_grads_match_jax(kind):
    jm, tm, jp, pn = _pair(kind)
    x, y = _batch(24)
    tp = params_from_numpy(pn, "cpu")
    xt, yt = torch.from_numpy(x), torch.from_numpy(y).long()

    np.testing.assert_allclose(tm.forward(tp, xt).numpy(),
                               np.asarray(jm.forward(jp, x)), **F32)
    np.testing.assert_allclose(float(tm.loss(tp, xt, yt)),
                               float(jm.loss(jp, x, y)), **F32)
    assert float(tm.accuracy(tp, xt, yt)) == float(jm.accuracy(jp, x, y))

    leaves = {k: v.clone().requires_grad_() for k, v in tp.items()}
    grads = torch.autograd.grad(tm.loss(leaves, xt, yt),
                                list(leaves.values()))
    jgrads = jax.grad(jm.loss)(jp, x, y)
    for (k, _), g in zip(leaves.items(), grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(jgrads[k]), **F32,
                                   err_msg=k)


@pytest.mark.parametrize("kind", ["cnn", "mlp"])
def test_stacked_forward_is_per_replica_forward(kind):
    """Replica s of the grouped/batched forward is the single forward of
    replica s's params on its own images."""
    _, tm, _, pn = _pair(kind)
    rng = np.random.default_rng(5)
    s = 3
    stacked = {k: torch.from_numpy(
        v[None] + 0.01 * rng.standard_normal((s,) + v.shape).astype(
            np.float32)) for k, v in pn.items()}
    imgs = torch.from_numpy(rng.random((s, 6, 28, 28), dtype=np.float32))
    out = tm.forward_stacked(stacked, imgs)
    for i in range(s):
        one = tm.forward({k: v[i] for k, v in stacked.items()}, imgs[i])
        np.testing.assert_allclose(out[i].numpy(), one.numpy(), **F32)


@pytest.mark.parametrize("kind", ["cnn", "mlp"])
def test_multi_step_matches_jax_vmapped_sgd(kind):
    """S replicas after n SGD steps (one backward of the summed losses)
    against the JAX package's vmapped scan of per-replica SGD."""
    jm, tm, jp, pn = _pair(kind)
    s, steps, bs = 3, 2, 8
    rng = np.random.default_rng(7)
    x = rng.random((s, steps, bs, 28, 28), dtype=np.float32)
    y = rng.integers(0, 10, (s, steps, bs)).astype(np.int32)

    jt = JaxTrainer(jm, 0.05, bs)
    jstack = jax.tree.map(lambda v: jnp.stack([v] * s), jp)
    jnew, jloss = jax.vmap(jt.multi_step)(jstack, jnp.asarray(x),
                                          jnp.asarray(y))

    tt = LocalTrainer(tm, 0.05, bs, device="cpu")
    base = params_from_numpy(pn, "cpu")
    stacked = {k: v.unsqueeze(0).expand(s, *v.shape) for k, v in
               base.items()}
    tnew, tloss = tt.multi_step(stacked, torch.from_numpy(x),
                                torch.from_numpy(y).long())
    np.testing.assert_allclose(tloss.numpy(), np.asarray(jloss), **F32)
    got = params_to_numpy(tnew)
    for k in pn:
        np.testing.assert_allclose(got[k], np.asarray(jnew[k]), **F32,
                                   err_msg=k)


def test_params_numpy_round_trip_is_exact():
    _, _, _, pn = _pair("cnn")
    back = params_to_numpy(params_from_numpy(pn, "cpu"))
    assert list(back) == list(pn)
    for k in pn:
        assert back[k].dtype == pn[k].dtype
        np.testing.assert_array_equal(back[k], pn[k])


def test_evaluate_matches_jax_trainer():
    jm, tm, jp, pn = _pair("mlp")
    x, y = _batch(2500)
    want = JaxTrainer(jm).evaluate(jp, x, y)
    got = LocalTrainer(tm, device="cpu").evaluate(
        params_from_numpy(pn, "cpu"), x, y)
    assert got == want
