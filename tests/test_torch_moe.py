"""The port's MoE (``repro_torch.models.moe``) against the JAX package's
(``repro.models.moe``), on the reduced ``jamba-v0.1-52b`` (4 experts,
top-2, d_model 256, d_ff_expert 128).

Params are made by the JAX package for one MoE FFN and carried into the
port with ``params_from_numpy``; the expert matrices are rescaled to
their own fan-in (the reference draws a (E, d_in, d_out) stack at
std 1/sqrt(E), ROADMAP Queue C), so outputs are O(1). Inputs come from
numpy seeds.

Tolerances. f32: ``atol=1e-5`` (both sides full f32; the expert matmuls
sum in other orders; measured ~1e-6); the aux loss within 1e-7; routes
and drops equal. bf16: atol = rtol = 5e-2, the kernel tolerance of
``tests/test_kernels.py``.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import moe as jax_moe
from repro.models.params import init_params as jax_init_params
from repro_torch.configs import get_config
from repro_torch.models import moe, params_from_numpy

torch.set_num_threads(2)

ARCH = "jamba-v0.1-52b"
F32 = dict(atol=1e-5, rtol=0)
BF16 = dict(atol=5e-2, rtol=5e-2)


def _cfgs(dname="float32", capacity_factor=1.25):
    out = []
    for get in (get_config, jax_get_config):
        cfg = get(ARCH).reduced()
        out.append(dataclasses.replace(
            cfg, param_dtype=dname, act_dtype=dname,
            moe=dataclasses.replace(cfg.moe,
                                    capacity_factor=capacity_factor)))
    return out


@functools.cache
def _params(dname="float32"):
    cfg, jcfg = _cfgs(dname)
    jp = jax_init_params(jax_moe.moe_defs(jcfg), jax.random.key(4))
    e, d, f = jcfg.moe.num_experts, jcfg.d_model, jcfg.moe.d_ff_expert
    own = {"w_gate": (e / d) ** 0.5, "w_up": (e / d) ** 0.5,
           "w_down": (e / f) ** 0.5}
    jp = {k: (v * own.get(k, 1.0)).astype(dname) for k, v in jp.items()}
    return jp, params_from_numpy({k: np.asarray(v) for k, v in jp.items()},
                                 "cpu")


def _x(t, d, seed, dname="float32"):
    x = np.random.default_rng(seed).standard_normal((1, t, d)).astype(
        np.float32)
    return x, jnp.asarray(x, dname), torch.from_numpy(x).to(
        getattr(torch, dname))


def test_defs_match_jax():
    cfg, jcfg = _cfgs()
    got, want = moe.moe_defs(cfg), jax_moe.moe_defs(jcfg)
    assert list(got) == list(want)
    for k, d in got.items():
        assert (d.shape, d.init, d.scale) == \
            (want[k].shape, want[k].init, want[k].scale), k


@pytest.mark.parametrize("t", [1, 2, 7, 64, 16384])
@pytest.mark.parametrize("cf", [8.0, 1.25, 0.25])
def test_capacity_matches_jax(t, cf):
    cfg, jcfg = _cfgs(capacity_factor=cf)
    assert moe.capacity(cfg.moe, t) == jax_moe.capacity(jcfg.moe, t)
    full = get_config(ARCH).moe
    assert moe.capacity(full, 16384) == 2560    # the serve prefill's


def test_route_matches_jax():
    cfg, _ = _cfgs()
    jp, tp = _params()
    _, jx, tx = _x(64, cfg.d_model, seed=1)
    probs = jax.nn.softmax((jx[0] @ jp["router"]).astype(jnp.float32), -1)
    gates, idx = jax.lax.top_k(probs, 2)
    gates = gates / gates.sum(-1, keepdims=True)
    got_probs, got_gates, got_idx = moe.route(cfg, tp, tx[0])
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(idx))
    # a few f32 ulps of values in (0, 1): the router matmul sums in
    # another order
    for g, w in ((got_probs, probs), (got_gates, gates)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6)


@pytest.mark.parametrize("t", [16, 64])
@pytest.mark.parametrize("cf", [8.0, 1.25, 0.25])
def test_apply_moe_matches_jax(cf, t):
    cfg, jcfg = _cfgs(capacity_factor=cf)
    jp, tp = _params()
    _, jx, tx = _x(t, cfg.d_model, seed=2)
    want, waux = jax_moe.apply_moe(jcfg, jp, jx)
    got, aux = moe.apply_moe(cfg, tp, tx)
    assert got.shape == tx.shape and got.dtype == tx.dtype
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    assert abs(float(aux) - float(waux)) < 1e-7


def test_bf16_apply_moe_matches_jax():
    cfg, jcfg = _cfgs("bfloat16", capacity_factor=8.0)
    jp, tp = _params("bfloat16")
    _, jx, tx = _x(32, cfg.d_model, seed=3, dname="bfloat16")
    want, waux = jax_moe.apply_moe(jcfg, jp, jx)
    got, aux = moe.apply_moe(cfg, tp, tx)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **BF16)
    assert abs(float(aux) - float(waux)) < 1e-6


def _numpy_moe(cfg, jp, x, quirk: bool):
    """A direct MoE of the JAX package's routing: each assignment kept
    if its position in the expert's stable-sorted group is below cap,
    and gate-weighted; with ``quirk``, the kept assignment at slot cap-1
    of an overflowing expert contributes 0 (the JAX package's scatter
    overwrites it, repro/models/moe.py:100-106). Returns (y, the tokens
    that lost an assignment to the quirk)."""
    m = cfg.moe
    t = x.shape[0]
    cap = jax_moe.capacity(m, t)
    probs = jax.nn.softmax((jnp.asarray(x) @ jp["router"]), -1)
    gates, idx = jax.lax.top_k(probs, m.top_k)
    gates = np.asarray(gates / gates.sum(-1, keepdims=True))
    idx = np.asarray(idx)
    e_flat = idx.reshape(-1)
    order = np.argsort(e_flat, kind="stable")
    counts = np.bincount(e_flat, minlength=m.num_experts)
    starts = np.cumsum(counts) - counts
    y = np.zeros_like(x, dtype=np.float64)
    lost = []
    w = {k: np.asarray(v, np.float64) for k, v in jp.items()}
    for rank, a in enumerate(order):
        e, tok, j = e_flat[a], a // m.top_k, a % m.top_k
        pos = rank - starts[e]
        if pos >= cap:
            continue
        if quirk and pos == cap - 1 and counts[e] > cap:
            lost.append(tok)
            continue
        h = x[tok] @ w["w_gate"][e]
        h = h / (1 + np.exp(-h)) * (x[tok] @ w["w_up"][e])
        y[tok] += gates[tok, j] * (h @ w["w_down"][e])
    return y, lost


def test_overflow_drops_the_kept_assignment_at_the_last_slot():
    """At capacity_factor 0.25 every expert overflows (cap 8 against a
    mean load of 32). The JAX package's dispatch then zeroes the kept
    assignment at slot cap-1 of each overflowing expert, so that token
    gets nothing from it; the port reproduces this deterministically
    (ROADMAP Queue C). Both equal the direct MoE with the quirk, and both
    differ from it without the quirk exactly at those tokens."""
    cfg, jcfg = _cfgs(capacity_factor=0.25)
    jp, tp = _params()
    x, jx, tx = _x(64, cfg.d_model, seed=5)
    want, _ = jax_moe.apply_moe(jcfg, jp, jx)
    got, _ = moe.apply_moe(cfg, tp, tx)
    with_quirk, lost = _numpy_moe(jcfg, jp, x[0], quirk=True)
    without, _ = _numpy_moe(jcfg, jp, x[0], quirk=False)
    assert len(lost) == jcfg.moe.num_experts          # one per expert
    for y in (np.asarray(want)[0], got.numpy()[0]):
        np.testing.assert_allclose(y, with_quirk, atol=1e-5)
        off = np.abs(y - without).max(-1) > 1e-3
        assert sorted(np.flatnonzero(off)) == sorted(set(lost))


def test_dispatch_is_deterministic():
    cfg, _ = _cfgs(capacity_factor=0.25)
    _, tp = _params()
    _, _, tx = _x(64, cfg.d_model, seed=6)
    a, _ = moe.apply_moe(cfg, tp, tx)
    b, _ = moe.apply_moe(cfg, tp, tx)
    assert torch.equal(a, b)


def test_local_dispatch_raises_naming_its_roadmap_item():
    cfg, _ = _cfgs()
    _, tp = _params()
    cfg = dataclasses.replace(cfg, moe_dispatch_local=True)
    with pytest.raises(NotImplementedError, match="Queue A item 19"):
        moe.apply_moe(cfg, tp, torch.ones(1, 16, cfg.d_model))
