"""The port's optimizers (``repro_torch.optim``) against the JAX
package's (``repro.optim``), step by step on the same params and grads.

Params and a sequence of grads are made with numpy and handed to both;
each step's updates, moments, step count and the applied params are
compared. f32 tolerance ``rtol=2e-6, atol=1e-7``: both sides run the
same elementwise formulas in f32; AdamW's ``b ** step`` and ``sqrt``
may round differently by an ulp between XLA and PyTorch. bf16 params
(AdamW's f32 moments, updates cast to the param's dtype) are held to one
bf16 ulp.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as jax_optim
from repro_torch import optim

torch.set_num_threads(2)

F32 = dict(rtol=2e-6, atol=1e-7)
SHAPES = {"a/w": (4, 3), "b": (5,), "c/d/e": (2, 2, 3)}


def _tree(rng, dtype=np.float32, scale=1.0):
    return {k: (scale * rng.standard_normal(s)).astype(dtype)
            for k, s in SHAPES.items()}


def _jax(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _torch(tree, dtype=torch.float32):
    return {k: torch.from_numpy(np.asarray(v, np.float32)).to(dtype)
            for k, v in tree.items()}


def _close(got, want, tol=F32):
    assert set(got) == set(want)
    for k in want:
        g = got[k].float().numpy() if isinstance(got[k], torch.Tensor) \
            else np.asarray(got[k], np.float32)
        np.testing.assert_allclose(g, np.asarray(want[k], np.float32),
                                   **tol, err_msg=k)


def _run(make, make_jax, steps=5, clip=None, seed=0):
    """``steps`` updates of both optimizers on the same grads; checks
    updates, state and params after each."""
    rng = np.random.default_rng(seed)
    p0 = _tree(rng)
    p, jp = _torch(p0), _jax(p0)
    opt, jopt = make(), make_jax()
    st, jst = opt.init(p), jopt.init(jp)
    for _ in range(steps):
        g0 = _tree(rng, scale=3.0)
        g, jg = _torch(g0), _jax(g0)
        if clip is not None:
            g, gn = optim.clip_by_global_norm(g, clip)
            jg, jgn = jax_optim.clip_by_global_norm(jg, clip)
            np.testing.assert_allclose(float(gn), float(jgn), **F32)
        upd, st = opt.update(g, st, p)
        jupd, jst = jopt.update(jg, jst, jp)
        _close(upd, jupd)
        assert int(st.step) == int(jst.step)
        for mine, ref in ((st.mu, jst.mu), (st.nu, jst.nu)):
            assert (mine is None) == (ref is None)
            if mine is not None:
                _close(mine, ref)
        p, jp = optim.apply_updates(p, upd), jax_optim.apply_updates(jp, jupd)
        _close(p, jp)
    return p


@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_sgd_matches_reference(momentum):
    _run(lambda: optim.sgd(0.05, momentum=momentum),
         lambda: jax_optim.sgd(0.05, momentum=momentum))


@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
def test_adamw_matches_reference(weight_decay):
    _run(lambda: optim.adamw(0.01, weight_decay=weight_decay),
         lambda: jax_optim.adamw(0.01, weight_decay=weight_decay), steps=6)


@pytest.mark.parametrize("max_norm", [0.5, 1e6])
def test_clip_by_global_norm_matches_reference(max_norm):
    """Clipped (0.5: the grads' norm is ~30) and untouched (1e6) grads,
    through SGD with momentum."""
    _run(lambda: optim.sgd(0.05, momentum=0.9),
         lambda: jax_optim.sgd(0.05, momentum=0.9), clip=max_norm, seed=3)


def test_clip_scales_to_max_norm():
    rng = np.random.default_rng(1)
    g = _torch(_tree(rng, scale=4.0))
    clipped, gn = optim.clip_by_global_norm(g, 1.0)
    norm = torch.sqrt(sum((x.float() ** 2).sum() for x in clipped.values()))
    assert float(gn) > 1.0
    np.testing.assert_allclose(float(norm), 1.0, rtol=1e-6)


def test_adamw_bf16_params_keep_dtypes():
    """bf16 params: moments f32, updates bf16 (cast from f32), as the
    reference; updates within one bf16 ulp of the reference's."""
    rng = np.random.default_rng(2)
    p0 = _tree(rng)
    p = _torch(p0, torch.bfloat16)
    jp = {k: jnp.asarray(v, jnp.bfloat16) for k, v in p0.items()}
    opt, jopt = optim.adamw(0.01, weight_decay=0.1), jax_optim.adamw(
        0.01, weight_decay=0.1)
    st, jst = opt.init(p), jopt.init(jp)
    for _ in range(3):
        g0 = _tree(rng)
        g = _torch(g0, torch.bfloat16)
        jg = {k: jnp.asarray(v, jnp.bfloat16) for k, v in g0.items()}
        upd, st = opt.update(g, st, p)
        jupd, jst = jopt.update(jg, jst, jp)
        assert all(u.dtype == torch.bfloat16 for u in upd.values())
        assert all(m.dtype == torch.float32 for m in st.mu.values())
        assert all(v.dtype == torch.float32 for v in st.nu.values())
        _close(st.nu, jst.nu)
        _close(upd, jupd, dict(rtol=2 ** -7, atol=1e-6))
        p, jp = optim.apply_updates(p, upd), jax_optim.apply_updates(jp, jupd)


def test_sgd_converges_on_quadratic():
    p = {"x": torch.zeros(3), "y": torch.ones(2)}
    opt = optim.sgd(0.1)
    st = opt.init(p)
    for _ in range(100):
        g = {"x": 2 * (p["x"] - 3.0), "y": 2 * (p["y"] + 1.0)}
        upd, st = opt.update(g, st, p)
        p = optim.apply_updates(p, upd)
    np.testing.assert_allclose(p["x"].numpy(), 3.0, atol=1e-3)
    np.testing.assert_allclose(p["y"].numpy(), -1.0, atol=1e-3)
    assert int(st.step) == 100
