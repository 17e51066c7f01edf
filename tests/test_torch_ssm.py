"""The port's Mamba block (``repro_torch.models.ssm``) against the JAX
package's (``repro.models.ssm``), on the reduced ``jamba-v0.1-52b``
(d_model 256, d_inner 512, 8 states, d_conv 4, dt_rank 16, chunk 32).

Params are made by the JAX package for one block (unstacked, so every
matrix is drawn at its own fan-in) and carried into the port with
``params_from_numpy``; inputs come from numpy seeds. The port's prefill
runs the recurrence through the ``selective_scan`` op (on the CPU its
plain version, a sequential loop), the JAX model its chunked associative
scan.

Tolerances. f32: ``atol=1e-4`` (both sides full f32; the scan sums in
another order and groups the products otherwise; measured ~2e-6 on
outputs of |max| ~2). bf16: atol = rtol = 5e-2, the kernel tolerance of
``tests/test_kernels.py`` (bf16 rounds at other places in the two
frameworks).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import Transformer as JaxTransformer
from repro.models import ssm as jax_ssm
from repro.models.params import init_params as jax_init_params
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.models import Transformer, params_from_numpy, ssm

torch.set_num_threads(2)

ARCH = "jamba-v0.1-52b"
F32 = dict(atol=1e-4, rtol=0)
BF16 = dict(atol=5e-2, rtol=5e-2)
DTYPES = {"float32": dict(), "bfloat16": dict(param_dtype="bfloat16",
                                               act_dtype="bfloat16")}


def _cfgs(**overrides):
    return (dataclasses.replace(get_config(ARCH).reduced(), **overrides),
            dataclasses.replace(jax_get_config(ARCH).reduced(), **overrides))


@functools.cache
def _block_params(dname):
    """One Mamba block's params, JAX-made, with a non-zero conv bias so
    every term shows."""
    _, jcfg = _cfgs(**DTYPES[dname])
    jp = jax_init_params(jax_ssm.mamba_defs(jcfg), jax.random.key(3),
                         jnp.dtype(dname))
    jp["conv_b"] = jnp.full_like(jp["conv_b"], 0.05)
    return jp, params_from_numpy({k: np.asarray(v) for k, v in jp.items()},
                                 "cpu")


def _x(b, s, d, seed):
    return np.random.default_rng(seed).standard_normal((b, s, d)).astype(
        np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)


def test_defs_match_jax():
    cfg, jcfg = _cfgs()
    got, want = ssm.mamba_defs(cfg), jax_ssm.mamba_defs(jcfg)
    assert list(got) == list(want)
    for k, d in got.items():
        assert (d.shape, d.init, d.scale) == \
            (want[k].shape, want[k].init, want[k].scale), k
    assert got["x_proj"].shape == (512, 16 + 2 * 8)


@pytest.mark.parametrize("dname", list(DTYPES))
def test_s4d_init_matches_jax(dname):
    cfg, jcfg = _cfgs()
    jp, tp = _block_params(dname)
    assert tp["a_log"].dtype == getattr(torch, dname)
    np.testing.assert_array_equal(tp["a_log"].float().numpy(),
                                  np.asarray(jp["a_log"], np.float32))
    port = Transformer(cfg).init(torch.Generator().manual_seed(0), "cpu")
    a_log = port["layers/b0/mixer/a_log"]
    assert a_log.shape == (1, 512, 8)
    np.testing.assert_allclose(a_log[0, 7].numpy(), np.log(np.arange(1, 9)),
                               rtol=1e-6)


def test_conv1d_causal_matches_jax():
    cfg, _ = _cfgs()
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 9, 16)).astype(np.float32)
    w = rng.standard_normal((4, 16)).astype(np.float32)
    b = rng.standard_normal((16,)).astype(np.float32)
    want = jax_ssm._conv1d_causal(jnp.asarray(x), jnp.asarray(w),
                                  jnp.asarray(b))
    got = ssm._conv1d_causal(*(torch.from_numpy(a) for a in (x, w, b)))
    _close(got, want, dict(atol=1e-6, rtol=0))


@pytest.mark.parametrize("s", [16, 64])
@pytest.mark.parametrize("dname", list(DTYPES))
def test_mamba_forward_matches_jax(dname, s):
    cfg, jcfg = _cfgs(**DTYPES[dname])
    jp, tp = _block_params(dname)
    x = _x(2, s, cfg.d_model, seed=5)
    want = jax_ssm.mamba_forward(jcfg, jp, jnp.asarray(x, dname))
    with torch.no_grad():
        got = ssm.mamba_forward(cfg, tp, torch.from_numpy(x).to(
            getattr(torch, dname)))
    assert got.dtype == getattr(torch, dname)
    _close(got, want, F32 if dname == "float32" else BF16)


def test_mamba_forward_runs_through_the_scan_op(monkeypatch):
    """One selective_scan_op call per block, on abar f32 and bx, c in the
    activation dtype (the model's mixed dtypes)."""
    cfg, _ = _cfgs(**DTYPES["bfloat16"])
    _, tp = _block_params("bfloat16")
    seen = []
    real = ops.selective_scan_op

    def spy(abar, bx, c, **kw):
        seen.append((abar.dtype, bx.dtype, c.dtype, tuple(abar.shape)))
        return real(abar, bx, c, **kw)
    monkeypatch.setattr(ops, "selective_scan_op", spy)
    with torch.no_grad():
        ssm.mamba_forward(cfg, tp, torch.ones(1, 8, cfg.d_model,
                                              dtype=torch.bfloat16))
    assert seen == [(torch.float32, torch.bfloat16, torch.bfloat16,
                     (1, 8, 512, 8))]


def test_port_forward_takes_any_length():
    """The JAX model's scan asserts S % chunk == 0; the port's kernel
    takes any S: at S=40 (chunk 32) its forward equals stepped decode."""
    cfg, jcfg = _cfgs()
    jp, tp = _block_params("float32")
    x = _x(1, 40, cfg.d_model, seed=6)
    with pytest.raises(AssertionError):
        jax_ssm.mamba_forward(jcfg, jp, jnp.asarray(x))
    with torch.no_grad():
        got = ssm.mamba_forward(cfg, tp, torch.from_numpy(x))
        cache = ssm.init_mamba_cache(cfg, 1, torch.float32, "cpu")
        steps = [ssm.mamba_decode(cfg, tp, torch.from_numpy(x[:, t:t + 1]),
                                  cache)[0] for t in range(40)]
    _close(got, torch.cat(steps, dim=1).numpy(), F32)


def test_mamba_decode_matches_jax():
    """``mamba_decode`` stepped over 8 tokens from a non-zero cache:
    outputs and the in-place cache against the JAX function's outputs
    and returned cache."""
    cfg, jcfg = _cfgs()
    jp, tp = _block_params("float32")
    b, d = 2, cfg.d_model
    rng = np.random.default_rng(7)
    jcache = jax_ssm.init_mamba_cache(jcfg, b, jnp.float32)
    jcache = {k: jnp.asarray(rng.standard_normal(v.shape).astype(np.float32))
              for k, v in jcache.items()}
    cache = {k: torch.from_numpy(np.array(v)) for k, v in jcache.items()}
    h_view = cache["h"]
    for _ in range(8):
        x = rng.standard_normal((b, 1, d)).astype(np.float32)
        want, jcache = jax_ssm.mamba_decode(jcfg, jp, jnp.asarray(x), jcache)
        with torch.no_grad():
            got, cache = ssm.mamba_decode(cfg, tp, torch.from_numpy(x),
                                          cache)
        _close(got, want, F32)
        for k in ("h", "conv"):
            np.testing.assert_allclose(cache[k].numpy(),
                                       np.asarray(jcache[k]), **F32)
    assert cache["h"] is h_view                   # updated in place


def test_bf16_decode_casts_the_state_before_the_output_einsum():
    """As the JAX package (repro/models/ssm.py:148): the cache keeps h in
    f32, and the output einsum reads it in the activation dtype."""
    cfg, jcfg = _cfgs(**DTYPES["bfloat16"])
    jp, tp = _block_params("bfloat16")
    cache = ssm.init_mamba_cache(cfg, 2, torch.bfloat16, "cpu")
    assert cache["h"].dtype == torch.float32
    assert cache["conv"].dtype == torch.bfloat16
    assert tuple(cache["h"].shape) == (2, 512, 8)
    assert tuple(cache["conv"].shape) == (2, 4, 512)
    jcache = jax_ssm.init_mamba_cache(jcfg, 2, jnp.bfloat16)
    x = _x(2, 1, cfg.d_model, seed=8)
    for _ in range(4):
        want, jcache = jax_ssm.mamba_decode(jcfg, jp, jnp.asarray(
            x, jnp.bfloat16), jcache)
        with torch.no_grad():
            got, cache = ssm.mamba_decode(
                cfg, tp, torch.from_numpy(x).to(torch.bfloat16), cache)
        assert got.dtype == torch.bfloat16
        _close(got, want, BF16)
    np.testing.assert_allclose(cache["h"].numpy(), np.asarray(jcache["h"]),
                               **BF16)


def _abar_share(tm, tp, tokens, monkeypatch):
    """The share of abar in (0.01, 0.99) over the forward's Mamba
    layers."""
    counts = [0, 0]
    real = ops.selective_scan_op

    def spy(abar, bx, c, **kw):
        counts[0] += int(((abar > 0.01) & (abar < 0.99)).sum())
        counts[1] += abar.numel()
        return real(abar, bx, c, **kw)
    monkeypatch.setattr(ops, "selective_scan_op", spy)
    with torch.no_grad():
        tm.forward(tp, torch.from_numpy(tokens))
    monkeypatch.setattr(ops, "selective_scan_op", real)
    return counts[0] / counts[1]


def test_reference_init_saturates_dt(monkeypatch):
    """The reference's initializer (repro/models/params.py:44) takes
    fan_in = shape[0], the period count once the layers are stacked: at
    one period every default-scale Mamba and expert matrix is drawn at
    std 1. dt = softplus(.) then saturates and exp(dt A) is ~0 or ~1:
    almost no abar lies in (0.01, 0.99) and the scan carries no decaying
    state. At each matrix's own fan-in most of it does (ROADMAP Queue C;
    chip_smoke.py phase 17 reads the full-width model)."""
    cfg, jcfg = _cfgs()
    jm, tm = JaxTransformer(jcfg), Transformer(cfg)
    jp = jm.init(jax.random.key(0))
    assert float(jnp.std(jp["layers"]["b0"]["mixer"]["in_proj"])) > 0.9
    tokens = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 32)).astype(np.int32)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    at_reference = _abar_share(tm, tp, tokens, monkeypatch)
    own = {k: v * (v.shape[0] / v.shape[-2]) ** 0.5
           if k.startswith("layers/") and k.endswith(
               ("in_proj", "x_proj", "dt_proj", "out_proj")) else v
           for k, v in tp.items()}
    at_own = _abar_share(tm, own, tokens, monkeypatch)
    assert at_reference < 0.02, at_reference
    assert at_own > 0.5, at_own
