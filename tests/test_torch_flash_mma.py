"""The arithmetic of flash attention's ``mma`` kernels (f32 as 3xTF32 at
every head-dim pair, bf16 at (8, 8) and (24, 16) with the depth
zero-padded to k16 and P, dS as two bf16 parts; ``csrc/mma_common.cuh``),
emulated on the CPU by ``tests/_torch_flash.py``, against the JAX
package: the forward against ``ref.flash_attention_ref``, the lse against
``logsumexp`` of the masked scores, the backward against ``jax.vjp`` of
the oracle; causal, windowed and bidirectional, GQA, lengths no multiple
of the kernels' 64-row tiles. The tolerances are those the kernels' parity
tests hold the f32 and bf16 kernels to: f32 the forward's ``atol=3e-5,
rtol=1e-4`` and the backward's ``atol=2e-5, rtol=1e-4``; bf16
``atol=5e-2, rtol=5e-2`` against the oracle in f32 on the same
bf16-rounded inputs (the backward's Δ reads the forward's output rounded
to bf16, which moves the early causal rows' dQ and dK past the tighter
``BWD_BF16_TOL``, for the plain backward as much), and ``BWD_BF16_TOL``
against the plain backward on the same o and lse, as the card holds the
kernels to it. One
TF32 product a term (the rounding 3xTF32 removes) breaks the f32
tolerance, and so do the backward's walks at S = 1024 accumulated in the
mma's own registers, under the emulation's model of the tensor core's
truncating adds (``mma_add``), where the kernels' per-tile chunks stay
within it. The kernels themselves are held to the plain version on the
card by the ``cuda`` sweeps of ``tests/test_torch_flash_dims.py``.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro_torch.kernels import flash_attention as fa_mod

from _torch_flash import (MMA_CHUNK, chip_smoke, mma_bwd_emulation,
                          mma_emulation)

torch.set_num_threads(2)

FWD_TOL = {"float32": dict(atol=3e-5, rtol=1e-4),
           "bfloat16": dict(atol=5e-2, rtol=5e-2)}
BWD_TOL = {"float32": dict(atol=2e-5, rtol=1e-4),
           "bfloat16": dict(atol=5e-2, rtol=5e-2)}
LSE_TOL = dict(atol=1e-5, rtol=1e-6)
# (dtype, D, Dv): every pair the mma route takes.
PAIRS = [("float32", d, d) for d in (8, 16, 32, 64, 128)] + [
    ("float32", 96, 64), ("float32", 24, 16), ("bfloat16", 8, 8),
    ("bfloat16", 24, 16)]
# (B, H, Hkv, Sq, Sk, causal, window): causal GQA at a length no multiple
# of 64, a window across tile edges with GQA 4:1, and bidirectional with
# Sq != Sk.
MASKS = [(2, 4, 2, 77, 77, True, None), (1, 8, 2, 100, 100, True, 24),
         (1, 2, 2, 40, 70, False, None)]
CASES = [(p, m) for p in PAIRS for m in MASKS]
IDS = [f"{dt[0]}{d}-{dv}-H{h}G{h // hkv}Sq{sq}Sk{sk}"
       f"{'c' if c else 'n'}w{w}"
       for (dt, d, dv), (b, h, hkv, sq, sk, c, w) in CASES]


def _inputs(dname, b, h, hkv, sq, sk, d, dv, seed):
    """q, k, v and dO in the case's dtype (torch) and the same values in
    f32 numpy (bf16-rounded where the case is bf16)."""
    rng = np.random.default_rng(seed)
    shapes = ((b, h, sq, d), (b, hkv, sk, d), (b, hkv, sk, dv),
              (b, h, sq, dv))
    ts = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
          .to(getattr(torch, dname)) for s in shapes]
    return ts, [t.float().numpy() for t in ts]


def _jax(q, k, v, do, causal, window):
    """The oracle's output, lse and gradients on JAX's CPU device at full
    f32 precision."""
    with jax.default_device(jax.devices("cpu")[0]), \
            jax.default_matmul_precision("highest"):
        jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
        out, vjp = jax.vjp(lambda a, b_, c: ref.flash_attention_ref(
            a, b_, c, causal, window), jq, jk, jv)
        grads = vjp(jnp.asarray(do))
        group = q.shape[1] // k.shape[1]
        s = jnp.einsum("bhqd,bhkd->bhqk", jq, jnp.repeat(jk, group, 1))
        s = s / math.sqrt(q.shape[-1])
        qp = jnp.arange(q.shape[2])[:, None]
        kp = jnp.arange(k.shape[2])[None, :]
        ok = jnp.ones(s.shape[2:], bool)
        if causal:
            ok &= qp >= kp
        if window is not None:
            ok &= qp - kp < window
        lse = jax.nn.logsumexp(jnp.where(ok, s, ref.NEG_INF), -1)
    return (np.asarray(out), np.asarray(lse),
            [np.asarray(g) for g in grads])


@pytest.mark.parametrize("pair,mask", CASES, ids=IDS)
def test_mma_forward_and_lse_match_jax(pair, mask):
    dname, d, dv = pair
    b, h, hkv, sq, sk, causal, window = mask
    (q, k, v, do), arrays = _inputs(dname, b, h, hkv, sq, sk, d, dv, seed=1)
    want_out, want_lse, _ = _jax(*arrays, causal, window)
    out, lse = mma_emulation(q, k, v, causal, window)
    assert out.dtype == q.dtype and out.shape == (b, h, sq, dv)
    np.testing.assert_allclose(out.float().numpy(), want_out,
                               **FWD_TOL[dname])
    np.testing.assert_allclose(lse.numpy(), want_lse, **LSE_TOL)


@pytest.mark.parametrize("pair,mask", CASES, ids=IDS)
def test_mma_backward_matches_jax_grad(pair, mask):
    dname, d, dv = pair
    b, h, hkv, sq, sk, causal, window = mask
    (q, k, v, do), arrays = _inputs(dname, b, h, hkv, sq, sk, d, dv, seed=2)
    _, _, want = _jax(*arrays, causal, window)
    # The kernels' backward takes the forward kernel's o (in the inputs'
    # dtype) and lse.
    o, lse = mma_emulation(q, k, v, causal, window)
    got = mma_bwd_emulation(q, k, v, o, lse, do, causal, window)
    for name, g, w, t in zip(("dq", "dk", "dv"), got, want, (q, k, v)):
        assert g.dtype == t.dtype and g.shape == t.shape, name
        np.testing.assert_allclose(g.float().numpy(), w, **BWD_TOL[dname],
                                   err_msg=name)
    if dname == "bfloat16":
        plain = fa_mod.flash_attention_bwd_plain(q, k, v, o, lse, do,
                                                 causal, window)
        for name, g, w in zip(("dq", "dk", "dv"), got, plain):
            np.testing.assert_allclose(g.float().numpy(), w.float().numpy(),
                                       **chip_smoke().BWD_BF16_TOL,
                                       err_msg=name)


@pytest.mark.parametrize("d,dv", [(128, 128), (96, 64)])
def test_one_tf32_product_breaks_f32_tolerance(d, dv):
    """Why f32 takes three products: with each f32 operand rounded once to
    TF32 (hi·hi alone, ~2^-11 of each term), the output leaves the f32
    tolerance that the 3xTF32 emulation meets on the same inputs."""
    (q, k, v, _), arrays = _inputs("float32", 1, 4, 2, 200, 200, d, dv,
                                   seed=3)
    want, _, _ = _jax(*arrays, True, None)
    good, _ = mma_emulation(q, k, v)
    np.testing.assert_allclose(good.numpy(), want, **FWD_TOL["float32"])
    bad, _ = mma_emulation(q, k, v, one_product=True)
    assert not np.allclose(bad.numpy(), want, **FWD_TOL["float32"])


@pytest.mark.parametrize("seed", [0, 1])
def test_unchunked_walk_breaks_f32_tolerance(seed):
    """Why ``mma::accumulate`` sums each tile's product in fresh registers
    and joins it to the running sums by f32 adds: at qwen3-0.6b's
    training length and GQA group (S = 1024, 2 query heads a KV head: 768
    mma adds into one accumulator for dK and dV), with an upstream
    gradient of one sign (dO of mean 1, so that dV = Pᵀ·dO sums terms of
    one sign), the modelled tensor core's adds, each truncated toward
    zero, drift dV past chip_smoke.py's f32 ``TOL`` from the plain
    backward when the walk stays in the mma's registers; in the kernels'
    tiles of 64 rows all three gradients stay within it."""
    (q, k, v, do), _ = _inputs("float32", 1, 2, 1, 1024, 1024, 64, 64,
                               seed=seed)
    do = do + 1.0
    tol = chip_smoke().TOL["float32"]
    o, lse = mma_emulation(q, k, v)
    want = fa_mod.flash_attention_bwd_plain(q, k, v, o, lse, do)
    chunked = mma_bwd_emulation(q, k, v, o, lse, do, chunk=MMA_CHUNK)
    for name, g, w in zip(("dq", "dk", "dv"), chunked, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), **tol, err_msg=name)
    whole = mma_bwd_emulation(q, k, v, o, lse, do, chunk=None)
    assert not np.allclose(whole[2].numpy(), want[2].numpy(), **tol)


@pytest.mark.parametrize("dname,d", [("float32", 8), ("float32", 64),
                                     ("float32", 96), ("float32", 128),
                                     ("float32", 24), ("bfloat16", 8),
                                     ("bfloat16", 24)])
def test_mma_variant_takes_every_pair_it_emulates(dname, d):
    """The emulated pairs are exactly those kernel_variant sends to the
    mma kernels."""
    assert fa_mod.kernel_variant(getattr(torch, dname), d) == "mma"
    assert any(p[0] == dname and p[1] == d for p in PAIRS)
