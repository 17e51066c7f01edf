"""The backward of the port's flash attention
(``repro_torch.kernels.flash_attention``: ``flash_attention_bwd``, its
plain version, ``FlashAttentionFn``) against ``jax.grad`` of the JAX
package's dense oracle ``ref.flash_attention_ref``.

The JAX package has no backward kernel: it trains through autodiff of
its attention. So the same numpy inputs and output cotangent go through
``jax.vjp`` of the oracle and through the port's plain backward (the
kernel's formulas: ``P = exp(S·scale − lse)``, ``Δ = rowsum(dO ⊙ O)``,
``dS = P ⊙ (dP − Δ)``, dK and dV summed over each KV head's query heads)
and the plain forward's autograd (the CPU training path). f32 tolerance
``atol=2e-5, rtol=1e-4``: the gradients are O(1-10) sums over up to 100
keys or query rows, in other orders on the two sides. The kernel itself
runs only on the card: the ``cuda``-marked tests hold it to the plain
version there, and on the CPU ``FlashAttentionFn``'s wiring is checked
with its two launchers replaced by the plain versions.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro_torch.kernels import flash_attention as fa_mod, ops

from _torch_flash import plain_launchers

torch.set_num_threads(2)

F32 = dict(atol=2e-5, rtol=1e-4)
# (B, H, Hkv, Sq, Sk, D, causal, window): GQA groups 1, 2, 4 and 8,
# causal and not, windows, Sq != Sk both ways, every head dim.
CASES = [
    (1, 2, 2, 16, 16, 8, True, None),
    (2, 4, 2, 33, 33, 16, True, None),
    (1, 8, 2, 40, 40, 32, True, 7),
    (1, 8, 1, 24, 24, 64, False, None),
    (1, 4, 4, 20, 37, 16, False, None),
    (1, 4, 1, 37, 20, 32, True, None),
    (2, 4, 2, 30, 30, 128, False, 12),
    (1, 16, 8, 48, 48, 128, True, None),
]
IDS = [f"B{b}H{h}G{h // hkv}Sq{sq}Sk{sk}D{d}{'c' if c else 'n'}w{w}"
       for b, h, hkv, sq, sk, d, c, w in CASES]


def _inputs(b, h, hkv, sq, sk, d, seed=0):
    """q, k, v and the output cotangent dO, f32 numpy."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, h, sq, d)).astype(np.float32),
            rng.standard_normal((b, hkv, sk, d)).astype(np.float32),
            rng.standard_normal((b, hkv, sk, d)).astype(np.float32),
            rng.standard_normal((b, h, sq, d)).astype(np.float32))


def _jax_grads(q, k, v, do, causal, window):
    """The oracle's output and gradients, on JAX's CPU device at full f32
    precision (a JAX with a GPU backend would otherwise take its f32
    matmuls in TF32 on the card, ~1e-3 relative)."""
    with jax.default_device(jax.devices("cpu")[0]), \
            jax.default_matmul_precision("highest"):
        out, vjp = jax.vjp(
            lambda a, b_, c: ref.flash_attention_ref(a, b_, c, causal,
                                                     window),
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
        grads = vjp(jnp.asarray(do))
    return [np.asarray(g) for g in grads], np.asarray(out)


def _bshd(a):
    """A (B, H, S, D) array as the model passes it: (B, S, H, D) storage
    viewed as (B, H, S, D)."""
    return torch.from_numpy(a).transpose(1, 2).contiguous().transpose(1, 2)


def _assert_grads(got, want, tol=F32):
    for name, g, w in zip("qkv", got, want):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(np.asarray(g, np.float32), w, **tol,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_bwd_plain_matches_jax_grad(case):
    b, h, hkv, sq, sk, d, causal, window = case
    q, k, v, do = _inputs(b, h, hkv, sq, sk, d)
    want, _ = _jax_grads(q, k, v, do, causal, window)
    tq, tk, tv, tdo = (_bshd(a) for a in (q, k, v, do))
    o = fa_mod.flash_attention_plain(tq, tk, tv, causal, window)
    lse = fa_mod.flash_attention_lse_plain(tq, tk, causal, window)
    got = fa_mod.flash_attention_bwd_plain(tq, tk, tv, o, lse, tdo, causal,
                                           window)
    _assert_grads([g.numpy() for g in got], want)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_plain_autograd_matches_jax_grad(case):
    """The CPU training path: ``ops.flash_attention_op`` on CPU tensors
    is the plain version, differentiated by autograd."""
    b, h, hkv, sq, sk, d, causal, window = case
    q, k, v, do = _inputs(b, h, hkv, sq, sk, d, seed=1)
    want, want_out = _jax_grads(q, k, v, do, causal, window)
    args = [_bshd(a).requires_grad_() for a in (q, k, v)]
    out = ops.flash_attention_op(*args, causal=causal, window=window)
    np.testing.assert_allclose(out.detach().numpy(), want_out, **F32)
    got = torch.autograd.grad(out, args, _bshd(do))
    _assert_grads([g.numpy() for g in got], want)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_lse_plain_matches_logsumexp(case):
    b, h, hkv, sq, sk, d, causal, window = case
    q, k, _, _ = _inputs(b, h, hkv, sq, sk, d, seed=2)
    s = jnp.einsum("bhqd,bhkd->bhqk", jnp.asarray(q),
                   jnp.repeat(jnp.asarray(k), h // hkv, axis=1)) / math.sqrt(d)
    qpos, kpos = jnp.arange(sq)[:, None], jnp.arange(sk)[None, :]
    ok = jnp.ones((sq, sk), bool)
    if causal:
        ok &= qpos >= kpos
    if window is not None:
        ok &= (qpos - kpos) < window
    want = np.asarray(jax.nn.logsumexp(jnp.where(ok, s, ref.NEG_INF), -1))
    got = fa_mod.flash_attention_lse_plain(_bshd(q), _bshd(k), causal,
                                           window)
    assert got.dtype == torch.float32 and got.shape == (b, h, sq)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-6)


@pytest.mark.parametrize("case", CASES[1:3] + CASES[6:7],
                         ids=IDS[1:3] + IDS[6:7])
def test_flash_attention_fn_wiring(case, monkeypatch):
    """With grad, the wrapper builds a ``FlashAttentionFn`` node: the
    forward launcher asked for lse, the backward launcher called once
    with the saved tensors; gradients equal to the plain version's
    autograd (the kernel's gradients are laid out like their inputs: the
    card tests check that). Without grad, one forward with no lse and no
    node."""
    b, h, hkv, sq, sk, d, causal, window = case
    calls = plain_launchers(monkeypatch)
    q, k, v, do = _inputs(b, h, hkv, sq, sk, d, seed=3)
    args = [_bshd(a).requires_grad_() for a in (q, k, v)]
    out = fa_mod.flash_attention(*args, causal=causal, window=window)
    assert "FlashAttentionFn" in type(out.grad_fn).__name__
    assert calls == [("fwd", True)]
    got = torch.autograd.grad(out, args, _bshd(do))
    assert calls == [("fwd", True), ("bwd", causal, window)]
    plain = [_bshd(a).requires_grad_() for a in (q, k, v)]
    want = torch.autograd.grad(
        fa_mod.flash_attention_plain(*plain, causal, window), plain,
        _bshd(do))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-6,
                                   rtol=1e-6)
    with torch.no_grad():
        out = fa_mod.flash_attention(*args, causal=causal, window=window)
    assert out.grad_fn is None and calls[-1] == ("fwd", False)


def test_launchers_take_cuda_tensors_only():
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(1, 2, 1, 8, 8, 16))
    with pytest.raises(ValueError, match="CUDA"):
        fa_mod.flash_attention_fwd(q, k, v, with_lse=True)
    o = fa_mod.flash_attention_plain(q, k, v)
    lse = fa_mod.flash_attention_lse_plain(q, k)
    with pytest.raises(ValueError, match="CUDA"):
        fa_mod.flash_attention_bwd(q, k, v, o, lse, do)


@pytest.mark.parametrize("bad", ["lse_shape", "lse_dtype", "do_dtype",
                                 "o_shape", "do_stride"])
def test_bwd_checks_its_inputs(bad):
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(1, 2, 1, 8, 8, 16))
    o = fa_mod.flash_attention_plain(q, k, v)
    lse = fa_mod.flash_attention_lse_plain(q, k)
    if bad == "lse_shape":
        lse = lse[..., :4]
    elif bad == "lse_dtype":
        lse = lse.double()
    elif bad == "do_dtype":
        do = do.bfloat16()
    elif bad == "o_shape":
        o = o[:, :, :4]
    else:
        do = do.transpose(2, 3).contiguous().transpose(2, 3)
    with pytest.raises(ValueError, match="flash_attention_bwd"):
        fa_mod.flash_attention_bwd(q, k, v, o, lse, do)


# ---------------------------------------------------------- on the card
def _on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the flash_attention kernels are "
                    "CUDA C++ and have no CPU or interpreter mode")


# bf16 on the card: kernel and plain version compute in f32 from the
# same bf16 inputs and round once, so they differ by about one bf16 ulp
# of each gradient (the sweep's short rows hold O(1-10) values).
CARD_TOL = {"float32": dict(atol=3e-5, rtol=1e-4),
            "bfloat16": dict(atol=5e-2, rtol=5e-2)}


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES + [(2, 16, 8, 300, 300, 128, True,
                                           None)],
                         ids=IDS + ["qwen-heads-S300"])
@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
def test_bwd_kernel_matches_plain_on_card(case, dname):
    _on_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    b, h, hkv, sq, sk, d, causal, window = case
    dt = getattr(torch, dname)
    q, k, v, do = (_bshd(a).to(dt).cuda() for a in _inputs(
        b, h, hkv, sq, sk, d, seed=4))
    out, lse = fa_mod.flash_attention_fwd(q, k, v, causal, window,
                                          with_lse=True)
    np.testing.assert_allclose(
        lse.cpu().numpy(),
        fa_mod.flash_attention_lse_plain(q, k, causal, window).cpu().numpy(),
        atol=1e-4, rtol=1e-5)
    fn = fa_mod.flash_attention
    before = (fn.launches_bwd, fn.launches_bwd_tc, fn.launches_bwd_mma)
    got = fa_mod.flash_attention_bwd(q, k, v, out, lse, do, causal, window)
    torch.cuda.synchronize()
    # bf16 at D >= 16 runs the wgmma kernels, f32 and D = 8 the mma.sync
    # ones.
    tc = fa_mod.kernel_variant(dt, d) == "tc"
    assert tc == (dname == "bfloat16" and d >= 16)
    assert (fn.launches_bwd, fn.launches_bwd_tc, fn.launches_bwd_mma) == (
        before[0] + 1, before[1] + tc, before[2] + (not tc))
    want = fa_mod.flash_attention_bwd_plain(q, k, v, out, lse, do, causal,
                                            window)
    for g, w, t in zip(got, want, (q, k, v)):
        assert g.dtype == t.dtype and g.stride() == t.stride()
        np.testing.assert_allclose(g.float().cpu().numpy(),
                                   w.float().cpu().numpy(), **CARD_TOL[dname])


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_autograd_on_card_matches_plain(case):
    """The wrapper under grad on the card (forward kernel with lse, then
    the backward kernel) against the plain version's autograd, f32."""
    _on_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    b, h, hkv, sq, sk, d, causal, window = case
    q, k, v, do = _inputs(b, h, hkv, sq, sk, d, seed=5)
    args = [_bshd(a).cuda().requires_grad_() for a in (q, k, v)]
    n = (fa_mod.flash_attention.launches, fa_mod.flash_attention.launches_bwd)
    got = torch.autograd.grad(ops.flash_attention_op(*args, causal=causal,
                                                     window=window),
                              args, _bshd(do).cuda())
    torch.cuda.synchronize()
    assert (fa_mod.flash_attention.launches,
            fa_mod.flash_attention.launches_bwd) == (n[0] + 1, n[1] + 1)
    want, _ = _jax_grads(q, k, v, do, causal, window)
    _assert_grads([g.cpu().numpy() for g in got], want,
                  CARD_TOL["float32"])


@pytest.mark.cuda
@pytest.mark.parametrize("d", [16, 64, 128])
def test_misaligned_bf16_views_run_bwd_on_tensor_cores(d):
    """q, k, v and dO as views TMA cannot address (an odd element offset,
    as a fused projection or autograd may hand them over): the wrapper
    copies them, and the call still runs the tensor-core kernels."""
    _on_card()
    b, h, hkv, s = 2, 4, 2, 100
    rng = np.random.default_rng(13)
    n = b * s * (h + 2 * hkv) * d
    flat = torch.from_numpy(rng.standard_normal(n + 1).astype(
        np.float32)).to(torch.bfloat16).cuda()
    qkv = flat[1:].view(b, s, h + 2 * hkv, d).transpose(1, 2)
    q, k, v = qkv[:, :h], qkv[:, h:h + hkv], qkv[:, h + hkv:]
    dflat = torch.from_numpy(rng.standard_normal(b * s * h * d + 1).astype(
        np.float32)).to(torch.bfloat16).cuda()
    do = dflat[1:].view(b, s, h, d).transpose(1, 2)
    assert not any(fa_mod.tma_addressable(t) for t in (q, k, v, do))
    out, lse = fa_mod.flash_attention_fwd(q, k, v, with_lse=True)
    fn = fa_mod.flash_attention
    before = (fn.launches_bwd_tc, fn.launches_bwd_mma)
    got = fa_mod.flash_attention_bwd(q, k, v, out, lse, do)
    torch.cuda.synchronize()
    assert (fn.launches_bwd_tc, fn.launches_bwd_mma) == (before[0] + 1,
                                                          before[1])
    want = fa_mod.flash_attention_bwd_plain(q, k, v, out, lse, do)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.float().cpu().numpy(),
                                   w.float().cpu().numpy(),
                                   **CARD_TOL["bfloat16"])


@pytest.mark.cuda
@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
def test_bwd_kernel_is_deterministic_on_card(dname):
    """Every gradient element has one writer (no atomics): repeated calls
    give bit-equal gradients."""
    _on_card()
    dt = getattr(torch, dname)
    q, k, v, do = (_bshd(a).to(dt).cuda() for a in _inputs(
        2, 16, 8, 300, 300, 128, seed=6))
    out, lse = fa_mod.flash_attention_fwd(q, k, v, with_lse=True)
    first = fa_mod.flash_attention_bwd(q, k, v, out, lse, do)
    for _ in range(3):
        again = fa_mod.flash_attention_bwd(q, k, v, out, lse, do)
        assert all(torch.equal(a, b) for a, b in zip(again, first))
