"""The port's selective scan (``repro_torch.kernels.selective_scan``)
against the JAX package's.

On the CPU the wrapper runs its plain version (the CUDA kernel cannot
run here); the same numpy inputs go through the JAX package's Pallas
``selective_scan`` in interpret mode, as ``tests/test_kernels.py`` runs
it, through its sequential oracle ``ref.selective_scan_ref`` and through
the JAX model's chunked associative scan ``_ssm_scan_chunked``. The
kernel itself is held against the plain version on the card by the
``cuda``-marked test below and by ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jax_ops, ref
from repro.models.ssm import _ssm_scan_chunked
from repro_torch.kernels import ops, selective_scan as scan_mod

torch.set_num_threads(2)

# Tolerances: the JAX package's own (tests/test_kernels.py:10-11). f32:
# the plain version and the JAX oracle do the same sequential f32
# recurrence and differ only in the order of each step's n-sum (the
# associative scan and the Pallas kernel also in how the products are
# grouped): a few ulps of O(10) outputs. bf16 (y rounded to bf16): all
# arithmetic is f32 on both sides, so the outputs differ by at most one
# bf16 ulp where a few-ulp f32 difference straddles a rounding boundary,
# 2^-7 relative, inside atol = rtol = 5e-2.
TOL = {"float32": dict(atol=3e-5, rtol=1e-4),
       "bfloat16": dict(atol=5e-2, rtol=5e-2)}
# (abar dtype, bx and c dtype) of each case: all f32; all bf16 (the JAX
# sweep's bf16 case); abar f32 with bx and c bf16 (the model's path). y
# takes bx's dtype.
CASES = {"float32": ("float32", "float32"),
         "bfloat16": ("bfloat16", "bfloat16"),
         "mixed": ("float32", "bfloat16")}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}

# The JAX package's sweep (tests/test_kernels.py:125-128), (B, S, D, N,
# chunk, block_d), plus N=8 and N=16 (the reduced jamba's and the full
# model's state sizes).
SWEEP = [(1, 16, 8, 4, 8, 8), (2, 64, 32, 16, 16, 16),
         (1, 128, 64, 8, 32, 32), (3, 24, 8, 4, 8, 4),
         (2, 40, 24, 8, 8, 8), (1, 48, 16, 16, 16, 16)]


def _inputs(b, s, d, n, seed=0, lo=0.2, hi=0.99):
    rng = np.random.default_rng(seed)
    abar = rng.uniform(lo, hi, (b, s, d, n)).astype(np.float32)
    bx = rng.standard_normal((b, s, d, n)).astype(np.float32)
    c = rng.standard_normal((b, s, n)).astype(np.float32)
    return abar, bx, c


def _both(arrays, case):
    """The same numpy inputs as torch and jnp tensors in the case's dtypes
    (f32 -> bf16 rounds to nearest even in both frameworks)."""
    adt, xdt = CASES[case]
    dts = (adt, xdt, xdt)
    return ([torch.from_numpy(a).to(TORCH[d]) for a, d in zip(arrays, dts)],
            [jnp.asarray(a, JNP[d]) for a, d in zip(arrays, dts)])


def _close(got, want, dname):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **TOL[dname])


@pytest.mark.parametrize("b,s,d,n,chunk,bd", SWEEP)
@pytest.mark.parametrize("case", list(CASES))
def test_sweep_matches_jax(b, s, d, n, chunk, bd, case):
    (ta, tx, tc), (ja, jx, jc) = _both(_inputs(b, s, d, n), case)
    pallas = jax_ops.selective_scan_op(ja, jx, jc, chunk=chunk, block_d=bd)
    oracle = ref.selective_scan_ref(ja, jx, jc)
    dname = CASES[case][1]
    for got in (ops.selective_scan_op(ta, tx, tc, chunk=chunk, block_d=bd),
                scan_mod.selective_scan_plain(ta, tx, tc)):
        assert got.dtype == tx.dtype and got.shape == (b, s, d)
        for want in (pallas, oracle):
            _close(got, want, dname)


@pytest.mark.parametrize("case", list(CASES))
def test_matches_model_chunked_scan(case):
    """The JAX model's prefill scan (`_ssm_scan_chunked`, an associative
    scan per chunk in f32) returns bx's dtype, as the port does."""
    b, s, d, n = 2, 64, 8, 16
    (ta, tx, tc), (ja, jx, jc) = _both(_inputs(b, s, d, n, seed=1), case)
    want, _ = _ssm_scan_chunked(ja, jx, jc, jnp.zeros((b, d, n)), chunk=16)
    got = ops.selective_scan_op(ta, tx, tc)
    assert got.dtype == TORCH[CASES[case][1]]
    assert np.asarray(want).dtype == np.dtype(JNP[CASES[case][1]])
    _close(got, want, CASES[case][1])


def test_mixed_dtypes_pallas_returns_abar_dtype_port_returns_bx_dtype():
    """With abar f32 and bx bf16 (the model's mix) the Pallas kernel
    returns abar's dtype (repro/kernels/selective_scan.py:72) and the
    model's scan bx's; the port follows the model. The values agree."""
    (ta, tx, tc), (ja, jx, jc) = _both(_inputs(1, 32, 8, 8, seed=2),
                                       "mixed")
    pallas = jax_ops.selective_scan_op(ja, jx, jc, chunk=8, block_d=8)
    model, _ = _ssm_scan_chunked(ja, jx, jc, jnp.zeros((1, 8, 8)), chunk=8)
    assert pallas.dtype == jnp.float32 and model.dtype == jnp.bfloat16
    got = ops.selective_scan_op(ta, tx, tc)
    assert got.dtype == torch.bfloat16
    for want in (pallas, model):
        _close(got, want, "bfloat16")


def test_zero_decay_resets_and_unit_decay_sums():
    """abar = 0 keeps only the step's own input: y_t = Σ_n bx_t c_t;
    abar = 1 sums every past input — both against a direct sum."""
    _, bx, c = (torch.from_numpy(a) for a in _inputs(2, 20, 6, 8, seed=3))
    zero = ops.selective_scan_op(torch.zeros_like(bx), bx, c)
    torch.testing.assert_close(zero, torch.einsum("bsdn,bsn->bsd", bx, c),
                               atol=1e-6, rtol=1e-6)
    one = ops.selective_scan_op(torch.ones_like(bx), bx, c)
    want = torch.einsum("bsdn,bsn->bsd", bx.cumsum(dim=1), c)
    torch.testing.assert_close(one, want, atol=1e-5, rtol=1e-5)


def test_state_reset_mid_sequence_matches_two_scans():
    """A zero decay at step t0 cuts the sequence: the steps from t0 are
    the scan of that suffix alone."""
    abar, bx, c = (torch.from_numpy(a) for a in _inputs(1, 30, 4, 4, 4))
    abar[:, 17] = 0.0
    whole = ops.selective_scan_op(abar, bx, c)
    tail = ops.selective_scan_op(abar[:, 17:].contiguous(),
                                 bx[:, 17:].contiguous(), c[:, 17:])
    torch.testing.assert_close(whole[:, 17:], tail, atol=1e-6, rtol=1e-6)


def test_chunk_and_block_d_do_not_change_the_result():
    """``chunk`` and ``block_d`` are the TPU kernel's tiling; the port
    takes any S and D (here S=24, D=10: neither a multiple of 16)."""
    ta, tx, tc = (torch.from_numpy(a) for a in _inputs(1, 24, 10, 8, 5))
    want = ops.selective_scan_op(ta, tx, tc)
    for chunk, bd in ((1, 1), (5, 3), (16, 16), (64, 256)):
        assert torch.equal(ops.selective_scan_op(ta, tx, tc, chunk=chunk,
                                                 block_d=bd), want)


def test_strided_c_matches_contiguous():
    """The model passes c as a view of x_proj's output (a split of its
    last axis)."""
    ta, tx, tc = (torch.from_numpy(a) for a in _inputs(2, 12, 6, 8, 6))
    wide = torch.cat([torch.ones(2, 12, 5), tc, torch.ones(2, 12, 3)], -1)
    view = wide[..., 5:13]
    assert not view.is_contiguous() and view.stride(2) == 1
    assert torch.equal(ops.selective_scan_op(ta, tx, view),
                       ops.selective_scan_op(ta, tx, tc))


def test_cpu_path_launches_no_kernel():
    before = scan_mod.selective_scan.launches
    ops.selective_scan_op(*(torch.from_numpy(a)
                            for a in _inputs(1, 8, 4, 4)))
    assert scan_mod.selective_scan.launches == before


def _t(*shape, dtype=torch.float32, device="cpu"):
    return torch.ones(shape, dtype=dtype, device=device)


def _good(adt=torch.float32, xdt=None, device="cpu", n=8, s=6, d=4):
    xdt = xdt or adt
    return [_t(1, s, d, n, dtype=adt, device=device),
            _t(1, s, d, n, dtype=xdt, device=device),
            _t(1, s, n, dtype=xdt, device=device)]


def _replace(i, t, **kw):
    args = _good(**kw)
    args[i] = t
    return args


BAD_INPUTS = [
    (_replace(0, _t(6, 4, 8)), ValueError),
    (_replace(2, _t(1, 6, 4, 8)), ValueError),
    (_good(torch.float64), TypeError),
    (_good(torch.int32), TypeError),
    (_good(torch.bfloat16, torch.float32), TypeError),
    (_replace(2, _t(1, 6, 8, dtype=torch.bfloat16)), TypeError),
    (_replace(2, _t(1, 6, 8), xdt=torch.bfloat16), TypeError),
    (_good(n=2), ValueError),
    (_good(n=32), ValueError),
    (_replace(1, _t(1, 6, 5, 8)), ValueError),
    (_replace(2, _t(1, 7, 8)), ValueError),
    (_good(s=0), ValueError),
    (_replace(0, _t(1, 6, 8, 4).transpose(2, 3)), ValueError),
    (_replace(1, _t(1, 4, 6, 8).transpose(1, 2)), ValueError),
    (_replace(2, _t(1, 8, 6).transpose(1, 2)), ValueError),
    # a meta call (the dry run's) that the kernel's checks refuse; good
    # meta calls: tests/test_torch_roofline.py
    (_good(n=2, device="meta"), ValueError),
]
BAD_IDS = ["abar-rank-3", "c-rank-4", "f64", "int", "abar-bf16-bx-f32",
           "c-bf16-under-f32", "c-f32-under-bf16", "N-2", "N-32",
           "bx-shape-mismatch", "c-shape-mismatch", "S-0",
           "abar-not-contiguous", "bx-not-contiguous", "c-N-stride-not-1",
           "meta-device"]


@pytest.mark.parametrize("args,exc", BAD_INPUTS, ids=BAD_IDS)
def test_wrapper_rejects_bad_inputs(args, exc):
    with pytest.raises(exc):
        scan_mod.selective_scan(*args)


@pytest.mark.parametrize("args,exc", BAD_INPUTS, ids=BAD_IDS)
def test_op_rejects_bad_inputs(args, exc):
    """The CPU path refuses what the kernel would refuse."""
    with pytest.raises(exc):
        ops.selective_scan_op(*args)


def test_kernel_wrapper_refuses_cpu_tensors():
    """The kernel wrapper takes CUDA tensors only: the choice of the plain
    version is made in ops.selective_scan_op alone."""
    before = scan_mod.selective_scan.launches
    with pytest.raises(ValueError, match="CUDA"):
        scan_mod.selective_scan(*_good())
    assert scan_mod.selective_scan.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,d,n,chunk,bd",
                         SWEEP + [(2, 300, 130, 16, 64, 64)])
@pytest.mark.parametrize("case", list(CASES))
def test_kernel_matches_plain_on_card(b, s, d, n, chunk, bd, case):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the selective_scan kernel is CUDA "
                    "C++ and has no CPU or interpreter mode")
    adt, xdt = CASES[case]
    abar, bx, c = _inputs(b, s, d, n, seed=11)
    ta = torch.from_numpy(abar).to(TORCH[adt]).cuda()
    tx = torch.from_numpy(bx).to(TORCH[xdt]).cuda()
    # c as the model passes it: a split of a wider last axis
    wide = torch.from_numpy(np.concatenate(
        [np.ones((b, s, 3), np.float32), c], -1)).to(TORCH[xdt]).cuda()
    tc = wide[..., 3:]
    before = scan_mod.selective_scan.launches
    got = ops.selective_scan_op(ta, tx, tc, chunk=chunk, block_d=bd)
    torch.cuda.synchronize()
    assert scan_mod.selective_scan.launches == before + 1
    assert got.dtype == tx.dtype and got.is_contiguous()
    want = scan_mod.selective_scan_plain(ta, tx, tc)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), **TOL[xdt])
