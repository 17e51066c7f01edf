"""The port's flash attention (``repro_torch.kernels.flash_attention``)
against the JAX package's.

On the CPU the wrapper runs its plain version (the CUDA kernel cannot
run here); the same numpy inputs go through the JAX package's Pallas
``flash_attention`` in interpret mode, as ``tests/test_kernels.py`` runs
it, and through its dense oracle ``ref.flash_attention_ref``. The kernels
themselves are held against the plain version on the card by the
``cuda``-marked tests below and by ``chip_smoke.py``. The tensor-core
kernel's numerics (P rounded to bf16 before P·V) are emulated here on the
CPU and held to the tolerance the card holds the kernel to.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.kernels import ops as jax_ops, ref
from repro.models import attention as jax_attn
from repro.models.params import init_params as jax_init_params
from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention as fa_mod, ops
from repro_torch.models import attention as attn, params_from_numpy

from _torch_flash import TC_BLOCK_K, tc_emulation as _tc_emulation
from _torch_jamba import chip_smoke

torch.set_num_threads(2)

# The JAX package's own kernel tolerances (tests/test_kernels.py:10-11):
# f32 differs in the order of the score and P·V sums (online vs dense
# softmax); bf16 is one rounding of the output.
TOL = {"float32": dict(atol=3e-5, rtol=1e-4),
       "bfloat16": dict(atol=5e-2, rtol=5e-2)}
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}

SWEEP = [
    (1, 2, 2, 32, 32, 16, 16, 16),      # MHA
    (2, 4, 2, 64, 64, 32, 16, 32),      # GQA 2:1
    (1, 8, 2, 48, 48, 64, 16, 16),      # GQA 4:1, ragged blocks
    (1, 2, 1, 40, 40, 8, 16, 16),       # padding path (40 % 16 != 0)
    (2, 2, 2, 128, 128, 128, 128, 128),  # production tile
]


def _qkv(b, h, hkv, sq, sk, d, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, h, sq, d)).astype(np.float32),
            rng.standard_normal((b, hkv, sk, d)).astype(np.float32),
            rng.standard_normal((b, hkv, sk, d)).astype(np.float32))


def _both(arrays, dname):
    """The same numpy inputs as torch and jnp tensors of one dtype
    (f32 -> bf16 rounds to nearest-even in both frameworks)."""
    tdt, jdt = DTYPES[dname]
    return ([torch.from_numpy(a).to(tdt) for a in arrays],
            [jnp.asarray(a, jdt) for a in arrays])


def _check_port(tq, tk, tv, wants, dname, **kw):
    for got in (fa_mod.flash_attention_plain(tq, tk, tv, **kw),
                ops.flash_attention_op(tq, tk, tv, **kw)):
        assert got.dtype == tq.dtype and got.shape == tq.shape
        for want in wants:
            np.testing.assert_allclose(got.float().numpy(),
                                       np.asarray(want, np.float32),
                                       **TOL[dname])


@pytest.mark.parametrize("b,h,hkv,sq,sk,d,bq,bk", SWEEP)
@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
def test_causal_sweep_matches_jax(b, h, hkv, sq, sk, d, bq, bk, dname):
    (tq, tk, tv), (jq, jk, jv) = _both(_qkv(b, h, hkv, sq, sk, d), dname)
    pallas = jax_ops.flash_attention_op(jq, jk, jv, causal=True,
                                        block_q=bq, block_k=bk)
    oracle = ref.flash_attention_ref(jq, jk, jv, causal=True)
    _check_port(tq, tk, tv, (pallas, oracle), dname, causal=True)


@pytest.mark.parametrize("window", [1, 8, 24, 1000])
def test_sliding_window_matches_jax(window):
    (tq, tk, tv), (jq, jk, jv) = _both(_qkv(1, 2, 2, 64, 64, 16, seed=3),
                                       "float32")
    pallas = jax_ops.flash_attention_op(jq, jk, jv, causal=True,
                                        window=window, block_q=16,
                                        block_k=16)
    oracle = ref.flash_attention_ref(jq, jk, jv, causal=True, window=window)
    _check_port(tq, tk, tv, (pallas, oracle), "float32", causal=True,
                window=window)


@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
def test_gqa_window_matches_oracle(dname):
    (tq, tk, tv), (jq, jk, jv) = _both(_qkv(2, 8, 2, 80, 80, 32, seed=4),
                                       dname)
    oracle = ref.flash_attention_ref(jq, jk, jv, causal=True, window=20)
    _check_port(tq, tk, tv, (oracle,), dname, causal=True, window=20)


def test_bidirectional_matches_jax():
    (tq, tk, tv), (jq, jk, jv) = _both(_qkv(1, 2, 2, 32, 32, 16, seed=6),
                                       "float32")
    pallas = jax_ops.flash_attention_op(jq, jk, jv, causal=False,
                                        block_q=16, block_k=16)
    oracle = ref.flash_attention_ref(jq, jk, jv, causal=False)
    _check_port(tq, tk, tv, (pallas, oracle), "float32", causal=False)


def test_strided_views_match_contiguous():
    """The model passes (B, S, H, D) tensors as transposed views."""
    q, k, v = _qkv(2, 4, 2, 24, 24, 16, seed=7)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    views = [t.transpose(1, 2).contiguous().transpose(1, 2)
             for t in (tq, tk, tv)]
    assert not views[0].is_contiguous() and views[0].stride(3) == 1
    np.testing.assert_array_equal(ops.flash_attention_op(*views).numpy(),
                                  ops.flash_attention_op(tq, tk, tv).numpy())


def test_model_attention_path_matches_jax():
    """``attention_forward`` (GQA, qk-norm, RoPE) through the port's
    attention op against the JAX package's blockwise path (S=64 > the
    reduced config's attn_chunk_q=32), on the same params."""
    cfg = dataclasses.replace(get_config("qwen3-0.6b").reduced(),
                              num_kv_heads=2)
    jcfg = dataclasses.replace(jax_get_config("qwen3-0.6b").reduced(),
                               num_kv_heads=2)
    jp = jax_init_params(jax_attn.gqa_defs(jcfg), jax.random.key(9))
    tp = params_from_numpy({k: np.asarray(v) for k, v in jp.items()}, "cpu")
    x = np.random.default_rng(10).standard_normal(
        (2, 64, cfg.d_model)).astype(np.float32)
    want = jax_attn.attention_forward(jcfg, jp, jnp.asarray(x),
                                      jnp.arange(64, dtype=jnp.int32))
    got = attn.attention_forward(cfg, tp, torch.from_numpy(x),
                                 torch.arange(64, dtype=torch.int32))
    # f32 both sides; the sums run in other orders (atol as the JAX
    # package's own kernel-vs-model check, test_kernels.py:122).
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    with pytest.raises(RuntimeError, match="arange"):
        attn.attention_forward(cfg, tp, torch.from_numpy(x),
                               torch.arange(1, 65, dtype=torch.int32))
    with pytest.raises(ValueError, match="positions"):
        attn.attention_forward(cfg, tp, torch.from_numpy(x),
                               torch.arange(32, dtype=torch.int32))


def test_cpu_path_launches_no_kernel():
    before = fa_mod.flash_attention.launches
    tq, tk, tv = (torch.from_numpy(a) for a in _qkv(1, 2, 1, 8, 8, 8))
    ops.flash_attention_op(tq, tk, tv)
    assert fa_mod.flash_attention.launches == before


def _t(*shape, dtype=torch.float32, device="cpu"):
    return torch.ones(shape, dtype=dtype, device=device)


BAD_INPUTS = [
    (_t(1, 2, 8, 16, dtype=torch.float64), _t(1, 2, 8, 16,
     dtype=torch.float64), _t(1, 2, 8, 16, dtype=torch.float64), None,
     TypeError),
    (_t(1, 2, 8, 16, dtype=torch.int32), _t(1, 2, 8, 16, dtype=torch.int32),
     _t(1, 2, 8, 16, dtype=torch.int32), None, TypeError),
    (_t(1, 2, 8, 16), _t(1, 2, 8, 16, dtype=torch.bfloat16),
     _t(1, 2, 8, 16), None, TypeError),
    (_t(2, 8, 16), _t(2, 8, 16), _t(2, 8, 16), None, ValueError),
    (_t(1, 3, 8, 16), _t(1, 2, 8, 16), _t(1, 2, 8, 16), None, ValueError),
    (_t(1, 2, 16, 8).transpose(2, 3), _t(1, 2, 8, 16), _t(1, 2, 8, 16),
     None, ValueError),
    (_t(1, 2, 8, 16), _t(1, 2, 8, 16), _t(1, 2, 9, 16), None, ValueError),
    (_t(1, 2, 8, 16), _t(1, 2, 8, 16), _t(1, 2, 8, 16), 0, ValueError),
    (_t(1, 2, 0, 16), _t(1, 2, 8, 16), _t(1, 2, 8, 16), None, ValueError),
    (_t(1, 2, 8, 12, device="meta"), _t(1, 2, 8, 12, device="meta"),
     _t(1, 2, 8, 12, device="meta"), None, ValueError),
]
# The table of head-dim pairs binds only the kernels, and is checked on the
# card (tests/test_torch_flash_dims.py): the plain version takes any pair.
# Meta tensors stand for the kernels' calls in the dry run, so the table
# binds them too (D = 12 is not in it); tests/test_torch_roofline.py
# holds good meta calls and the kernel wrappers' refusal of them.
BAD_IDS = ["f64", "int", "mixed-dtype", "rank-3", "H-not-multiple-of-Hkv",
           "D-stride-not-1", "k-v-mismatch", "window-0", "Sq-0",
           "meta-device"]


@pytest.mark.parametrize("q,k,v,window,exc", BAD_INPUTS, ids=BAD_IDS)
def test_wrapper_rejects_bad_inputs(q, k, v, window, exc):
    with pytest.raises(exc):
        fa_mod.flash_attention(q, k, v, window=window)


@pytest.mark.parametrize("q,k,v,window,exc", BAD_INPUTS, ids=BAD_IDS)
def test_op_rejects_bad_inputs(q, k, v, window, exc):
    """The CPU path refuses what the kernel would refuse, but for the
    kernels' table of head dims."""
    with pytest.raises(exc):
        ops.flash_attention_op(q, k, v, window=window)


def test_kernel_wrapper_refuses_cpu_tensors():
    """The kernel wrapper takes CUDA tensors only: the choice of the plain
    version is made in ops.flash_attention_op alone."""
    before = fa_mod.flash_attention.launches
    tq, tk, tv = (torch.from_numpy(a) for a in _qkv(1, 2, 1, 8, 8, 8))
    with pytest.raises(ValueError, match="CUDA"):
        fa_mod.flash_attention(tq, tk, tv)
    assert fa_mod.flash_attention.launches == before


def _prefill_bf16(seed, b=1, h=8, hkv=4, s=1024, d=128):
    return [torch.from_numpy(a).to(torch.bfloat16)
            for a in _qkv(b, h, hkv, s, s, d, seed=seed)]


def test_tensor_core_numerics_fit_prefill_tolerance():
    """The kernel's one rounding beyond the plain version's, P in bf16
    (with the remainder on mask-edge tiles), fits the tolerance that
    chip_smoke.py holds it to at the prefill shapes. At S=1024 the
    outputs are O(1/sqrt(S)), so the tolerance is as tight as at 4096."""
    tol = chip_smoke().PREFILL_BF16_TOL
    q, k, v = _prefill_bf16(seed=20)
    got = _tc_emulation(q, k, v)
    want = fa_mod.flash_attention_plain(q, k, v)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                               **tol)


def test_bf16_p_on_every_tile_breaks_prefill_tolerance():
    """Why the kernel adds the remainder on mask-edge tiles: with P
    rounded to bf16 on every tile, the first rows (few keys, each with an
    O(1) share of P) carry the rounding into outputs near 0 past the
    tolerance's atol."""
    tol = chip_smoke().PREFILL_BF16_TOL
    q, k, v = _prefill_bf16(seed=20)
    got = _tc_emulation(q, k, v, split_masked=False).float()
    want = fa_mod.flash_attention_plain(q, k, v).float()
    bad = ~torch.isclose(got, want, **tol)
    assert bad.any()
    assert int(torch.nonzero(bad)[:, 2].max()) < TC_BLOCK_K


@pytest.mark.parametrize("causal,window", [(True, None), (True, 63),
                                           (True, 200), (False, None)])
def test_tensor_core_emulation_matches_plain_on_ragged_rows(causal, window):
    """The emulation agrees with the plain version at a length that is no
    multiple of a tile (S=320), under causal, window and no mask."""
    q, k, v = _prefill_bf16(seed=21, b=2, h=4, hkv=2, s=320, d=64)
    np.testing.assert_allclose(
        _tc_emulation(q, k, v, causal, window).float().numpy(),
        fa_mod.flash_attention_plain(q, k, v, causal, window).float()
        .numpy(), **TOL["bfloat16"])


@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", sorted({d for d, _ in fa_mod.KERNEL_DIMS}))
def test_kernel_variant_by_dtype_and_head_dim(dname, d):
    """bf16 with D a multiple of wgmma's k16 depth (16, 32, 64, 96, 128)
    runs on the wgmma kernel; f32 (3xTF32) and D in {8, 24} on the
    mma.sync kernel."""
    want = "tc" if dname == "bfloat16" and d in (16, 32, 64, 96, 128) \
        else "mma"
    assert fa_mod.kernel_variant(DTYPES[dname][0], d) == want


def test_tma_addressable():
    """TMA takes a 16-byte aligned base and strides that are multiples of
    16 bytes on the axes longer than 1; else the wrapper copies."""
    base = torch.zeros(4 * 64 * 16 * 64 + 8, dtype=torch.bfloat16)
    dense = base[:4 * 64 * 16 * 64].view(4, 16, 64, 64)
    assert fa_mod.tma_addressable(dense)
    assert fa_mod.tma_addressable(dense.transpose(1, 2).contiguous()
                                  .transpose(1, 2))
    assert not fa_mod.tma_addressable(base[1:1 + dense.numel()]
                                      .view(4, 16, 64, 64))
    odd = torch.zeros(1, 2, 8, 72, dtype=torch.bfloat16)[..., :64]
    assert fa_mod.tma_addressable(odd)          # 144-byte rows
    odd = torch.zeros(1, 2, 8, 68, dtype=torch.bfloat16)[..., :64]
    assert not fa_mod.tma_addressable(odd)      # 136-byte rows
    one = torch.zeros(1, 1, 1, 68, dtype=torch.bfloat16)[..., :64]
    assert fa_mod.tma_addressable(one)          # no axis longer than 1


def _on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the flash_attention kernels are "
                    "CUDA C++ and have no CPU or interpreter mode")


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,hkv,s,d,causal,window", [
    (1, 2, 2, 32, 16, True, None), (2, 4, 2, 64, 32, True, None),
    (1, 8, 2, 48, 64, True, None), (1, 2, 1, 40, 8, True, None),
    (2, 2, 2, 128, 128, True, None), (1, 2, 2, 64, 16, True, 8),
    (1, 2, 2, 100, 16, True, 24), (1, 2, 2, 32, 16, False, None),
    (2, 16, 8, 300, 128, True, None),
    # ragged lengths around the tensor-core kernel's 64/128-row tiles,
    # GQA groups 1-8, windows across a tile edge
    (1, 2, 2, 1, 128, True, None), (1, 4, 2, 63, 64, True, None),
    (1, 4, 1, 65, 128, True, None), (2, 8, 1, 127, 64, True, 63),
    (1, 8, 2, 129, 128, True, 1), (1, 8, 8, 300, 64, True, 200),
    (1, 4, 1, 300, 128, False, None),
])
@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
def test_kernel_matches_plain_on_card(b, h, hkv, s, d, causal, window,
                                      dname):
    _on_card()
    tdt = DTYPES[dname][0]
    q, k, v = _qkv(b, h, hkv, s, s, d, seed=11)
    # (B, S, H, D) storage, passed as (B, H, S, D) views, as the model does
    tq, tk, tv = (torch.from_numpy(a).to(tdt).cuda().transpose(1, 2)
                  .contiguous().transpose(1, 2) for a in (q, k, v))
    fn = fa_mod.flash_attention
    before = (fn.launches, fn.launches_tc, fn.launches_mma)
    got = fn(tq, tk, tv, causal=causal, window=window)
    torch.cuda.synchronize()
    tc = fa_mod.kernel_variant(tdt, d) == "tc"
    assert tc == (dname == "bfloat16" and d >= 16)
    assert (fn.launches, fn.launches_tc, fn.launches_mma) == (
        before[0] + 1, before[1] + tc, before[2] + (not tc))
    assert got.transpose(1, 2).is_contiguous()
    torch.backends.cuda.matmul.allow_tf32 = False
    want = fa_mod.flash_attention_plain(tq, tk, tv, causal, window)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), **TOL[dname])


@pytest.mark.cuda
@pytest.mark.parametrize("d", [16, 64, 128])
def test_misaligned_bf16_view_runs_on_tensor_cores(d):
    """A view at an odd element offset (no 16-byte aligned base for TMA)
    is copied by the wrapper and still runs the tensor-core kernel."""
    _on_card()
    b, h, hkv, s = 2, 4, 2, 100
    n = b * s * (h + 2 * hkv) * d
    flat = torch.from_numpy(np.random.default_rng(12).standard_normal(
        n + 1).astype(np.float32)).to(torch.bfloat16).cuda()
    qkv = flat[1:].view(b, s, h + 2 * hkv, d).transpose(1, 2)
    q, k, v = qkv[:, :h], qkv[:, h:h + hkv], qkv[:, h + hkv:]
    assert not fa_mod.tma_addressable(q)
    fn = fa_mod.flash_attention
    before = (fn.launches_tc, fn.launches_mma)
    got = fn(q, k, v)
    torch.cuda.synchronize()
    assert (fn.launches_tc, fn.launches_mma) == (before[0] + 1, before[1])
    want = fa_mod.flash_attention_plain(q, k, v)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(),
                               **TOL["bfloat16"])
