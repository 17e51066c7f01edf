"""The flash kernels' head-dim pairs (``repro_torch.kernels
.flash_attention``): q and k of head dim D, v of Dv, the output of Dv.

The kernels take the pairs of ``KERNEL_DIMS``: D == Dv in ``HEAD_DIMS``,
(96, 64), MLA's (minicpm3-4b), and (24, 16), the reduced MLA's, forward
and backward; the wrapper counts their launches in ``launches_split``
and ``launches_bwd_split``. The plain version takes any pair on the CPU,
held here to a dense f64 reference. Under grad both split pairs build
the kernels' autograd node (``tests/test_torch_flash_split_bwd.py``
holds their gradients).
The ``cuda``-marked tests hold the kernels to the plain version on the
card (bf16 on the wgmma kernel, f32 on the mma.sync one), with causal,
windowed and bidirectional masks, ragged lengths and Sq != Sk
(whisper's cross-attention, 4096 queries against 1500 frames), at
chip_smoke.py's tolerances: in bf16 the prefill's, which the tensor-core
kernel's arithmetic, emulated here on the CPU, meets at these shapes, and
which the ragged last K/V tile's planted faults break. No JAX here: the
card's tests compare with the plain version.
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa_mod, ops

from _torch_flash import chip_smoke, plain_launchers, tc_emulation

torch.set_num_threads(2)

TOL = chip_smoke().SPLIT_TOL


def _views(b, h, hkv, sq, sk, d, dv, dtype=torch.float32, device="cpu",
           seed=0):
    """q, k, v as the model passes them: (B, S, H, D) storage viewed as
    (B, H, S, D)."""
    g = torch.Generator().manual_seed(seed)
    return [torch.randn((b, s, n, e), generator=g).to(dtype).to(device)
            .transpose(1, 2)
            for s, n, e in ((sq, h, d), (sk, hkv, d), (sk, hkv, dv))]


def _dense(q, k, v, causal, window):
    """f64 attention with the kernels' mask rules."""
    group = q.shape[1] // k.shape[1]
    s = torch.einsum("bhqd,bhkd->bhqk", q.double(),
                     k.repeat_interleave(group, 1).double())
    s = s / math.sqrt(q.shape[-1])
    qp = torch.arange(q.shape[2])[:, None]
    kp = torch.arange(k.shape[2])[None, :]
    ok = torch.ones_like(s[0, 0], dtype=torch.bool)
    if causal:
        ok &= qp >= kp
    if window is not None:
        ok &= qp - kp < window
    p = torch.softmax(s.masked_fill(~ok, -1e30), -1)
    return torch.einsum("bhqk,bhkd->bhqd", p,
                        v.repeat_interleave(group, 1).double())


@pytest.mark.parametrize("d,dv", [(24, 16), (96, 64), (48, 48), (256, 256),
                                  (8, 32)])
@pytest.mark.parametrize("sq,sk,causal,window", [
    (17, 17, True, None), (33, 33, True, 5), (9, 40, False, None),
    (40, 9, False, None)])
def test_op_takes_any_head_dims_on_cpu(d, dv, sq, sk, causal, window):
    q, k, v = _views(2, 4, 2, sq, sk, d, dv)
    got = ops.flash_attention_op(q, k, v, causal=causal, window=window)
    assert got.shape == (2, 4, sq, dv)
    np.testing.assert_allclose(got.numpy(),
                               _dense(q, k, v, causal, window).numpy(),
                               atol=1e-5, rtol=0)


def test_kernel_dims_table():
    assert (96, 64) in fa_mod.KERNEL_DIMS and (24, 16) in fa_mod.KERNEL_DIMS
    assert all((d, d) in fa_mod.KERNEL_DIMS for d in fa_mod.HEAD_DIMS)
    assert len(fa_mod.KERNEL_DIMS) == len(fa_mod.HEAD_DIMS) + 2


# chip_smoke.py's phase 7 sweeps: (96, 64) as (B, H, Hkv, Sq, Sk, causal,
# window), and cross-attention's and the encoder's shapes, the causal mask
# off, as (B, H, Hkv, Sq, Sk, D).
SPLIT_CASES = chip_smoke().FLASH_SPLIT_SWEEP
CROSS_CASES = chip_smoke().FLASH_CROSS_SWEEP


@pytest.mark.parametrize("b,h,hkv,sq,sk,causal,window", SPLIT_CASES)
def test_tensor_core_split_numerics_fit_the_tolerance(b, h, hkv, sq, sk,
                                                      causal, window):
    """The tensor-core kernel's arithmetic at the (96, 64) cases, emulated
    on bf16 inputs, agrees with the plain version within the tolerance
    the card's tests and chip_smoke.py hold the kernel to."""
    q, k, v = _views(b, h, hkv, sq, sk, 96, 64, torch.bfloat16, seed=11)
    np.testing.assert_allclose(
        tc_emulation(q, k, v, causal, window).float().numpy(),
        fa_mod.flash_attention_plain(q, k, v, causal, window).float()
        .numpy(), **TOL["bfloat16"])


@pytest.mark.parametrize("b,h,hkv,sq,sk,d", [c for c in CROSS_CASES
                                             if c[5] >= 16])
def test_tensor_core_cross_numerics_fit_the_tolerance(b, h, hkv, sq, sk, d):
    """The same at the bidirectional Sq != Sk shapes that run on the
    tensor cores (whisper's at one batch row and 2 of its 12 heads: the
    rows, and so the tolerance, do not depend on B or H)."""
    h, hkv = min(h, 2), min(hkv, 2)
    q, k, v = _views(1, h, hkv, sq, sk, d, d, torch.bfloat16, seed=12)
    np.testing.assert_allclose(
        tc_emulation(q, k, v, causal=False).float().numpy(),
        fa_mod.flash_attention_plain(q, k, v, causal=False).float()
        .numpy(), **TOL["bfloat16"])


def test_ragged_tile_faults_break_the_tolerance():
    """At whisper's cross-attention shape (4096 queries, 1500 keys, the
    last 128-key tile holding 92) chip_smoke.py's planted faults of that
    tile, dropped or its 36 slots past Sk read unmasked, break the bf16
    tolerance, while the emulated kernel meets it."""
    sq, sk = chip_smoke().WHISPER_CROSS
    q, k, v = _views(1, 2, 2, sq, sk, 64, 64, torch.bfloat16, seed=13)
    want = fa_mod.flash_attention_plain(q, k, v, causal=False)
    np.testing.assert_allclose(
        tc_emulation(q, k, v, causal=False).float().numpy(),
        want.float().numpy(), **TOL["bfloat16"])
    errs = chip_smoke().check_ragged_faults(torch, q, k, v, want)
    assert len(errs) == 2 and min(errs.values()) > TOL["bfloat16"]["atol"]


def test_split_output_is_laid_out_like_q():
    """The output of a (B, S, H, 96) view is (B, H, S, 64) over a
    (B, S, H, 64) storage, so the model's reshape is a view."""
    q, _, _ = _views(2, 5, 5, 7, 7, 96, 64)
    out = fa_mod._out_like(q, 64)
    assert out.shape == (2, 5, 7, 64) and out.dtype == q.dtype
    assert out.transpose(1, 2).is_contiguous()
    assert fa_mod._out_like(q, 96).stride() == q.stride()


def test_split_dims_under_grad_raise_before_any_launch(monkeypatch):
    """MLA's flash under grad, at both split pairs: nothing raises any
    more. The kernel wrapper and the autograd Function run the forward
    launcher with lse and the backward launcher (replaced here by the
    plain versions), whose input check takes o and dO Dv wide; the
    gradients are the plain version's autograd, as on the CPU path."""
    calls = plain_launchers(monkeypatch)
    for d, dv in ((96, 64), (24, 16)):
        q, k, v = _views(1, 2, 2, 8, 8, d, dv)
        q.requires_grad_()
        del calls[:]
        for run in (lambda: fa_mod.flash_attention(q, k, v),
                    lambda: fa_mod.FlashAttentionFn.apply(q, k, v, True,
                                                          None)):
            out = run()
            assert out.shape == (1, 2, 8, dv)
            (g,) = torch.autograd.grad(out.sum(), [q])
            (want,) = torch.autograd.grad(
                ops.flash_attention_op(q, k, v).sum(), [q])
            np.testing.assert_allclose(g.numpy(), want.numpy(), atol=1e-6,
                                       rtol=1e-6)
        assert calls == [("fwd", True), ("bwd", True, None)] * 2
        o = q.new_zeros(1, 2, 8, dv)
        fa_mod.check_bwd_inputs(q, k, v, o, q.new_zeros(1, 2, 8), o, None)


# ------------------------------------------------------------- the card
def _on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the flash_attention kernels are "
                    "CUDA C++ and have no CPU or interpreter mode")


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,hkv,sq,sk,causal,window", SPLIT_CASES)
@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
def test_split_kernel_matches_plain_on_card(b, h, hkv, sq, sk, causal,
                                            window, dname):
    _on_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    dtype = getattr(torch, dname)
    q, k, v = _views(b, h, hkv, sq, sk, 96, 64, dtype, "cuda", seed=11)
    fn = fa_mod.flash_attention
    before = (fn.launches_tc, fn.launches_mma, fn.launches_split)
    got = fn(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    tc = dname == "bfloat16"
    assert (fn.launches_tc, fn.launches_mma, fn.launches_split) == (
        before[0] + tc, before[1] + (not tc), before[2] + 1)
    assert got.shape == (b, h, sq, 64) and got.transpose(1, 2).is_contiguous()
    want = fa_mod.flash_attention_plain(q, k, v, causal, window)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), **TOL[dname])


# chip_smoke.py's phase 7 sweep of the reduced MLA's (24, 16) pair.
REDUCED_CASES = chip_smoke().FLASH_REDUCED_MLA_SWEEP


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,hkv,sq,sk,causal,window", REDUCED_CASES)
@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
def test_reduced_mla_pair_matches_plain_on_card(b, h, hkv, sq, sk, causal,
                                                window, dname):
    """The reduced MLA's (24, 16): D = 24 is not a multiple of wgmma's
    k16, so both dtypes run the mma.sync kernel, counted as a split
    launch."""
    _on_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    dtype = getattr(torch, dname)
    q, k, v = _views(b, h, hkv, sq, sk, 24, 16, dtype, "cuda", seed=14)
    fn = fa_mod.flash_attention
    before = (fn.launches_tc, fn.launches_mma, fn.launches_split)
    got = fn(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert (fn.launches_tc, fn.launches_mma, fn.launches_split) == (
        before[0], before[1] + 1, before[2] + 1)
    assert got.shape == (b, h, sq, 16) and got.transpose(1, 2).is_contiguous()
    want = fa_mod.flash_attention_plain(q, k, v, causal, window)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), **TOL[dname])


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,hkv,sq,sk,d", CROSS_CASES)
@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
def test_bidirectional_ragged_sq_ne_sk_on_card(b, h, hkv, sq, sk, d, dname):
    """Cross-attention's shapes: the causal mask off, Sq != Sk, Sk ragged
    against the 128-key tiles (whisper: 4096 x 1500, and its encoder's
    1500 x 1500)."""
    _on_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    dtype = getattr(torch, dname)
    q, k, v = _views(b, h, hkv, sq, sk, d, d, dtype, "cuda", seed=12)
    got = fa_mod.flash_attention(q, k, v, causal=False)
    want = fa_mod.flash_attention_plain(q, k, v, causal=False)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), **TOL[dname])


@pytest.mark.cuda
@pytest.mark.parametrize("d,dv", [(48, 48), (256, 256), (64, 96), (24, 24),
                                  (96, 96)])
@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
def test_pair_outside_the_table_refused_on_card(d, dv, dname):
    """The kernels take only the pairs of KERNEL_DIMS: the kernel wrapper
    and the op refuse any other on the card, and launch nothing."""
    _on_card()
    q, k, v = _views(1, 2, 2, 8, 8, d, dv, getattr(torch, dname), "cuda")
    fn = fa_mod.flash_attention
    before = fn.launches
    for call in (fn, ops.flash_attention_op):
        with pytest.raises(ValueError, match="kernels'"):
            call(q, k, v)
    assert fn.launches == before


# Every (dtype, D, Dv) that runs the mma kernels, and shapes that take
# both of each kernel's block plans: the small ones split each block's
# walk four ways across its warps (fewer blocks of 64 than SMs), the last
# three run blocks of 64 rows and keys (B·H·ceil(S/64) and B·Hkv·ceil(S/64)
# at least the card's 132 SMs); the last is qwen3-0.6b's training shape,
# whose walks of 1024 rows and keys are the longest sums.
MMA_PAIRS = [("float32", d, d) for d in (8, 16, 32, 64, 128)] + [
    ("float32", 96, 64), ("float32", 24, 16), ("bfloat16", 8, 8),
    ("bfloat16", 24, 16)]
MMA_SHAPES = [(2, 4, 2, 77, 77, True, None), (1, 8, 2, 100, 100, True, 24),
              (1, 2, 2, 40, 70, False, None),
              (2, 16, 16, 300, 300, True, None),
              (2, 32, 16, 257, 257, False, None),
              (2, 16, 8, 1024, 1024, True, None)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,hkv,sq,sk,causal,window", MMA_SHAPES)
@pytest.mark.parametrize("dname,d,dv", MMA_PAIRS)
def test_mma_kernels_match_plain_on_card(dname, d, dv, b, h, hkv, sq, sk,
                                         causal, window):
    """The mma forward (output and lse) and backward against the plain
    versions on the card, at chip_smoke.py's tolerances (f32 ``TOL``,
    bf16 the prefill's and ``BWD_BF16_TOL``), each call counted as an mma
    launch, two backward calls bit-equal."""
    _on_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    dtype = getattr(torch, dname)
    cs = chip_smoke()
    q, k, v = _views(b, h, hkv, sq, sk, d, dv, dtype, "cuda", seed=15)
    do = torch.randn((b, sq, h, dv), generator=torch.Generator()
                     .manual_seed(16)).to(dtype).cuda().transpose(1, 2)
    fn = fa_mod.flash_attention
    names = ("launches_mma", "launches_bwd_mma", "launches_tc",
             "launches_bwd_tc")
    before = [getattr(fn, x) for x in names]
    out, lse = fa_mod.flash_attention_fwd(q, k, v, causal, window,
                                          with_lse=True)
    got = fa_mod.flash_attention_bwd(q, k, v, out, lse, do, causal, window)
    again = fa_mod.flash_attention_bwd(q, k, v, out, lse, do, causal, window)
    torch.cuda.synchronize()
    assert [getattr(fn, x) for x in names] == [before[0] + 1, before[1] + 2,
                                               before[2], before[3]]
    np.testing.assert_allclose(
        out.float().cpu().numpy(),
        fa_mod.flash_attention_plain(q, k, v, causal, window).float().cpu()
        .numpy(), **TOL[dname])
    np.testing.assert_allclose(
        lse.cpu().numpy(),
        fa_mod.flash_attention_lse_plain(q, k, causal, window).cpu().numpy(),
        **cs.LSE_TOL)
    want = fa_mod.flash_attention_bwd_plain(q, k, v, out, lse, do, causal,
                                            window)
    tol = cs.TOL["float32"] if dname == "float32" else cs.BWD_BF16_TOL
    for name, g, w, x, r in zip(("dq", "dk", "dv"), got, want, (q, k, v),
                                again):
        assert g.dtype == x.dtype and g.stride() == x.stride(), name
        assert torch.equal(g, r), name
        np.testing.assert_allclose(g.float().cpu().numpy(),
                                   w.float().cpu().numpy(), **tol,
                                   err_msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("d,dv", [(128, 128), (96, 64)])
def test_mma_long_f32_walks_match_plain_on_card(d, dv):
    """The f32 backward's longest sums, four times qwen3-0.6b's training
    length (dK and dV over 2 x 4096 query rows of a KV head, dQ over 4096
    keys), within ``TOL`` of the plain version: ``mma::accumulate``'s
    per-tile chunks, joined by f32 adds, keep the tensor core's biased
    adds from drifting (``tests/test_torch_flash_mma.py`` emulates both
    forms at S = 1024)."""
    test_mma_kernels_match_plain_on_card("float32", d, dv, 1, 16, 8, 4096,
                                         4096, True, None)
