"""The flash backward at the split head-dim pairs (``repro_torch.kernels
.flash_attention``): MLA's (96, 64), minicpm3-4b's q·k and v widths, and
the reduced MLA's (24, 16).

On the CPU the same numpy inputs and output cotangent go through
``jax.vjp`` of the JAX package's dense oracle ``ref.flash_attention_ref``
(which takes Dv != D and scales by q's width) and through the port's
plain backward (``flash_attention_bwd_plain``), the plain forward's
autograd (the CPU training path) and ``FlashAttentionFn``'s wiring with
its launchers replaced by the plain versions, at GQA groups 1 and 2,
causal and not, a window and Sq != Sk, f32 ``atol=2e-5, rtol=1e-4``
(sums over up to 70 keys or rows in other orders on the two sides).
``chip_smoke.py``'s planted faults of the split kernels (dQ's and dK's
last column group dropped, Δ summed over D columns of o and dO instead
of Dv, q's or k's tail columns dropped: 64-95 at D = 96, a tile's third
32-column chunk) are shown to break the tolerances the card's tests hold
the kernels to. The ``cuda``-marked tests hold the kernels to the plain
version on the card: f32 on the mma.sync kernels, bf16 at (96, 64) on
the wgmma ones and at (24, 16) on mma.sync, each call's variant and split
count checked, two calls bit-equal.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa_mod, ops

from _torch_flash import chip_smoke, plain_launchers
from test_torch_flash_backward import F32, _assert_grads, _bshd, _jax_grads

torch.set_num_threads(2)

# (B, H, Hkv, Sq, Sk, D, Dv, causal, window)
CASES = [
    (1, 2, 2, 20, 20, 96, 64, True, None),
    (2, 4, 2, 33, 33, 96, 64, False, 7),
    (1, 4, 2, 20, 37, 96, 64, False, None),
    (1, 2, 1, 37, 20, 96, 64, True, None),
    (2, 4, 4, 40, 40, 24, 16, True, None),
    (1, 4, 2, 33, 33, 24, 16, True, 5),
    (1, 2, 1, 24, 70, 24, 16, False, None),
    (1, 4, 4, 70, 24, 24, 16, False, 50),
]
IDS = [f"D{d}Dv{dv}G{h // hkv}Sq{sq}Sk{sk}{'c' if c else 'n'}w{w}"
       for b, h, hkv, sq, sk, d, dv, c, w in CASES]


def _inputs(b, h, hkv, sq, sk, d, dv, seed=0):
    """q, k, v and the output cotangent dO, f32 numpy."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, h, sq, d)).astype(np.float32),
            rng.standard_normal((b, hkv, sk, d)).astype(np.float32),
            rng.standard_normal((b, hkv, sk, dv)).astype(np.float32),
            rng.standard_normal((b, h, sq, dv)).astype(np.float32))


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_split_bwd_plain_matches_jax_grad(case):
    b, h, hkv, sq, sk, d, dv, causal, window = case
    q, k, v, do = _inputs(b, h, hkv, sq, sk, d, dv)
    want, _ = _jax_grads(q, k, v, do, causal, window)
    tq, tk, tv, tdo = (_bshd(a) for a in (q, k, v, do))
    o = fa_mod.flash_attention_plain(tq, tk, tv, causal, window)
    lse = fa_mod.flash_attention_lse_plain(tq, tk, causal, window)
    got = fa_mod.flash_attention_bwd_plain(tq, tk, tv, o, lse, tdo, causal,
                                           window)
    _assert_grads([g.numpy() for g in got], want)
    # chip_smoke.py's dense copy without a fault is the plain backward.
    same = chip_smoke().dense_bwd(torch, tq, tk, tv, o, lse, tdo,
                                  causal=causal, window=window)
    for g, w in zip(same, got):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-6,
                                   rtol=1e-6)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_split_plain_autograd_matches_jax_grad(case):
    """The CPU training path at a split pair: ``ops.flash_attention_op``
    on CPU tensors is the plain version, differentiated by autograd."""
    b, h, hkv, sq, sk, d, dv, causal, window = case
    q, k, v, do = _inputs(b, h, hkv, sq, sk, d, dv, seed=1)
    want, want_out = _jax_grads(q, k, v, do, causal, window)
    args = [_bshd(a).requires_grad_() for a in (q, k, v)]
    out = ops.flash_attention_op(*args, causal=causal, window=window)
    np.testing.assert_allclose(out.detach().numpy(), want_out, **F32)
    got = torch.autograd.grad(out, args, _bshd(do))
    _assert_grads([g.numpy() for g in got], want)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_split_flash_attention_fn_wiring(case, monkeypatch):
    """Under grad a split pair builds a ``FlashAttentionFn`` node (no
    refusal): the forward launcher asked for lse, the backward launcher
    called once with o and dO Dv wide (its input check passes), gradients
    against ``jax.grad`` of the oracle."""
    b, h, hkv, sq, sk, d, dv, causal, window = case
    calls = plain_launchers(monkeypatch)
    q, k, v, do = _inputs(b, h, hkv, sq, sk, d, dv, seed=3)
    args = [_bshd(a).requires_grad_() for a in (q, k, v)]
    out = fa_mod.flash_attention(*args, causal=causal, window=window)
    assert "FlashAttentionFn" in type(out.grad_fn).__name__
    assert out.shape == (b, h, sq, dv)
    got = torch.autograd.grad(out, args, _bshd(do))
    assert calls == [("fwd", True), ("bwd", causal, window)]
    want, _ = _jax_grads(q, k, v, do, causal, window)
    _assert_grads([g.numpy() for g in got], want)


@pytest.mark.parametrize("what", ["o_as_q", "do_as_q", "do_dv_short"])
def test_split_bwd_checks_o_and_do_widths(what):
    """o and dO are Dv wide: the backward's input check refuses them at
    q's width (or any other)."""
    q, k, v, do = (torch.from_numpy(a)
                   for a in _inputs(1, 2, 2, 8, 8, 96, 64))
    o = fa_mod.flash_attention_plain(q, k, v)
    lse = fa_mod.flash_attention_lse_plain(q, k)
    fa_mod.check_bwd_inputs(q, k, v, o, lse, do, None)
    if what == "o_as_q":
        o = torch.zeros_like(q)
    elif what == "do_as_q":
        do = torch.zeros_like(q)
    else:
        do = do[..., :32]
    with pytest.raises(ValueError, match="flash_attention_bwd"):
        fa_mod.check_bwd_inputs(q, k, v, o, lse, do, None)


def _fault_case(d, dv, dtype, seed=8):
    """A causal split-pair case in the model's layout, o and lse from the
    plain forward."""
    q, k, v, do = (_bshd(a).to(dtype)
                   for a in _inputs(1, 4, 4, 96, 96, d, dv, seed=seed))
    o = fa_mod.flash_attention_plain(q, k, v)
    lse = fa_mod.flash_attention_lse_plain(q, k)
    return q, k, v, o, lse, do


@pytest.mark.parametrize("fault", ["last column group dropped",
                                   "delta over D", "q tail columns dropped",
                                   "k tail columns dropped"])
@pytest.mark.parametrize("d,dv", [(96, 64), (24, 16)])
@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
def test_split_planted_faults_break_the_tolerance(fault, d, dv, dname):
    """Each planted fault of the split kernels moves some gradient past
    the tolerance the card's tests hold the kernels to (f32: the kernel
    sweep's; bf16: ``BWD_BF16_TOL``)."""
    cs = chip_smoke()
    tol = cs.TOL["float32"] if dname == "float32" else cs.BWD_BF16_TOL
    args = _fault_case(d, dv, getattr(torch, dname))
    want = fa_mod.flash_attention_bwd_plain(*args)
    bad = cs.dense_bwd(torch, *args, fault)
    assert any(not torch.allclose(g.float(), w.float(), **tol)
               for g, w in zip(bad, want))


@pytest.mark.parametrize("d,start", [(96, 64), (24, 16), (128, 64)])
def test_tail_faults_drop_q_or_k_from_tail_start(d, start):
    """The tail faults are the plain backward on q or k with its columns
    from ``tail_start(D)`` zeroed (at D = 96 the tensor-core kernels'
    third 32-column chunk)."""
    cs = chip_smoke()
    assert cs.tail_start(d) == start
    dv = 64 if d == 96 else 16 if d == 24 else d
    q, k, v, o, lse, do = _fault_case(d, dv, torch.float32)
    for name in ("q", "k"):
        bad = cs.dense_bwd(torch, q, k, v, o, lse, do,
                           f"{name} tail columns dropped")
        cut = (q if name == "q" else k).clone()
        cut[..., start:] = 0
        args = (cut, k) if name == "q" else (q, cut)
        want = cs.dense_bwd(torch, *args, v, o, lse, do)
        for x, w in zip(bad, want):
            assert torch.equal(x, w)


def test_read_past_reads_the_following_memory():
    """The "delta over D" fault reads each Dv-wide row D wide, the extra
    columns from the memory after it: the next head's row in the model's
    (B, S, H, Dv) layout, zeros past the storage's end."""
    x = torch.arange(2 * 3 * 4, dtype=torch.float32).view(1, 3, 2, 4)
    xv = x.transpose(1, 2)                       # (1, 2, 3, 4) view
    wide = chip_smoke()._read_past(torch, xv, 6)
    assert wide.shape == (1, 2, 3, 6)
    assert torch.equal(wide[..., :4], xv)
    assert wide[0, 0, 0, 4:].tolist() == [4.0, 5.0]      # head 1, s 0
    assert wide[0, 1, 2, 4:].tolist() == [0.0, 0.0]      # past the end


# ---------------------------------------------------------- on the card
def _on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the flash_attention kernels are "
                    "CUDA C++ and have no CPU or interpreter mode")


# chip_smoke.py's phase 23 sweep of the split pairs.
CARD_CASES = chip_smoke().FLASH_BWD_SPLIT_SWEEP
CARD_IDS = [f"D{d}Dv{dv}B{b}H{h}G{h // hkv}Sq{sq}Sk{sk}"
            f"{'c' if c else 'n'}w{w}"
            for b, h, hkv, sq, sk, d, dv, c, w in CARD_CASES]


def _card_tol(dname):
    cs = chip_smoke()
    return cs.TOL["float32"] if dname == "float32" else cs.BWD_BF16_TOL


def _card_inputs(b, h, hkv, sq, sk, d, dv, dt, causal, window, seed=4):
    q, k, v, do = (_bshd(a).to(dt).cuda() for a in _inputs(
        b, h, hkv, sq, sk, d, dv, seed=seed))
    out, lse = fa_mod.flash_attention_fwd(q, k, v, causal, window,
                                          with_lse=True)
    return q, k, v, out, lse, do


@pytest.mark.cuda
@pytest.mark.parametrize("case", CARD_CASES, ids=CARD_IDS)
@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
def test_split_bwd_kernel_matches_plain_on_card(case, dname):
    """Both pairs in f32 and bf16 against the plain backward, the model's
    transposed views, ragged Sq and Sk, windows, Sq != Sk; the variant
    (bf16 (96, 64) on the wgmma kernels, the rest mma) and the split
    count checked; gradients laid out like their inputs; then the planted
    faults break the same tolerance on the same inputs."""
    _on_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    b, h, hkv, sq, sk, d, dv, causal, window = case
    dt = getattr(torch, dname)
    q, k, v, out, lse, do = _card_inputs(b, h, hkv, sq, sk, d, dv, dt,
                                         causal, window)
    fn = fa_mod.flash_attention
    names = ("launches_bwd", "launches_bwd_tc", "launches_bwd_mma",
             "launches_bwd_split")
    before = [getattr(fn, x) for x in names]
    got = fa_mod.flash_attention_bwd(q, k, v, out, lse, do, causal, window)
    torch.cuda.synchronize()
    tc = dname == "bfloat16" and d == 96
    assert fa_mod.kernel_variant(dt, d) == ("tc" if tc else "mma")
    assert [getattr(fn, x) for x in names] == [
        before[0] + 1, before[1] + tc, before[2] + (not tc), before[3] + 1]
    want = fa_mod.flash_attention_bwd_plain(q, k, v, out, lse, do, causal,
                                            window)
    tol = _card_tol(dname)
    for g, w, t in zip(got, want, (q, k, v)):
        assert g.dtype == t.dtype and g.stride() == t.stride()
        np.testing.assert_allclose(g.float().cpu().numpy(),
                                   w.float().cpu().numpy(), **tol)
    for fault in chip_smoke().SPLIT_BWD_FAULTS:
        bad = chip_smoke().dense_bwd(torch, q, k, v, out, lse, do, fault,
                                     causal=causal, window=window)
        assert any(not torch.allclose(x.float(), w.float(), **tol)
                   for x, w in zip(bad, want)), fault


@pytest.mark.cuda
@pytest.mark.parametrize("d,dv", [(96, 64), (24, 16)])
@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
def test_split_bwd_is_deterministic_and_autograd_bit_equal(d, dv, dname):
    """Two calls give bit-equal gradients (one writer per element), and
    autograd through ``FlashAttentionFn`` runs the same kernels: its
    gradients equal the direct call's bit for bit."""
    _on_card()
    dt = getattr(torch, dname)
    q, k, v, out, lse, do = _card_inputs(2, 8, 8, 300, 300, d, dv, dt,
                                         True, None, seed=6)
    first = fa_mod.flash_attention_bwd(q, k, v, out, lse, do)
    again = fa_mod.flash_attention_bwd(q, k, v, out, lse, do)
    assert all(torch.equal(a, b) for a, b in zip(again, first))
    args = [x.detach().requires_grad_() for x in (q, k, v)]
    auto = torch.autograd.grad(fa_mod.flash_attention(*args), args, do)
    assert all(torch.equal(a, b) for a, b in zip(auto, first))


@pytest.mark.cuda
def test_split_tail_heavy_columns_on_card():
    """(96, 64) in bf16 with q's and k's largest values in columns 64-95
    (``chip_smoke.FLASH_TAIL_CASE`` and ``tail_heavy``: the tensor-core
    kernels' third 32-column chunk carries most of q·k): the forward and
    the backward on the
    tensor cores hold the plain versions to ``PREFILL_BF16_TOL`` /
    ``BWD_BF16_TOL``, and dropping that chunk of q or of k breaks the
    backward's."""
    _on_card()
    cs = chip_smoke()
    sh = cs.FLASH_TAIL_CASE
    q, k, v, do = _inputs(sh["b"], sh["h"], sh["hkv"], sh["sq"], sh["sk"],
                          sh["d"], sh["dv"], seed=9)
    q, k = (cs.tail_heavy(x) for x in (q, k))
    q, k, v, do = (_bshd(a).to(torch.bfloat16).cuda() for a in (q, k, v, do))
    fn = fa_mod.flash_attention
    before = (fn.launches_tc, fn.launches_bwd_tc)
    out, lse = fa_mod.flash_attention_fwd(q, k, v, with_lse=True)
    got = fa_mod.flash_attention_bwd(q, k, v, out, lse, do)
    torch.cuda.synchronize()
    assert (fn.launches_tc, fn.launches_bwd_tc) == (before[0] + 1,
                                                    before[1] + 1)
    np.testing.assert_allclose(
        out.float().cpu().numpy(),
        fa_mod.flash_attention_plain(q, k, v).float().cpu().numpy(),
        **cs.PREFILL_BF16_TOL)
    want = fa_mod.flash_attention_bwd_plain(q, k, v, out, lse, do)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.float().cpu().numpy(),
                                   w.float().cpu().numpy(),
                                   **cs.BWD_BF16_TOL)
    for fault in ("q tail columns dropped", "k tail columns dropped"):
        bad = cs.dense_bwd(torch, q, k, v, out, lse, do, fault)
        assert any(not torch.allclose(x.float(), w.float(),
                                      **cs.BWD_BF16_TOL)
                   for x, w in zip(bad, want)), fault


@pytest.mark.cuda
def test_split_misaligned_bf16_views_run_bwd_on_tensor_cores():
    """(96, 64) views TMA cannot address (an odd element offset): the
    wrapper copies them, and the call still runs the tensor-core
    kernels."""
    _on_card()
    b, h, s, d, dv = 2, 4, 100, 96, 64
    rng = np.random.default_rng(13)
    n = b * s * h * (2 * d + dv)
    flat = torch.from_numpy(rng.standard_normal(n + 1).astype(
        np.float32)).to(torch.bfloat16).cuda()
    qkv = flat[1:].view(b, s, h, 2 * d + dv).transpose(1, 2)
    q, k, v = qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d:]
    dflat = torch.from_numpy(rng.standard_normal(b * s * h * dv + 1).astype(
        np.float32)).to(torch.bfloat16).cuda()
    do = dflat[1:].view(b, s, h, dv).transpose(1, 2)
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
                                   **_card_tol("bfloat16"))


@pytest.mark.cuda
@pytest.mark.parametrize("case", [c for c in CASES if c[5] == 24] + CASES[:2],
                         ids=[i for c, i in zip(CASES, IDS) if c[5] == 24]
                         + IDS[:2])
def test_split_autograd_on_card_matches_jax_grad(case):
    """The wrapper under grad on the card (forward kernel with lse, then
    the backward kernels), f32, against ``jax.grad`` of the oracle."""
    _on_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    b, h, hkv, sq, sk, d, dv, causal, window = case
    q, k, v, do = _inputs(b, h, hkv, sq, sk, d, dv, seed=5)
    args = [_bshd(a).cuda().requires_grad_() for a in (q, k, v)]
    fn = fa_mod.flash_attention
    n = (fn.launches_split, fn.launches_bwd_split)
    got = torch.autograd.grad(ops.flash_attention_op(*args, causal=causal,
                                                     window=window),
                              args, _bshd(do).cuda())
    torch.cuda.synchronize()
    assert (fn.launches_split, fn.launches_bwd_split) == (n[0] + 1, n[1] + 1)
    want, _ = _jax_grads(q, k, v, do, causal, window)
    _assert_grads([g.cpu().numpy() for g in got], want,
                  chip_smoke().TOL["float32"])
