"""The port's WKV recurrence (``repro_torch.kernels.rwkv6_wkv``) against
the JAX package's.

On the CPU ``ops.rwkv6_wkv_op`` runs the plain version (the CUDA
kernel cannot run here, and its wrapper takes CUDA tensors only); the
same numpy inputs go through the JAX package's Pallas
``rwkv6_wkv`` in interpret mode, as ``tests/test_kernels.py`` runs it,
and through its sequential oracle ``ref.rwkv6_wkv_ref``. The kernel
itself is held against the plain version on the card by the
``cuda``-marked test below and by ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jax_ops, ref
from repro.models.rwkv import _wkv_chunk
from repro_torch.kernels import ops, rwkv6_wkv as wkv_mod

torch.set_num_threads(2)

# Tolerances. f32: the plain version and the JAX oracle do the same
# sequential f32 recurrence and differ only in the order of the n-sum of
# each einsum (a few ulps of O(10) outputs); the JAX package's own f32
# atol is 3e-4 (tests/test_kernels.py:181), held here 10x tighter. bf16:
# the inputs are bf16 in both frameworks and all arithmetic is f32, so
# the outputs differ only where a few-ulp f32 difference straddles a bf16
# rounding boundary: one bf16 ulp, 2^-7 relative at most; the JAX
# package's bf16 tolerance (atol 8e-2, rtol 5e-2) covers it with room.
TOL = {"float32": dict(atol=3e-5, rtol=1e-5),
       "bfloat16": dict(atol=8e-2, rtol=5e-2)}
# r/k/v dtype and w dtype of each case: all f32; all bf16 (the JAX
# sweep's bf16 case); bf16 r/k/v with f32 w (the model's path).
CASES = {"float32": ("float32", "float32"),
         "bfloat16": ("bfloat16", "bfloat16"),
         "bfloat16-w-f32": ("bfloat16", "float32")}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}

# The JAX package's sweep (tests/test_kernels.py:165-168), (B, H, S, N,
# chunk), plus the reduced rwkv6-3b's head size 32 and the full model's 64.
SWEEP = [(1, 1, 16, 4, 8), (2, 3, 64, 8, 16), (1, 4, 32, 16, 8),
         (2, 2, 48, 8, 16), (1, 2, 32, 32, 16), (1, 2, 40, 64, 8)]


def _inputs(b, h, s, n, seed=0, w_lo=0.7, w_hi=0.999):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((b, h, s, n)).astype(np.float32)
               for _ in range(3))
    w = rng.uniform(w_lo, w_hi, (b, h, s, n)).astype(np.float32)
    u = rng.standard_normal((h, n)).astype(np.float32)
    return r, k, v, w, u


def _both(arrays, case):
    """The same numpy inputs as torch and jnp tensors: r, k, v in the
    case's dtype, w in its w dtype, u f32 (f32 -> bf16 rounds to nearest
    even in both frameworks)."""
    rdt, wdt = CASES[case]
    dts = (rdt, rdt, rdt, wdt, "float32")
    return ([torch.from_numpy(a).to(TORCH[d]) for a, d in zip(arrays, dts)],
            [jnp.asarray(a, JNP[d]) for a, d in zip(arrays, dts)])


def _close(got, want, dname):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **TOL[dname])


@pytest.mark.parametrize("b,h,s,n,chunk", SWEEP)
@pytest.mark.parametrize("case", list(CASES))
def test_sweep_matches_jax(b, h, s, n, chunk, case):
    (tr, tk, tv, tw, tu), (jr, jk, jv, jw, ju) = _both(
        _inputs(b, h, s, n), case)
    pallas = jax_ops.rwkv6_wkv_op(jr, jk, jv, jw, ju, chunk=chunk)
    oracle = ref.rwkv6_wkv_ref(jr, jk, jv, jw, ju)
    dname = CASES[case][0]
    for got in (ops.rwkv6_wkv_op(tr, tk, tv, tw, tu, chunk=chunk),
                wkv_mod.rwkv6_wkv_plain(tr, tk, tv, tw, tu)):
        assert got.dtype == tr.dtype and got.shape == tr.shape
        for want in (pallas, oracle):
            _close(got, want, dname)


def test_chunk_does_not_change_the_result():
    """``chunk`` is the TPU kernel's tiling; the port takes any S."""
    tr, tk, tv, tw, tu = (torch.from_numpy(a)
                          for a in _inputs(1, 2, 24, 8, seed=1))
    want = ops.rwkv6_wkv_op(tr, tk, tv, tw, tu)
    for chunk in (1, 5, 16, 64):
        assert torch.equal(ops.rwkv6_wkv_op(tr, tk, tv, tw, tu, chunk=chunk),
                           want)


def test_strided_views_match_contiguous():
    """The model passes (B, S, H, N) tensors as transposed views."""
    arrays = [torch.from_numpy(a) for a in _inputs(2, 3, 20, 16, seed=2)]
    views = [t.transpose(1, 2).contiguous().transpose(1, 2)
             for t in arrays[:4]]
    assert not views[0].is_contiguous() and views[0].stride(3) == 1
    np.testing.assert_array_equal(
        ops.rwkv6_wkv_op(*views, arrays[4]).numpy(),
        ops.rwkv6_wkv_op(*arrays).numpy())


def test_decay_zero_forgets_and_decay_one_sums():
    """w = 0 keeps only the last step: y_t = (r_t·k_{t-1}) v_{t-1} +
    (r_t·(u⊙k_t)) v_t; w = 1 keeps every past k v^T (no decay) — both
    checked against a direct sum."""
    r, k, v, _, u = (torch.from_numpy(a) for a in _inputs(1, 2, 12, 4, 3))
    zero = ops.rwkv6_wkv_op(r, k, v, torch.zeros_like(r), u)
    bonus = (r * u[None, :, None] * k).sum(-1, keepdim=True) * v
    last = torch.zeros_like(bonus)
    last[:, :, 1:] = (r[:, :, 1:] * k[:, :, :-1]).sum(-1, keepdim=True) \
        * v[:, :, :-1]
    torch.testing.assert_close(zero, last + bonus, atol=1e-5, rtol=1e-5)
    one = ops.rwkv6_wkv_op(r, k, v, torch.ones_like(r), u)
    scores = torch.einsum("bhtn,bhsn->bhts", r, k).tril(-1)
    want = torch.einsum("bhts,bhsm->bhtm", scores, v) + bonus
    torch.testing.assert_close(one, want, atol=1e-4, rtol=1e-5)


# The JAX model's WKV is the prefix-product chunked form `_wkv_chunk`
# (src/repro/models/rwkv.py:80), which clamps log P at -60 (:96-97, :113)
# and divides k by the clamped P. With w = 0.5 a chunk of 128 steps has
# log P down to 128 * log 0.5 = -88.7: past step ~86 the decay between
# steps is lost and the chunked form departs from the recurrence. The
# port computes the recurrence exactly, as the TPU kernel and
# ref.rwkv6_wkv_ref do (ROADMAP Queue C records the reference's fault).
CLAMP_SHAPE = (1, 2, 128, 16)


def _chunked(r, k, v, w, u):
    """The JAX model's chunked WKV over one chunk of the whole sequence,
    (B, H, S, N) in and out."""
    bhsn = lambda a: jnp.asarray(a).transpose(0, 2, 1, 3)  # noqa: E731
    b, h, _, n = r.shape
    y, _ = _wkv_chunk(jnp.zeros((b, h, n, n), jnp.float32), bhsn(r),
                      bhsn(k), bhsn(v), bhsn(w), jnp.asarray(u))
    return np.asarray(y).transpose(0, 2, 1, 3)


@pytest.mark.parametrize("decay", ["0.5", "uniform-0.7-0.999"])
def test_reference_chunked_form_clamps_where_port_is_exact(decay):
    r, k, v, w, u = _inputs(*CLAMP_SHAPE, seed=4)
    if decay == "0.5":
        w = np.full_like(w, 0.5)
    oracle = np.asarray(ref.rwkv6_wkv_ref(*(jnp.asarray(a)
                                            for a in (r, k, v, w, u))))
    got = ops.rwkv6_wkv_op(*(torch.from_numpy(a)
                             for a in (r, k, v, w, u))).numpy()
    np.testing.assert_allclose(got, oracle, **TOL["float32"])
    diff = np.abs(_chunked(r, k, v, w, u) - oracle)
    dev = float(diff.max())
    if decay == "0.5":
        # Measured: 87.4 against outputs that peak at |y| = 36.9; the
        # chunked form holds up to step 86 and departs from step 87 on,
        # where 87 * log 2 first passes the clamp at 60.
        assert dev > 10.0, dev
        assert float(diff[:, :, :86].max()) < 2e-4
        assert float(diff[:, :, 87].max()) > 1e-3
    else:
        # The JAX package's own chunked-vs-kernel bound
        # (tests/test_kernels.py:198).
        assert dev < 2e-4, dev


def test_cpu_path_launches_no_kernel():
    before = wkv_mod.rwkv6_wkv.launches
    ops.rwkv6_wkv_op(*(torch.from_numpy(a) for a in _inputs(1, 1, 8, 4)))
    assert wkv_mod.rwkv6_wkv.launches == before


def _t(*shape, dtype=torch.float32, device="cpu"):
    return torch.ones(shape, dtype=dtype, device=device)


def _good(dtype=torch.float32, w_dtype=None, device="cpu", n=8, s=6):
    x = [_t(1, 2, s, n, dtype=dtype, device=device) for _ in range(3)]
    return x + [_t(1, 2, s, n, dtype=w_dtype or dtype, device=device),
                _t(2, n, device=device)]


def _replace(i, t, **kw):
    args = _good(**kw)
    args[i] = t
    return args


BAD_INPUTS = [
    (_replace(0, _t(2, 6, 8)), ValueError),
    (_replace(4, _t(16)), ValueError),
    (_good(torch.float64), TypeError),
    (_good(torch.int32), TypeError),
    (_replace(1, _t(1, 2, 6, 8, dtype=torch.bfloat16)), TypeError),
    (_good(torch.float32, w_dtype=torch.bfloat16), TypeError),
    (_replace(4, _t(2, 8, dtype=torch.bfloat16), dtype=torch.bfloat16),
     TypeError),
    (_good(n=48), ValueError),
    (_good(n=128), ValueError),
    (_replace(0, _t(1, 2, 8, 6).transpose(2, 3)), ValueError),
    (_replace(3, _t(1, 2, 8, 6).transpose(2, 3)), ValueError),
    (_replace(2, _t(1, 2, 7, 8)), ValueError),
    (_replace(4, _t(3, 8)), ValueError),
    (_good(s=0), ValueError),
    # a meta call (the dry run's) that the kernel's checks refuse; good
    # meta calls: tests/test_torch_roofline.py
    (_good(n=48, device="meta"), ValueError),
]
BAD_IDS = ["rank-3", "u-rank-1", "f64", "int", "k-dtype-mix",
           "w-bf16-under-f32", "u-bf16", "N-48", "N-128",
           "r-N-stride-not-1", "w-N-stride-not-1", "v-shape-mismatch",
           "u-shape-mismatch", "S-0", "meta-device"]


@pytest.mark.parametrize("args,exc", BAD_INPUTS, ids=BAD_IDS)
def test_wrapper_rejects_bad_inputs(args, exc):
    with pytest.raises(exc):
        wkv_mod.rwkv6_wkv(*args)


@pytest.mark.parametrize("args,exc", BAD_INPUTS, ids=BAD_IDS)
def test_op_rejects_bad_inputs(args, exc):
    """The CPU path refuses what the kernel would refuse."""
    with pytest.raises(exc):
        ops.rwkv6_wkv_op(*args)


def test_kernel_wrapper_refuses_cpu_tensors():
    """The kernel wrapper takes CUDA tensors only: the choice of the plain
    version is made in ops.rwkv6_wkv_op alone."""
    before = wkv_mod.rwkv6_wkv.launches
    with pytest.raises(ValueError, match="CUDA"):
        wkv_mod.rwkv6_wkv(*_good())
    assert wkv_mod.rwkv6_wkv.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("decay", ["uniform", "zero", "one"])
@pytest.mark.parametrize("b,h,s,n,chunk", SWEEP + [(2, 40, 300, 64, 64)])
@pytest.mark.parametrize("case", list(CASES))
def test_kernel_matches_plain_on_card(b, h, s, n, chunk, case, decay):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the rwkv6_wkv kernel is CUDA C++ "
                    "and has no CPU or interpreter mode")
    rdt, wdt = CASES[case]
    dts = (rdt, rdt, rdt, wdt)
    r, k, v, w, u = _inputs(b, h, s, n, seed=11)
    if decay != "uniform":
        w = np.full_like(w, 0.0 if decay == "zero" else 1.0)
    # (B, S, H, N) storage, passed as (B, H, S, N) views, as the model does
    views = [torch.from_numpy(a).to(TORCH[d]).cuda().transpose(1, 2)
             .contiguous().transpose(1, 2) for a, d in zip((r, k, v, w), dts)]
    tu = torch.from_numpy(u).cuda()
    before = wkv_mod.rwkv6_wkv.launches
    got = wkv_mod.rwkv6_wkv(*views, tu)
    torch.cuda.synchronize()
    assert wkv_mod.rwkv6_wkv.launches == before + 1
    assert got.transpose(1, 2).is_contiguous() and got.dtype == views[0].dtype
    want = wkv_mod.rwkv6_wkv_plain(*views, tu)
    # w = 1 over 300 steps keeps every kv: outputs of O(100), whose f32
    # rounding is of the prefill shape's kind (chip_smoke.WKV_PREFILL_TOL).
    tol = (dict(atol=2e-3, rtol=1e-4) if decay == "one" and s == 300
           and rdt == "float32" else TOL[rdt])
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), **tol)


def _unaddressable(a, dtype, kind):
    """(B, H, S, N) numpy array ``a`` as a view the kernel's tile copies
    cannot address: its base one element past an allocation's start
    ("offset"), or rows N + 1 elements apart ("odd-stride")."""
    bb, hh, ss, nn = a.shape
    if kind == "offset":
        flat = torch.zeros(a.size + 1, dtype=dtype)
        flat[1:] = torch.from_numpy(a.reshape(-1)).to(dtype)
        return flat.cuda()[1:].view(a.shape)
    wide = torch.zeros(bb, hh, ss, nn + 1, dtype=dtype)
    wide[..., :nn] = torch.from_numpy(a).to(dtype)
    return wide.cuda()[..., :nn]


@pytest.mark.parametrize("dtype,n,bshn", [
    (torch.float32, 64, False), (torch.float32, 64, True),
    (torch.float32, 4, True), (torch.bfloat16, 8, True),
    (torch.bfloat16, 4, False), (torch.bfloat16, 4, True),
], ids=["f32-n64-dense", "f32-n64-bshn", "f32-n4-bshn", "bf16-n8-bshn",
        "bf16-n4-dense", "bf16-n4-bshn"])
def test_addressable_dense_and_transposed_views(dtype, n, bshn):
    """Dense tensors and the model's (B, S, H, N) storage viewed as
    (B, H, S, N) go to the kernel as they are: base and strides are
    multiples of 16 bytes (8 for N = 4 in bf16)."""
    t = torch.zeros(2, 3, 5, n, dtype=dtype)
    if bshn:
        t = t.transpose(1, 2).contiguous().transpose(1, 2)
    assert wkv_mod.addressable(t, n)


@pytest.mark.parametrize("dtype,n,offset,row,ok", [
    (torch.float32, 64, 1, 64, False),      # base 4 bytes off
    (torch.float32, 64, 4, 64, True),       # base 16 bytes off
    (torch.float32, 64, 0, 65, False),      # rows 260 bytes apart
    (torch.bfloat16, 64, 4, 64, False),     # base 8 bytes off
    (torch.bfloat16, 64, 0, 72, True),      # rows 144 bytes apart
    (torch.bfloat16, 4, 4, 4, True),        # N = 4 bf16: 8-byte granule
    (torch.bfloat16, 4, 2, 4, False),
    (torch.bfloat16, 4, 0, 5, False),
    (torch.float32, 4, 0, 6, False),        # f32 N = 4 is a TMA box: 16
])
def test_addressable_offsets_and_strides(dtype, n, offset, row, ok):
    """A base or a row stride off the copies' granule sends the view
    through a dense copy in the wrapper."""
    flat = torch.zeros(offset + 2 * 3 * 5 * row, dtype=dtype)
    t = flat[offset:].view(2, 3, 5, row)[..., :n]
    assert wkv_mod.addressable(t, n) is ok


def test_addressable_ignores_axes_of_one_and_refuses_broadcasts():
    """The stride of an axis of extent 1 is never followed; a broadcast
    (stride 0) axis is not a view the copies can address."""
    assert wkv_mod.addressable(torch.zeros(1, 1, 1, 67)[..., :64], 64)
    assert not wkv_mod.addressable(torch.zeros(2, 3, 1, 67)[..., :64], 64)
    base = torch.zeros(1, 3, 5, 64)
    assert not wkv_mod.addressable(base.expand(2, 3, 5, 64), 64)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["offset", "odd-stride"])
@pytest.mark.parametrize("n", [4, 64])
@pytest.mark.parametrize("case", list(CASES))
def test_unaddressable_views_match_plain_on_card(case, n, kind):
    """Views the kernel's copies cannot address are copied by the
    wrapper (one copy each) and fold to the plain result; the aligned
    transposed views of the other card test take no copy."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the rwkv6_wkv kernel is CUDA C++ "
                    "and has no CPU or interpreter mode")
    rdt, wdt = CASES[case]
    r, k, v, w, u = _inputs(2, 3, 37, n, seed=13)
    views = [_unaddressable(a, TORCH[d], kind)
             for a, d in zip((r, k, v, w), (rdt, rdt, rdt, wdt))]
    tu = torch.from_numpy(u).cuda()
    copies = wkv_mod.rwkv6_wkv.copies
    got = wkv_mod.rwkv6_wkv(*views, tu)
    torch.cuda.synchronize()
    assert wkv_mod.rwkv6_wkv.copies == copies + 4
    want = wkv_mod.rwkv6_wkv_plain(*views, tu)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), **TOL[rdt])
    dense = [t.transpose(1, 2).contiguous().transpose(1, 2) for t in views]
    copies = wkv_mod.rwkv6_wkv.copies
    torch.testing.assert_close(wkv_mod.rwkv6_wkv(*dense, tu), got,
                               atol=0, rtol=0)
    assert wkv_mod.rwkv6_wkv.copies == copies


@pytest.mark.cuda
@pytest.mark.parametrize("n", [4, 8, 16, 32, 64])
def test_decay_zero_forgets_and_decay_one_sums_on_card(n):
    """The closed forms of test_decay_zero_forgets_and_decay_one_sums,
    through the kernel: w = 0 keeps only the step before, w = 1 every
    step, exactly as far as f32 sums go."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the rwkv6_wkv kernel is CUDA C++ "
                    "and has no CPU or interpreter mode")
    r, k, v, _, u = (torch.from_numpy(a).cuda()
                     for a in _inputs(1, 2, 12, n, 3))
    bonus = (r * u[None, :, None] * k).sum(-1, keepdim=True) * v
    zero = wkv_mod.rwkv6_wkv(r, k, v, torch.zeros_like(r), u)
    last = torch.zeros_like(bonus)
    last[:, :, 1:] = (r[:, :, 1:] * k[:, :, :-1]).sum(-1, keepdim=True) \
        * v[:, :, :-1]
    torch.testing.assert_close(zero, last + bonus, atol=1e-5, rtol=1e-5)
    one = wkv_mod.rwkv6_wkv(r, k, v, torch.ones_like(r), u)
    scores = torch.einsum("bhtn,bhsn->bhts", r, k).tril(-1)
    want = torch.einsum("bhts,bhsm->bhtm", scores, v) + bonus
    torch.testing.assert_close(one, want, atol=1e-4, rtol=1e-5)


# --- The kernel's arithmetic order, emulated on the CPU -------------------
#
# The CUDA kernel cannot run here, so its order of operations is emulated
# in torch (layout from ``kernel_layout``, a mirror of the kernel's): the
# bonus scalar c_t = Σ r u k summed once per step by P lanes (each over
# KP keys in rotated pairs, then added by xor shuffles); each
# state entry updated as S = fma(w, S, k·v); the partial y of each key
# group g (keys n = 4 (g + G jj) + e, in jj-then-e order, one FMA each)
# added over the G lanes highest lane bit first; y = fma(c_t, v, Σ).
# fma(a, b, c) is computed in f64 and rounded once to f32 (the product of
# two f32 is exact in f64).

TILE = 16          # steps staged per pass (kTile in csrc/rwkv6_wkv.cu)


def kernel_layout(n: int) -> dict:
    """The kernel's thread layout at head size ``n``, a mirror of
    ``Layout`` in ``csrc/rwkv6_wkv.cu``: each thread holds ``kpt`` keys x
    ``cpt`` value columns of the state; ``g`` lanes share a column group
    and add their partial y; a block holds ``cb`` columns; ``p`` lanes of
    ``kp`` keys each sum the bonus scalar c_t of a step."""
    kpt = 4 if n == 64 else min(n, 8)
    cpt = 4
    g = n // kpt
    cb = 32 if n >= 32 else n
    threads = cb // cpt * g
    p = threads // TILE if threads > TILE else 1
    return dict(kpt=kpt, cpt=cpt, g=g, cb=cb, threads=threads, p=p,
                kp=n // p)


def _fma(a, b, c):
    return (a.double() * b.double() + c.double()).float()


def _lane_tree(parts: list, low_first: bool):
    """Sum the lanes' values as xor shuffles do: pairs across one lane bit
    per level, the lowest bit first (c_t) or the highest first (y)."""
    vals = list(parts)
    n = len(vals)
    bits = [1 << i for i in range(n.bit_length() - 1)]
    for bit in (bits if low_first else bits[::-1]):
        vals = [vals[i] + vals[i ^ bit] if not i & bit else vals[i ^ bit]
                + vals[i] for i in range(n)]
    return vals[0]


def _emulate_kernel(r, k, v, w, u):
    """The kernel's arithmetic on (B, H, S, N) inputs (any float dtype,
    taken to f32) -> y in r's dtype."""
    b, h, s, n = r.shape
    lay = kernel_layout(n)
    g_n, p_n, kp = lay["g"], lay["p"], lay["kp"]
    rf, kf, vf, wf = (a.float() for a in (r, k, v, w))
    uf = u.float()[None]                                   # (1, H, N)
    state = torch.zeros(b, h, n, n)
    groups = [[4 * (g + g_n * jj) + e for jj in range(n // g_n // 4)
               for e in range(4)] for g in range(g_n)]
    h2 = kp // 2
    ys = []
    for t in range(s):
        j = t % TILE
        cparts = []
        for p in range(p_n):
            cp = torch.zeros(b, h)
            for i in range(h2):
                x = (i + j + (p >> 1)) & (h2 - 1)
                for nn in (p * kp + 2 * x, p * kp + 2 * x + 1):
                    cp = _fma(rf[:, :, t, nn] * uf[:, :, nn], kf[:, :, t, nn],
                              cp)
            cparts.append(cp)
        c = _lane_tree(cparts, low_first=True)
        kv = kf[:, :, t, :, None] * vf[:, :, t, None, :]    # f32 products
        yparts = []
        for keys in groups:
            acc = torch.zeros(b, h, n)
            for nn in keys:
                acc = _fma(rf[:, :, t, nn, None], state[:, :, nn], acc)
            yparts.append(acc)
        ysum = _lane_tree(yparts, low_first=False)
        ys.append(_fma(c[..., None], vf[:, :, t], ysum))
        state = _fma(wf[:, :, t, :, None], state, kv)
    return torch.stack(ys, dim=2).to(r.dtype)


def test_lane_tree_orders():
    """The two shuffle orders on four lanes: low bit first is (0+1)+(2+3),
    high bit first (0+2)+(1+3)."""
    a, b_, c, d = (torch.tensor([x], dtype=torch.float32)
                   for x in (1e8, 1.0, -1e8, 1.0))
    assert float(_lane_tree([a, b_, c, d], low_first=True)) == \
        float((a + b_) + (c + d))
    assert float(_lane_tree([a, b_, c, d], low_first=False)) == \
        float((a + c) + (b_ + d))


@pytest.mark.parametrize("b,h,s,n,chunk", SWEEP)
def test_kernel_arithmetic_matches_jax(b, h, s, n, chunk):
    """The kernel's order of operations, emulated in f32, against the JAX
    Pallas kernel (interpret mode) and its oracle at the f32 sweep
    tolerance."""
    (tr, tk, tv, tw, tu), (jr, jk, jv, jw, ju) = _both(
        _inputs(b, h, s, n, seed=6), "float32")
    got = _emulate_kernel(tr, tk, tv, tw, tu)
    _close(got, jax_ops.rwkv6_wkv_op(jr, jk, jv, jw, ju, chunk=chunk),
           "float32")
    _close(got, ref.rwkv6_wkv_ref(jr, jk, jv, jw, ju), "float32")


# Long runs at constant decays: w = 0.5 (past the reference chunked form's
# clamp), w = 1e-30 (the state's old terms far below f32's normal range)
# and w = 1 (every kv kept), 300 steps (19 staged tiles, the last ragged).
@pytest.mark.parametrize("decay", [0.5, 1e-30, 1.0])
@pytest.mark.parametrize("n", [16, 64])
def test_kernel_arithmetic_at_constant_decay(decay, n):
    r, k, v, w, u = _inputs(1, 2, 300, n, seed=8)
    w = np.full_like(w, decay)
    t = [torch.from_numpy(a) for a in (r, k, v, w, u)]
    got = _emulate_kernel(*t)
    assert torch.isfinite(got).all()
    oracle = np.asarray(ref.rwkv6_wkv_ref(*(jnp.asarray(a)
                                            for a in (r, k, v, w, u))))
    plain = wkv_mod.rwkv6_wkv_plain(*t).numpy()
    # w = 1 keeps 300 steps of kv: outputs of O(100) carry rounding of that
    # size, as the prefill shape's do (chip_smoke.WKV_PREFILL_TOL's f32).
    tol = (dict(atol=2e-3, rtol=1e-4) if decay == 1.0
           else TOL["float32"])
    for want in (oracle, plain):
        np.testing.assert_allclose(got.numpy(), want, **tol)
    if decay == 1e-30:
        # Only the step just before survives: y_t = (r_t·k_{t-1}) v_{t-1}
        # + (r_t·(u⊙k_t)) v_t up to 1e-30 of older terms.
        bonus = (t[0] * t[4][None, :, None] * t[1]).sum(-1, keepdim=True) \
            * t[2]
        last = torch.zeros_like(bonus)
        last[:, :, 1:] = (t[0][:, :, 1:] * t[1][:, :, :-1]).sum(
            -1, keepdim=True) * t[2][:, :, :-1]
        torch.testing.assert_close(got, last + bonus, atol=1e-5, rtol=1e-5)
