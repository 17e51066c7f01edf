"""The backward of the port's WKV recurrence
(``repro_torch.kernels.rwkv6_wkv``: ``rwkv6_wkv_bwd``, its plain version,
``RwkvWkvFn``) against ``jax.vjp`` of the JAX package's oracle
``ref.rwkv6_wkv_ref``.

The JAX package has no backward kernel: it trains through autodiff of
its jnp mixer. So the same numpy inputs and output cotangent go through
``jax.vjp`` of the oracle (on JAX's CPU device) and through the port's
plain backward (the kernel's reverse recurrence: the adjoint
G_{t-1} = diag(w_t) G_t + r_t dy_tᵀ, dw_t = Σ_m G_t ⊙ S_{t-1}) and the
plain forward's autograd (the CPU training path).

Tolerances. f32 (``F32``): both sides are f32 sums of the same terms in
other orders; the gradients, up to ~180 in size, are sums over up to 40
steps of N-term products, a few ulps apart (measured here: at most
3.8e-5 absolute). bf16 (r, k, v, dy and dr, dk, dv bf16; w and dw f32 or bf16):
both sides compute in f32 and round once to bf16, so they differ by at
most one bf16 ulp where their f32 values straddle a rounding boundary:
``BF16`` allows two ulps relative, and an absolute floor for values that
cancel to near 0. The kernel itself runs only on the card: the
``cuda``-marked tests hold it to the plain version there, and on the CPU
``RwkvWkvFn``'s wiring is checked with its launchers replaced by the
plain versions.

The backward reads checkpoints that the forward kernel stores under grad
(the state before every ``CKPT_STEPS`` = 16 steps, and c_t): their plain
versions (``rwkv6_wkv_ckpt_plain``, and ``rwkv6_wkv_bwd_ckpt_plain``,
the kernel's interval-by-interval rebuild) are held here against a numpy
state loop and against ``jax.vjp`` over lengths around the interval.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro_torch.kernels import ops, rwkv6_wkv as wkv_mod

from _torch_recurrences import wkv_plain_launchers

torch.set_num_threads(2)

F32 = dict(atol=5e-5, rtol=1e-5)
BF16 = dict(atol=2e-2, rtol=1.6e-2)
# (B, H, S, N): every head size, ragged lengths (the kernel checkpoints
# every 16 steps), more than one head and batch.
CASES = [(1, 1, 16, 4), (2, 3, 37, 8), (1, 2, 24, 16), (2, 2, 19, 32),
         (1, 2, 33, 64)]
IDS = [f"B{b}H{h}S{s}N{n}" for b, h, s, n in CASES]
# (r, k, v, dy dtype, w dtype)
DTYPES = {"f32": (np.float32, np.float32),
          "bf16": (jnp.bfloat16, np.float32),
          "bf16-wbf16": (jnp.bfloat16, jnp.bfloat16)}
TORCH = {np.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


def _inputs(b, h, s, n, seed=0, decay=(0.7, 0.999)):
    """r, k, v, w, u, dy as f32 numpy; w uniform in ``decay`` or constant."""
    rng = np.random.default_rng(seed)
    r, k, v, dy = (rng.standard_normal((b, h, s, n)).astype(np.float32)
                   for _ in range(4))
    if isinstance(decay, tuple):
        w = rng.uniform(*decay, (b, h, s, n)).astype(np.float32)
    else:
        w = np.full((b, h, s, n), decay, np.float32)
    u = rng.standard_normal((h, n)).astype(np.float32)
    return r, k, v, w, u, dy


def _cast(arrays, dtype, w_dtype):
    """Round r, k, v, dy to ``dtype`` and w to ``w_dtype`` (as numpy f32
    holding the rounded values, and the dtypes to hand each side)."""
    r, k, v, w, u, dy = arrays
    def rnd(a, dt):
        return np.array(jnp.asarray(a, dt).astype(jnp.float32))
    return (rnd(r, dtype), rnd(k, dtype), rnd(v, dtype), rnd(w, w_dtype), u,
            rnd(dy, dtype))


def _jax_grads(arrays, dtype, w_dtype):
    """The oracle's gradients (dr, dk, dv, dw, du) as f32 numpy, on JAX's
    CPU device."""
    r, k, v, w, u, dy = arrays
    with jax.default_device(jax.devices("cpu")[0]):
        ins = [jnp.asarray(a, dtype) for a in (r, k, v)] + [
            jnp.asarray(w, w_dtype), jnp.asarray(u)]
        _, vjp = jax.vjp(ref.rwkv6_wkv_ref, *ins)
        grads = vjp(jnp.asarray(dy, dtype))
    return [np.asarray(g.astype(jnp.float32)) for g in grads]


def _bhsn(a, dtype=torch.float32):
    """A (B, H, S, N) array as the model passes it: (B, S, H, N) storage
    viewed as (B, H, S, N)."""
    return torch.from_numpy(a).to(dtype).transpose(1, 2).contiguous() \
        .transpose(1, 2)


def _torch_args(arrays, dtype, w_dtype):
    r, k, v, w, u, dy = arrays
    td, tw = TORCH[dtype], TORCH[w_dtype]
    return (_bhsn(r, td), _bhsn(k, td), _bhsn(v, td), _bhsn(w, tw),
            torch.from_numpy(u), _bhsn(dy, td))


def _assert_grads(got, want, dtype, w_dtype):
    for i, (name, g, ww) in enumerate(zip(("dr", "dk", "dv", "dw", "du"),
                                          got, want)):
        tol = F32
        if (i < 3 and dtype != np.float32) or (i == 3 and
                                               w_dtype != np.float32):
            tol = BF16
        g = g.float().numpy() if isinstance(g, torch.Tensor) else g
        assert g.shape == ww.shape, name
        np.testing.assert_allclose(g, ww, **tol, err_msg=name)


@pytest.mark.parametrize("dname", list(DTYPES))
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_bwd_plain_matches_jax_vjp(case, dname):
    dtype, w_dtype = DTYPES[dname]
    arrays = _cast(_inputs(*case), dtype, w_dtype)
    want = _jax_grads(arrays, dtype, w_dtype)
    args = _torch_args(arrays, dtype, w_dtype)
    got = wkv_mod.rwkv6_wkv_bwd_plain(*args)
    for g, a in zip(got[:4], args[:4]):
        assert g.dtype == a.dtype
    assert got[4].dtype == torch.float32
    _assert_grads(got, want, dtype, w_dtype)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_plain_autograd_matches_jax_vjp(case):
    """The CPU training path: ``ops.rwkv6_wkv_op`` on CPU tensors is the
    plain version, differentiated by autograd."""
    arrays = _inputs(*case, seed=1)
    want = _jax_grads(arrays, np.float32, np.float32)
    *ins, dy = _torch_args(arrays, np.float32, np.float32)
    ins = [a.requires_grad_() for a in ins]
    out = ops.rwkv6_wkv_op(*ins)
    got = torch.autograd.grad(out, ins, dy)
    _assert_grads(got, want, np.float32, np.float32)


@pytest.mark.parametrize("dname", ["f32", "bf16"])
@pytest.mark.parametrize("decay", [0.0, 1.0])
def test_decay_edges_match_jax_vjp(decay, dname):
    """w = 0 forgets (the state is the last step's k vᵀ, the adjoint the
    step's r dyᵀ) and w = 1 sums every step: both exact in the reverse
    recurrence too (no division by w, no cumulative products)."""
    dtype, w_dtype = DTYPES[dname]
    arrays = _cast(_inputs(2, 2, 40, 16, seed=2, decay=decay), dtype,
                   w_dtype)
    want = _jax_grads(arrays, dtype, w_dtype)
    got = wkv_mod.rwkv6_wkv_bwd_plain(*_torch_args(arrays, dtype, w_dtype))
    if decay == 0.0:
        # dw_t = Σ_m G_t ⊙ S_{t-1} with S_{t-1} = k_{t-1} v_{t-1}ᵀ and
        # G_t = r_{t+1} dy_{t+1}ᵀ: finite and exactly 0 at t = 0.
        assert torch.all(got[3][:, :, 0] == 0)
    _assert_grads(got, want, dtype, w_dtype)


def test_wkv_fn_wiring(monkeypatch):
    """With grad, the wrapper builds an ``RwkvWkvFn`` node: one
    checkpointing forward and one backward launch, the backward given the
    forward's checkpoints, gradients of all five inputs equal to the plain
    version's autograd; a dy whose N axis is not unit-stride is made
    contiguous before the backward launcher sees it. Without grad, one
    forward without checkpoints and no node."""
    calls = wkv_plain_launchers(monkeypatch)
    *ins, _ = _torch_args(_inputs(2, 3, 20, 8, seed=3), np.float32,
                          np.float32)
    weight = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (2, 3, 8, 20)).astype(np.float32))
    got_in = [a.clone().requires_grad_() for a in ins]
    out = wkv_mod.rwkv6_wkv(*got_in)
    assert type(out.grad_fn).__name__.startswith("RwkvWkvFn")
    # the loss reads y transposed: its cotangent has N stride S
    got = torch.autograd.grad((out.transpose(2, 3) * weight).sum(), got_in)
    assert calls == ["fwd_ckpt", "bwd"]
    _assert_same_ckpts(calls.bwd_ckpts[0], calls.ckpts[0])
    want_in = [a.clone().requires_grad_() for a in ins]
    want = torch.autograd.grad(
        (wkv_mod.rwkv6_wkv_plain(*want_in).transpose(2, 3) * weight).sum(),
        want_in)
    for g, ww, a in zip(got, want, ins):
        assert g.shape == a.shape
        torch.testing.assert_close(g, ww, atol=1e-5, rtol=1e-5)
    with torch.no_grad():
        y = wkv_mod.rwkv6_wkv(*got_in)
    assert y.grad_fn is None and calls == ["fwd_ckpt", "bwd", "fwd"]


def _assert_same_ckpts(got, want):
    """The backward received the very arrays a forward stored."""
    for g, w in zip(got, want):
        assert g.data_ptr() == w.data_ptr() and torch.equal(g, w)


def test_wkv_fn_wiring_under_remat(monkeypatch):
    """Under non-reentrant ``torch.utils.checkpoint`` (the model's remat)
    the forward runs twice, both times storing checkpoints, and the
    backward reads the recomputed forward's; the gradients are the plain
    version's."""
    calls = wkv_plain_launchers(monkeypatch)
    *ins, dy = _torch_args(_inputs(1, 2, 37, 16, seed=8), np.float32,
                           np.float32)
    got_in = [a.clone().requires_grad_() for a in ins]
    out = torch.utils.checkpoint.checkpoint(
        lambda *a: wkv_mod.rwkv6_wkv(*a) * 2.0, *got_in,
        use_reentrant=False)
    assert calls == ["fwd_ckpt"]
    got = torch.autograd.grad(out, got_in, dy)
    assert calls == ["fwd_ckpt", "fwd_ckpt", "bwd"]
    _assert_same_ckpts(calls.bwd_ckpts[0], calls.ckpts[1])
    want_in = [a.clone().requires_grad_() for a in ins]
    want = torch.autograd.grad(wkv_mod.rwkv6_wkv_plain(*want_in) * 2.0,
                               want_in, dy)
    for g, ww in zip(got, want):
        torch.testing.assert_close(g, ww, atol=1e-5, rtol=1e-5)


def test_bwd_input_checks():
    r, k, v, w, u, dy = _torch_args(_inputs(1, 2, 9, 8), np.float32,
                                    np.float32)
    wkv_mod.check_bwd_inputs(r, k, v, w, u, dy)
    with pytest.raises(ValueError, match="dy is"):
        wkv_mod.check_bwd_inputs(r, k, v, w, u, dy[:, :, :-1])
    with pytest.raises(ValueError, match="dy is"):
        wkv_mod.check_bwd_inputs(r, k, v, w, u, dy.to(torch.bfloat16))
    with pytest.raises(ValueError, match="unit stride"):
        wkv_mod.check_bwd_inputs(
            r, k, v, w, u, dy.transpose(2, 3).contiguous().transpose(2, 3))
    with pytest.raises(ValueError, match="head size"):
        wkv_mod.check_bwd_inputs(*(a[..., :6] for a in (r, k, v, w)),
                                 u[:, :6], dy[..., :6])
    with pytest.raises(ValueError, match="CUDA"):
        wkv_mod.rwkv6_wkv_bwd(r, k, v, w, u, dy)


def test_bwd_scratch_matches_the_kernel_header():
    """What the backward reads and writes beyond its inputs and outputs,
    at the sizes the kernel's header states: the forward's checkpoints
    (the state before every 16 steps), c_t and du's partials."""
    assert wkv_mod.bwd_scratch_floats(2, 40, 1024, 64) == \
        20_971_520 + 81_920 + 5_120
    assert wkv_mod.bwd_scratch_floats(4, 40, 4096, 64) == \
        167_772_160 + 655_360 + 10_240
    # a ragged last interval still has its checkpoint
    assert wkv_mod.bwd_scratch_floats(1, 1, 17, 8) == 2 * 64 + 17 + 8
    assert wkv_mod.ckpt_shapes(2, 40, 1024, 64) == ((2, 40, 64, 64, 64),
                                                    (2, 40, 1024))
    assert wkv_mod.CKPT_STEPS == 16


# ------------------------------------------- checkpoints (plain versions)
# Lengths around the checkpoint interval: one step, one short of it, one
# interval, one past it, and a ragged third interval.
CKPT_LENGTHS = [1, 15, 16, 17, 37]
DECAYS = {"uniform": (0.7, 0.999), "w=0": 0.0, "w=1": 1.0}


def _np_states(r, k, v, w):
    """The state before every CKPT_STEPS steps and c_t's inputs, by a
    numpy f32 loop: state = w ⊙ state + k vᵀ."""
    b, h, s, n = r.shape
    state = np.zeros((b, h, n, n), np.float32)
    out = []
    for t in range(s):
        if t % wkv_mod.CKPT_STEPS == 0:
            out.append(state.copy())
        state = w[:, :, t, :, None] * state + \
            k[:, :, t, :, None] * v[:, :, t, None, :]
    return np.stack(out, axis=2)


@pytest.mark.parametrize("dname", ["f32", "bf16"])
@pytest.mark.parametrize("s", CKPT_LENGTHS)
def test_ckpt_forward_plain(s, dname):
    """The plain checkpointing forward: y bit-equal to the plain forward's
    and within tolerance of the JAX oracle's, the checkpoints those of a
    numpy state loop, c_t = Σ_n r u k."""
    dtype, w_dtype = DTYPES[dname]
    arrays = _cast(_inputs(2, 2, s, 8, seed=10), dtype, w_dtype)
    args = _torch_args(arrays, dtype, w_dtype)
    y, ckpt, c = wkv_mod.rwkv6_wkv_ckpt_plain(*args[:5])
    assert torch.equal(y, wkv_mod.rwkv6_wkv_plain(*args[:5]))
    assert ckpt.shape == (2, 2, -(-s // 16), 8, 8) and c.shape == (2, 2, s)
    assert ckpt.dtype == c.dtype == torch.float32
    r, k, v, w, u, _ = arrays
    np.testing.assert_allclose(ckpt.numpy(), _np_states(r, k, v, w),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(c.numpy(), (r * u[None, :, None] * k).sum(-1),
                               rtol=1e-5, atol=1e-5)
    with jax.default_device(jax.devices("cpu")[0]):
        want = ref.rwkv6_wkv_ref(*[jnp.asarray(a, dtype) for a in (r, k, v)],
                                 jnp.asarray(w, w_dtype), jnp.asarray(u))
        want = np.asarray(want.astype(jnp.float32))
    tol = F32 if dtype == np.float32 else BF16
    np.testing.assert_allclose(y.float().numpy(), want, **tol)


@pytest.mark.parametrize("decay", list(DECAYS))
@pytest.mark.parametrize("dname", ["f32", "bf16"])
@pytest.mark.parametrize("s", CKPT_LENGTHS)
def test_bwd_from_ckpt_plain_matches_jax_vjp(s, dname, decay):
    """The kernel's algorithm in plain PyTorch (the states rebuilt
    interval by interval from the forward's checkpoints, dv's bonus from
    its c_t) against ``jax.vjp`` of the oracle, at decays in [0.7, 0.999],
    0 and 1, and against the plain backward's own state loop."""
    dtype, w_dtype = DTYPES[dname]
    arrays = _cast(_inputs(2, 2, s, 8, seed=11, decay=DECAYS[decay]),
                   dtype, w_dtype)
    args = _torch_args(arrays, dtype, w_dtype)
    _, ckpt, c = wkv_mod.rwkv6_wkv_ckpt_plain(*args[:5])
    got = wkv_mod.rwkv6_wkv_bwd_ckpt_plain(*args, ckpt, c)
    for g, a in zip(got[:4], args[:4]):
        assert g.dtype == a.dtype
    _assert_grads(got, _jax_grads(arrays, dtype, w_dtype), dtype, w_dtype)
    _assert_grads(got, [g.float().numpy() for g in
                        wkv_mod.rwkv6_wkv_bwd_plain(*args)], dtype, w_dtype)


def test_bwd_from_shifted_ckpt_breaks():
    """A checkpoint taken one interval off (each interval rebuilt from the
    next one's state) moves the gradients far past the f32 tolerance: the
    backward really reads the checkpoints it is given."""
    args = _torch_args(_inputs(1, 2, 37, 8, seed=12), np.float32,
                       np.float32)
    _, ckpt, c = wkv_mod.rwkv6_wkv_ckpt_plain(*args[:5])
    want = wkv_mod.rwkv6_wkv_bwd_ckpt_plain(*args, ckpt, c)
    bad = wkv_mod.rwkv6_wkv_bwd_ckpt_plain(
        *args, torch.roll(ckpt, -1, dims=2).contiguous(), c)
    worst = max(float(((b - g).abs() / (g.abs().max() + 1e-30)).max())
                for b, g in zip(bad[:4], want[:4]))
    assert worst > 1e3 * F32["rtol"], worst


def test_ckpt_checks():
    """The backward refuses checkpoints of another shape, dtype or
    layout, and a ckpt without its c."""
    r, k, v, w, u, dy = _torch_args(_inputs(1, 2, 20, 8), np.float32,
                                    np.float32)
    _, ckpt, c = wkv_mod.rwkv6_wkv_ckpt_plain(r, k, v, w, u)
    wkv_mod.check_ckpt(r, ckpt, c)
    for bad in (ckpt[:, :, :1], ckpt.double(),
                ckpt.transpose(3, 4).contiguous().transpose(3, 4)):
        with pytest.raises(ValueError, match="ckpt is"):
            wkv_mod.check_ckpt(r, bad, c)
    with pytest.raises(ValueError, match="c is"):
        wkv_mod.check_ckpt(r, ckpt, c[..., :-1])
    with pytest.raises(ValueError, match="both ckpt and c"):
        wkv_mod.rwkv6_wkv_bwd(r, k, v, w, u, dy, ckpt)


# ------------------------------------------------------------- the card
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the kernels are CUDA C++ and "
                    "have no CPU or interpreter mode")


@pytest.mark.cuda
@pytest.mark.parametrize("dname", list(DTYPES))
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_bwd_kernel_matches_plain_on_card(card, case, dname):
    dtype, w_dtype = DTYPES[dname]
    args = [a.cuda() for a in _torch_args(
        _cast(_inputs(*case, seed=5), dtype, w_dtype), dtype, w_dtype)]
    n = wkv_mod.rwkv6_wkv.launches_bwd
    got = wkv_mod.rwkv6_wkv_bwd(*args)
    torch.cuda.synchronize()
    assert wkv_mod.rwkv6_wkv.launches_bwd == n + 1
    want = wkv_mod.rwkv6_wkv_bwd_plain(*args)
    for g, ww, a in zip(got[:4], want, args):
        assert g.dtype == a.dtype and g.stride() == a.stride()
    _assert_grads([g.cpu() for g in got], [w_.float().cpu().numpy()
                                           for w_ in want], dtype, w_dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("decay", [0.0, 1.0])
def test_bwd_kernel_decay_edges_on_card(card, decay):
    args = [a.cuda() for a in _torch_args(
        _inputs(2, 3, 300, 64, seed=6, decay=decay), np.float32,
        np.float32)]
    got = wkv_mod.rwkv6_wkv_bwd(*args)
    want = wkv_mod.rwkv6_wkv_bwd_plain(*args)
    for g, ww in zip(got, want):
        scale = float(ww.abs().max())
        assert float((g - ww).abs().max()) <= 1e-5 * scale + 1e-5


@pytest.mark.cuda
def test_bwd_kernel_is_deterministic_on_card(card):
    args = [a.cuda() for a in _torch_args(
        _cast(_inputs(2, 4, 100, 64, seed=7), jnp.bfloat16, np.float32),
        jnp.bfloat16, np.float32)]
    first = wkv_mod.rwkv6_wkv_bwd(*args)
    second = wkv_mod.rwkv6_wkv_bwd(*args)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dname", list(DTYPES))
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_ckpt_forward_y_is_the_serving_y_on_card(card, case, dname):
    """The forward with checkpoint stores gives the serving forward's y
    bit for bit, and counts one launch of each kind."""
    dtype, w_dtype = DTYPES[dname]
    args = [a.cuda() for a in _torch_args(
        _cast(_inputs(*case, seed=13), dtype, w_dtype), dtype, w_dtype)][:5]
    fn = wkv_mod.rwkv6_wkv
    n = (fn.launches, fn.launches_ckpt)
    y, _, _ = wkv_mod.rwkv6_wkv_fwd_ckpt(*args)
    y_serve = wkv_mod.rwkv6_wkv_fwd(*args)
    torch.cuda.synchronize()
    assert (fn.launches, fn.launches_ckpt) == (n[0] + 2, n[1] + 1)
    assert y.stride() == y_serve.stride() and torch.equal(y, y_serve)


@pytest.mark.cuda
@pytest.mark.parametrize("dname", list(DTYPES))
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_ckpt_forward_checkpoints_on_card(card, case, dname):
    """The kernel's checkpoints and c_t against the plain checkpointing
    forward's: both are f32 recurrences of the same terms (the kernel with
    FMAs), within 1e-5 of the largest value."""
    dtype, w_dtype = DTYPES[dname]
    args = [a.cuda() for a in _torch_args(
        _cast(_inputs(*case, seed=14), dtype, w_dtype), dtype, w_dtype)][:5]
    _, ckpt, c = wkv_mod.rwkv6_wkv_fwd_ckpt(*args)
    _, want_ckpt, want_c = wkv_mod.rwkv6_wkv_ckpt_plain(*args)
    for got, want in ((ckpt, want_ckpt), (c, want_c)):
        assert got.shape == want.shape and got.dtype == torch.float32
        scale = float(want.abs().max())
        assert float((got - want).abs().max()) <= 1e-5 * scale + 1e-6

