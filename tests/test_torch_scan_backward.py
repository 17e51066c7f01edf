"""The backward of the port's selective scan
(``repro_torch.kernels.selective_scan``: ``selective_scan_bwd``, its
plain version, ``SelectiveScanFn``) against ``jax.vjp`` of the JAX
package's oracle ``ref.selective_scan_ref``.

The JAX package has no backward kernel: it trains through autodiff of
its jnp scan. So the same numpy inputs and output cotangent go through
``jax.vjp`` of the oracle (on JAX's CPU device) and through the port's
plain backward (the kernel's reverse recurrence: the adjoint
G_t = c_t dy_t + abar_{t+1} ⊙ G_{t+1}, d abar_t = G_t ⊙ h_{t-1},
dc_t = Σ_d h_t dy_t) and the plain forward's autograd (the CPU training
path). The oracle returns abar's dtype and the port bx's (the JAX
model's scan does too); in the mixed case (abar f32, bx and c bf16) the
oracle's cotangent is the port's bf16 dy widened to f32, the same
values.

The backward reads checkpoints that the forward kernel stores under grad
(the state before every 8 steps); their plain versions
(``selective_scan_ckpt_plain``, and ``selective_scan_bwd_ckpt_plain``,
which rebuilds each interval's states from its checkpoint and computes
dc in the reverse loop) are held to the oracle at lengths around the
interval.

Tolerances. f32 (``F32``): both sides are f32 sums of the same terms in
other orders (measured here: at most 4.8e-6 absolute on gradients up to
~25). bf16 outputs: both sides compute in f32 and round once, so they
differ by at most one bf16 ulp where their f32 values straddle a rounding
boundary: ``BF16`` allows two ulps relative and an absolute floor for
values near 0. The kernel runs only on the card: the ``cuda``-marked
tests hold it to the plain version there, and on the CPU
``SelectiveScanFn``'s wiring is checked with its launchers replaced by
the plain versions.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro_torch.kernels import ops, selective_scan as scan_mod

from _torch_recurrences import scan_plain_launchers

torch.set_num_threads(2)

F32 = dict(atol=5e-5, rtol=1e-5)
BF16 = dict(atol=2e-2, rtol=1.6e-2)
# (B, S, D, N): every state size, ragged lengths (the kernel checkpoints
# every 8 steps) and channel counts (its blocks hold 32, 64 or 128).
CASES = [(1, 16, 8, 4), (2, 37, 12, 8), (1, 24, 40, 16), (2, 19, 5, 16)]
IDS = [f"B{b}S{s}D{d}N{n}" for b, s, d, n in CASES]
# (abar dtype, bx / c / dy dtype): the kernel's three cases
DTYPES = {"f32": (np.float32, np.float32),
          "bf16": (jnp.bfloat16, jnp.bfloat16),
          "mixed": (np.float32, jnp.bfloat16)}
TORCH = {np.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


def _inputs(b, s, d, n, seed=0, abar=(0.2, 0.99)):
    """abar, bx, c, dy as f32 numpy; abar uniform in ``abar`` or
    constant; c (B, S, N) drawn as a slice of a wider array, as the
    model's split of x_proj's output."""
    rng = np.random.default_rng(seed)
    if isinstance(abar, tuple):
        a = rng.uniform(*abar, (b, s, d, n)).astype(np.float32)
    else:
        a = np.full((b, s, d, n), abar, np.float32)
    bx = rng.standard_normal((b, s, d, n)).astype(np.float32)
    c = rng.standard_normal((b, s, 2 * n + 3)).astype(np.float32)[..., 3:3 + n]
    dy = rng.standard_normal((b, s, d)).astype(np.float32)
    return a, bx, c, dy


def _cast(arrays, a_dtype, x_dtype):
    """Round abar to ``a_dtype`` and bx, c, dy to ``x_dtype`` (numpy f32
    holding the rounded values)."""
    a, bx, c, dy = arrays
    def rnd(v, dt):
        return np.array(jnp.asarray(v, dt).astype(jnp.float32))
    return rnd(a, a_dtype), rnd(bx, x_dtype), rnd(c, x_dtype), rnd(dy, x_dtype)


def _jax_grads(arrays, a_dtype, x_dtype):
    """The oracle's gradients (d abar, d bx, dc) as f32 numpy, on JAX's
    CPU device."""
    a, bx, c, dy = arrays
    with jax.default_device(jax.devices("cpu")[0]):
        ins = (jnp.asarray(a, a_dtype), jnp.asarray(bx, x_dtype),
               jnp.asarray(c, x_dtype))
        _, vjp = jax.vjp(ref.selective_scan_ref, *ins)
        grads = vjp(jnp.asarray(dy, a_dtype))
    return [np.asarray(g.astype(jnp.float32)) for g in grads]


def _torch_args(arrays, a_dtype, x_dtype, c_view=True):
    """abar, bx contiguous; c as a strided view (``c_view``); dy."""
    a, bx, c, dy = arrays
    ta, tx = TORCH[a_dtype], TORCH[x_dtype]
    b, s, n = c.shape
    if c_view:
        wide = torch.zeros((b, s, 2 * n + 3), dtype=tx)
        wide[..., 3:3 + n] = torch.from_numpy(np.ascontiguousarray(c))
        tc = wide[..., 3:3 + n]
    else:
        tc = torch.from_numpy(np.ascontiguousarray(c)).to(tx)
    return (torch.from_numpy(a).to(ta), torch.from_numpy(bx).to(tx), tc,
            torch.from_numpy(dy).to(tx))


def _assert_grads(got, want, a_dtype, x_dtype):
    for i, (name, g, ww) in enumerate(zip(("dabar", "dbx", "dc"), got,
                                          want)):
        dt = a_dtype if i == 0 else x_dtype
        tol = F32 if dt == np.float32 else BF16
        g = g.float().numpy() if isinstance(g, torch.Tensor) else g
        assert g.shape == ww.shape, name
        np.testing.assert_allclose(g, ww, **tol, err_msg=name)


@pytest.mark.parametrize("dname", list(DTYPES))
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_bwd_plain_matches_jax_vjp(case, dname):
    a_dtype, x_dtype = DTYPES[dname]
    arrays = _cast(_inputs(*case), a_dtype, x_dtype)
    want = _jax_grads(arrays, a_dtype, x_dtype)
    args = _torch_args(arrays, a_dtype, x_dtype)
    got = scan_mod.selective_scan_bwd_plain(*args)
    for g, a in zip(got, args[:3]):
        assert g.dtype == a.dtype
    assert got[2].shape == args[2].shape
    _assert_grads(got, want, a_dtype, x_dtype)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_plain_autograd_matches_jax_vjp(case):
    """The CPU training path: ``ops.selective_scan_op`` on CPU tensors is
    the plain version, differentiated by autograd."""
    arrays = _inputs(*case, seed=1)
    want = _jax_grads(arrays, np.float32, np.float32)
    *ins, dy = _torch_args(arrays, np.float32, np.float32, c_view=False)
    ins = [a.requires_grad_() for a in ins]
    out = ops.selective_scan_op(*ins)
    got = torch.autograd.grad(out, ins, dy)
    _assert_grads(got, want, np.float32, np.float32)


@pytest.mark.parametrize("dname", ["f32", "mixed"])
@pytest.mark.parametrize("abar", [0.0, 1.0])
def test_decay_edges_match_jax_vjp(abar, dname):
    """abar = 0 forgets (h_t = bx_t, G_t = c_t dy_t) and abar = 1 sums
    every step: both exact in the reverse recurrence too (no division by
    abar, which exp(dt·A) underflows to)."""
    a_dtype, x_dtype = DTYPES[dname]
    arrays = _cast(_inputs(2, 40, 16, 16, seed=2, abar=abar), a_dtype,
                   x_dtype)
    want = _jax_grads(arrays, a_dtype, x_dtype)
    args = _torch_args(arrays, a_dtype, x_dtype)
    got = scan_mod.selective_scan_bwd_plain(*args)
    if abar == 0.0:
        _, bx, c, dy = args
        g = c.float()[:, :, None, :] * dy.float()[..., None]
        assert torch.equal(got[1].float(), g.to(bx.dtype).float())
    _assert_grads(got, want, a_dtype, x_dtype)


def test_scan_fn_wiring(monkeypatch):
    """With grad, the wrapper builds a ``SelectiveScanFn`` node: one
    checkpointing forward and one backward launch, the backward given the
    forward's checkpoints, gradients of abar, bx and the strided c equal
    to the plain version's autograd, dc in c's shape; a dy whose D axis
    is not unit-stride is made contiguous before the backward launcher
    sees it. Without grad, one forward without checkpoints and no
    node."""
    calls = scan_plain_launchers(monkeypatch)
    *ins, _ = _torch_args(_inputs(2, 20, 12, 8, seed=3), np.float32,
                          np.float32)
    weight = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (2, 12, 20)).astype(np.float32))
    got_in = [a.detach().clone().requires_grad_() if i < 2
              else a.detach().requires_grad_() for i, a in enumerate(ins)]
    out = scan_mod.selective_scan(*got_in)
    assert type(out.grad_fn).__name__.startswith("SelectiveScanFn")
    # the loss reads y transposed: its cotangent has D stride S
    got = torch.autograd.grad((out.transpose(1, 2) * weight).sum(), got_in)
    assert calls == ["fwd_ckpt", "bwd"]
    _assert_same_ckpt(calls.bwd_ckpts[0], calls.ckpts[0])
    want_in = [a.detach().clone().requires_grad_() for a in ins]
    want = torch.autograd.grad(
        (scan_mod.selective_scan_plain(*want_in).transpose(1, 2)
         * weight).sum(), want_in)
    for g, ww, a in zip(got, want, ins):
        assert g.shape == a.shape
        torch.testing.assert_close(g, ww, atol=1e-5, rtol=1e-5)
    with torch.no_grad():
        y = scan_mod.selective_scan(*got_in)
    assert y.grad_fn is None and calls == ["fwd_ckpt", "bwd", "fwd"]


def _assert_same_ckpt(got, want):
    """The backward received the very array a forward stored."""
    assert got.data_ptr() == want.data_ptr() and torch.equal(got, want)


def test_scan_fn_wiring_under_remat(monkeypatch):
    """Under non-reentrant ``torch.utils.checkpoint`` (the model's remat)
    the forward runs twice, both times storing checkpoints, and the
    backward reads the recomputed forward's; the gradients are the plain
    version's."""
    calls = scan_plain_launchers(monkeypatch)
    *ins, dy = _torch_args(_inputs(1, 37, 12, 16, seed=8), np.float32,
                           np.float32)
    got_in = [a.detach().clone().requires_grad_() for a in ins]
    out = torch.utils.checkpoint.checkpoint(
        lambda *a: scan_mod.selective_scan(*a) * 2.0, *got_in,
        use_reentrant=False)
    assert calls == ["fwd_ckpt"]
    got = torch.autograd.grad(out, got_in, dy)
    assert calls == ["fwd_ckpt", "fwd_ckpt", "bwd"]
    _assert_same_ckpt(calls.bwd_ckpts[0], calls.ckpts[1])
    want_in = [a.detach().clone().requires_grad_() for a in ins]
    want = torch.autograd.grad(scan_mod.selective_scan_plain(*want_in) * 2.0,
                               want_in, dy)
    for g, ww in zip(got, want):
        torch.testing.assert_close(g, ww, atol=1e-5, rtol=1e-5)


def test_bwd_input_checks():
    abar, bx, c, dy = _torch_args(_inputs(1, 9, 8, 4), np.float32,
                                  np.float32)
    scan_mod.check_bwd_inputs(abar, bx, c, dy)
    with pytest.raises(ValueError, match="dy is"):
        scan_mod.check_bwd_inputs(abar, bx, c, dy[:, :-1])
    with pytest.raises(ValueError, match="dy is"):
        scan_mod.check_bwd_inputs(abar, bx, c, dy.to(torch.bfloat16))
    with pytest.raises(ValueError, match="unit stride"):
        scan_mod.check_bwd_inputs(
            abar, bx, c, dy.transpose(1, 2).contiguous().transpose(1, 2))
    with pytest.raises(ValueError, match="contiguous"):
        scan_mod.check_bwd_inputs(abar.transpose(1, 2).contiguous()
                                  .transpose(1, 2), bx, c, dy)
    with pytest.raises(ValueError, match="CUDA"):
        scan_mod.selective_scan_bwd(abar, bx, c, dy)


def test_bwd_scratch_matches_the_kernel_header():
    """The wrapper's scratch size, at the sizes the kernel's header
    states: dc's block partials (the checkpoints are the forward's)."""
    assert scan_mod.bwd_scratch_floats(2, 1024, 8192, 16) == 8_388_608
    assert scan_mod.bwd_scratch_floats(4, 4096, 8192, 16) == 67_108_864
    # N = 4: 128 channels a block, so 130 channels take two
    assert scan_mod.bwd_scratch_floats(1, 9, 130, 4) == 2 * 9 * 4
    # the forward's checkpoints; a ragged last interval has its own
    assert scan_mod.ckpt_shape(2, 1024, 8192, 16) == (2, 128, 8192, 16)
    assert scan_mod.ckpt_shape(1, 9, 130, 4) == (1, 2, 130, 4)
    assert scan_mod.CKPT_STEPS == 8


# ------------------------------------------- checkpoints (plain versions)
# Lengths around the checkpoint interval: one step, one short of it, one
# interval, one past it, and a ragged fifth interval.
CKPT_LENGTHS = [1, 7, 8, 9, 37]
ABARS = {"uniform": (0.2, 0.99), "abar=0": 0.0, "abar=1": 1.0}


def _np_states(a, bx):
    """The state before every CKPT_STEPS steps, by a numpy f32 loop:
    h = abar ⊙ h + bx."""
    b, s, d, n = a.shape
    h = np.zeros((b, d, n), np.float32)
    out = []
    for t in range(s):
        if t % scan_mod.CKPT_STEPS == 0:
            out.append(h.copy())
        h = a[:, t] * h + bx[:, t]
    return np.stack(out, axis=1)


@pytest.mark.parametrize("dname", list(DTYPES))
@pytest.mark.parametrize("s", CKPT_LENGTHS)
def test_ckpt_forward_plain(s, dname):
    """The plain checkpointing forward: y bit-equal to the plain forward's
    and within tolerance of the JAX oracle's, the checkpoints those of a
    numpy state loop."""
    a_dtype, x_dtype = DTYPES[dname]
    arrays = _cast(_inputs(2, s, 12, 8, seed=10), a_dtype, x_dtype)
    abar, bx, c, _ = _torch_args(arrays, a_dtype, x_dtype)
    y, ckpt = scan_mod.selective_scan_ckpt_plain(abar, bx, c)
    assert torch.equal(y, scan_mod.selective_scan_plain(abar, bx, c))
    assert ckpt.shape == (2, -(-s // 8), 12, 8)
    assert ckpt.dtype == torch.float32 and ckpt.is_contiguous()
    a, x, cc, _ = arrays
    np.testing.assert_allclose(ckpt.numpy(), _np_states(a, x), rtol=1e-6,
                               atol=1e-6)
    with jax.default_device(jax.devices("cpu")[0]):
        want = ref.selective_scan_ref(jnp.asarray(a, a_dtype),
                                      jnp.asarray(x, x_dtype),
                                      jnp.asarray(cc, x_dtype))
        want = np.asarray(want.astype(jnp.float32))
    tol = F32 if x_dtype == np.float32 else BF16
    np.testing.assert_allclose(y.float().numpy(), want, **tol)


@pytest.mark.parametrize("abar", list(ABARS))
@pytest.mark.parametrize("dname", list(DTYPES))
@pytest.mark.parametrize("s", CKPT_LENGTHS)
def test_bwd_from_ckpt_plain_matches_jax_vjp(s, dname, abar):
    """The kernel's algorithm in plain PyTorch (the states rebuilt
    interval by interval from the forward's checkpoints, dc_t from the
    rebuilt h_t, at an interval's last step the state after it) against
    ``jax.vjp`` of the oracle, at abar in [0.2, 0.99], 0 and 1, and
    against the plain backward's own state loop."""
    a_dtype, x_dtype = DTYPES[dname]
    arrays = _cast(_inputs(2, s, 12, 8, seed=11, abar=ABARS[abar]), a_dtype,
                   x_dtype)
    args = _torch_args(arrays, a_dtype, x_dtype)
    _, ckpt = scan_mod.selective_scan_ckpt_plain(*args[:3])
    got = scan_mod.selective_scan_bwd_ckpt_plain(*args, ckpt)
    for g, a in zip(got, args[:3]):
        assert g.dtype == a.dtype
    assert got[2].shape == args[2].shape
    _assert_grads(got, _jax_grads(arrays, a_dtype, x_dtype), a_dtype,
                  x_dtype)
    _assert_grads(got, [g.float().numpy() for g in
                        scan_mod.selective_scan_bwd_plain(*args)], a_dtype,
                  x_dtype)


def test_bwd_from_shifted_ckpt_breaks():
    """Checkpoints taken one interval off (each interval rebuilt from the
    next one's state) move the gradients far past the f32 tolerance: the
    backward really reads the checkpoints it is given."""
    args = _torch_args(_inputs(1, 37, 12, 8, seed=12), np.float32,
                       np.float32)
    _, ckpt = scan_mod.selective_scan_ckpt_plain(*args[:3])
    want = scan_mod.selective_scan_bwd_ckpt_plain(*args, ckpt)
    bad = scan_mod.selective_scan_bwd_ckpt_plain(
        *args, torch.roll(ckpt, -1, dims=1).contiguous())
    worst = max(float(((b - g).abs() / (g.abs().max() + 1e-30)).max())
                for b, g in zip(bad, want))
    assert worst > 1e3 * F32["rtol"], worst


def test_ckpt_checks():
    """The backward refuses checkpoints of another shape, dtype, layout
    or device."""
    abar, bx, c, dy = _torch_args(_inputs(1, 20, 8, 4), np.float32,
                                  np.float32)
    _, ckpt = scan_mod.selective_scan_ckpt_plain(abar, bx, c)
    scan_mod.check_ckpt(abar, ckpt)
    for bad in (ckpt[:, :1], ckpt.double(),
                ckpt.transpose(2, 3).contiguous().transpose(2, 3),
                ckpt.to("meta")):
        with pytest.raises(ValueError, match="ckpt is"):
            scan_mod.check_ckpt(abar, bad)
    with pytest.raises(ValueError, match="ckpt is"):
        scan_mod.selective_scan_bwd_ckpt_plain(abar, bx, c, dy, ckpt[:, :1])
    with pytest.raises(ValueError, match="CUDA"):
        scan_mod.selective_scan_bwd(abar, bx, c, dy, ckpt)
    with pytest.raises(ValueError, match="CUDA"):
        scan_mod.selective_scan_fwd_ckpt(abar, bx, c)


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
    """The backward on the forward kernel's checkpoints, and making its
    own: bit-equal to each other, within tolerance of the plain one."""
    a_dtype, x_dtype = DTYPES[dname]
    args = [a.cuda() for a in _torch_args(
        _cast(_inputs(*case, seed=5), a_dtype, x_dtype), a_dtype, x_dtype)]
    fn = scan_mod.selective_scan
    n = (fn.launches_bwd, fn.launches_ckpt)
    _, ckpt = scan_mod.selective_scan_fwd_ckpt(*args[:3])
    got = scan_mod.selective_scan_bwd(*args, ckpt)
    alone = scan_mod.selective_scan_bwd(*args)
    torch.cuda.synchronize()
    assert (fn.launches_bwd, fn.launches_ckpt) == (n[0] + 2, n[1] + 2)
    assert all(torch.equal(x, y) for x, y in zip(got, alone))
    want = scan_mod.selective_scan_bwd_plain(*args)
    for g, a in zip(got, args[:3]):
        assert g.dtype == a.dtype and g.shape == a.shape
    _assert_grads([g.cpu() for g in got],
                  [w_.float().cpu().numpy() for w_ in want], a_dtype,
                  x_dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("abar", [0.0, 1.0])
def test_bwd_kernel_decay_edges_on_card(card, abar):
    args = [a.cuda() for a in _torch_args(
        _inputs(2, 300, 130, 16, seed=6, abar=abar), np.float32,
        np.float32)]
    _, ckpt = scan_mod.selective_scan_fwd_ckpt(*args[:3])
    want = scan_mod.selective_scan_bwd_plain(*args)
    for got in (scan_mod.selective_scan_bwd(*args, ckpt),
                scan_mod.selective_scan_bwd(*args)):
        for g, ww in zip(got, want):
            scale = float(ww.abs().max())
            assert float((g - ww).abs().max()) <= 1e-5 * scale + 1e-5


@pytest.mark.cuda
def test_bwd_kernel_is_deterministic_on_card(card):
    args = [a.cuda() for a in _torch_args(
        _cast(_inputs(2, 100, 300, 16, seed=7), np.float32, jnp.bfloat16),
        np.float32, jnp.bfloat16)]
    _, ckpt = scan_mod.selective_scan_fwd_ckpt(*args[:3])
    first = scan_mod.selective_scan_bwd(*args, ckpt)
    second = scan_mod.selective_scan_bwd(*args, ckpt)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dname", list(DTYPES))
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_ckpt_forward_y_is_the_serving_y_on_card(card, case, dname):
    """The forward with checkpoint stores gives the serving forward's y
    bit for bit, and counts one launch of each kind."""
    a_dtype, x_dtype = DTYPES[dname]
    args = [a.cuda() for a in _torch_args(
        _cast(_inputs(*case, seed=13), a_dtype, x_dtype), a_dtype,
        x_dtype)][:3]
    fn = scan_mod.selective_scan
    n = (fn.launches, fn.launches_ckpt)
    y, _ = scan_mod.selective_scan_fwd_ckpt(*args)
    y_serve = scan_mod.selective_scan_fwd(*args)
    torch.cuda.synchronize()
    assert (fn.launches, fn.launches_ckpt) == (n[0] + 2, n[1] + 1)
    assert torch.equal(y, y_serve)


@pytest.mark.cuda
@pytest.mark.parametrize("dname", list(DTYPES))
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_ckpt_forward_checkpoints_on_card(card, case, dname):
    """The kernel's checkpoints against the plain checkpointing forward's:
    both are f32 recurrences of the same terms (the kernel with FMAs),
    within 1e-5 of the largest value."""
    a_dtype, x_dtype = DTYPES[dname]
    args = [a.cuda() for a in _torch_args(
        _cast(_inputs(*case, seed=14), a_dtype, x_dtype), a_dtype,
        x_dtype)][:3]
    _, ckpt = scan_mod.selective_scan_fwd_ckpt(*args)
    _, want = scan_mod.selective_scan_ckpt_plain(*args)
    assert ckpt.shape == want.shape and ckpt.dtype == torch.float32
    scale = float(want.abs().max())
    assert float((ckpt - want).abs().max()) <= 1e-5 * scale + 1e-6
