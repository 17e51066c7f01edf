"""The port's fold (``repro_torch.kernels``) against the JAX package's.

On the CPU the ``fedagg`` wrapper runs its plain version (the CUDA
kernel cannot run here); the same numpy inputs go through the JAX
package's Pallas ``fedagg`` in interpret mode, as
``tests/test_kernels.py`` runs it. The kernel itself is held against
the plain version on the card by the ``cuda``-marked test below and by
``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.paper_cnn import CONFIG as CNN_CONFIG
from repro.core.treeops import tree_combine as jax_tree_combine
from repro.kernels import ops as jax_ops
from repro.models import CNN as JaxCNN
from repro_torch.kernels import fedagg as fedagg_mod, ops

torch.set_num_threads(2)

# The JAX package's own kernel tolerances (tests/test_kernels.py:10-11):
# f32 reduction-order ulps; bf16 one rounding of the output.
TOL = {"float32": dict(atol=3e-5, rtol=1e-4),
       "bfloat16": dict(atol=5e-2, rtol=5e-2)}
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _inputs(s, p, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((s, p)).astype(np.float32),
            rng.random(s).astype(np.float32))


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(x)).to(dtype)


@pytest.mark.parametrize("s,p,block", [
    (4, 64, 32), (16, 1000, 256), (8, 16384, 4096), (1, 7, 4),
    (40, 333, 128),
])
@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
def test_fedagg_matches_jax_pallas(s, p, block, dname):
    tdt, jdt = DTYPES[dname]
    x, w = _inputs(s, p)
    # f32 -> bf16 rounds to nearest-even in both frameworks: same inputs.
    want = np.asarray(jax_ops.fedagg_op(jnp.asarray(x, jdt), jnp.asarray(w),
                                        block_p=block), np.float32)
    xt = _t(x, tdt)
    for got in (fedagg_mod.fedagg_plain(xt, _t(w)),
                ops.fedagg_op(xt, w)):
        assert got.dtype == tdt and got.shape == (p,)
        np.testing.assert_allclose(got.float().numpy(), want, **TOL[dname])


def _cnn_stack(n=3, seed=0):
    """A stacked CNN-shaped tree: n perturbed copies of one init."""
    rng = np.random.default_rng(seed)
    defs = JaxCNN(CNN_CONFIG).defs()
    return {k: (0.05 * rng.standard_normal((n,) + d.shape)).astype(
        np.float32) for k, d in defs.items()}


def test_tree_wrappers_match_jax_on_cnn_tree():
    stacked = _cnn_stack()
    w = np.array([0.5, 0.3, 0.2], np.float32)
    want = jax_tree_combine({k: jnp.asarray(v) for k, v in stacked.items()},
                            w)
    tree = {k: _t(v) for k, v in stacked.items()}
    for got in (ops.fedagg_tree(tree, w), ops.fold_stacked_tree(tree, w)):
        assert list(got) == list(tree)
        for k in tree:
            assert got[k].shape == tree[k].shape[1:]
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       **TOL["float32"])


def test_convex_weights_preserve_constant():
    """Folding identical replicas with convex weights is the identity."""
    x = torch.arange(50, dtype=torch.float32)[None].repeat(6, 1)
    w = [0.1, 0.2, 0.3, 0.2, 0.1, 0.1]
    np.testing.assert_allclose(ops.fedagg_op(x, w).numpy(), x[0].numpy(),
                               rtol=1e-6)


@pytest.mark.parametrize("multiple", [1, 4, 16])
def test_zero_weight_padded_rows_add_exactly_zero(multiple):
    tree = {k: _t(v) for k, v in _cnn_stack(n=5).items()}
    w = np.array([0.4, 0.1, 0.2, 0.2, 0.1], np.float32)
    padded, pw = ops.pad_stacked_rows(tree, w, multiple)
    assert pw.shape[0] % multiple == 0 and pw.shape[0] >= 5
    for k in tree:
        assert padded[k].shape[0] == pw.shape[0]
        assert not padded[k][5:].any()
    for fold in (ops.fedagg_tree, ops.fold_stacked_tree):
        a, b = fold(tree, w), fold(padded, pw)
        for k in tree:
            assert torch.equal(a[k], b[k]), (fold.__name__, k)


def test_tree_rows_match_jax():
    from repro.core import treeops as jt
    from repro_torch.core import treeops as tt
    stacked = _cnn_stack(n=4)
    jtree = {k: jnp.asarray(v) for k, v in stacked.items()}
    ttree = {k: _t(v) for k, v in stacked.items()}
    row = {k: np.full(v.shape[1:], 0.5, np.float32) for k, v in
           stacked.items()}
    for k, v in tt.tree_row(ttree, 2).items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(
            jt.tree_row(jtree, 2)[k]))
    got = tt.tree_set_row(ttree, 1, {k: _t(v) for k, v in row.items()})
    want = jt.tree_set_row(jtree, 1, {k: jnp.asarray(v) for k, v in
                                      row.items()})
    for k in stacked:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
        np.testing.assert_array_equal(ttree[k].numpy(), stacked[k])
    bcast = tt.tree_broadcast({k: v[0] for k, v in ttree.items()}, 3)
    for k, v in bcast.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(
            jt.tree_broadcast({k: jtree[k][0]}, 3)[k]))


def test_cpu_fold_launches_no_kernel():
    before = fedagg_mod.fedagg.launches
    ops.fold_stacked_tree({k: _t(v) for k, v in _cnn_stack().items()},
                          [0.2, 0.3, 0.5])
    ops.fedagg_op(torch.ones(3, 8), [1.0, 0.0, 0.0])
    assert fedagg_mod.fedagg.launches == before


@pytest.mark.parametrize("x,w,exc", [
    (torch.ones(3, 4, dtype=torch.float64), torch.ones(3), TypeError),
    (torch.ones(3, 4, dtype=torch.int32), torch.ones(3), TypeError),
    (torch.ones(3, 4), torch.ones(3, dtype=torch.float64), TypeError),
    (torch.ones(12), torch.ones(3), ValueError),
    (torch.ones(3, 4), torch.ones(3, 1), ValueError),
    (torch.ones(3, 4), torch.ones(4), ValueError),
    (torch.ones(0, 4), torch.ones(0), ValueError),
    (torch.ones(4, 3).t(), torch.ones(3), ValueError),
    (torch.ones(3, 4, device="meta"), torch.ones(3, device="meta"),
     ValueError),
], ids=["x-f64", "x-int", "w-f64", "x-1d", "w-2d", "S-mismatch", "S-0",
        "non-contiguous", "meta-device"])
def test_wrapper_rejects_bad_inputs(x, w, exc):
    with pytest.raises(exc):
        fedagg_mod.fedagg(x, w)


def test_library_path_follows_the_source(tmp_path, monkeypatch):
    """The build is keyed by a hash of the source: an edited source gets a
    new library name, so a stale build is never loaded."""
    from repro_torch.kernels import build
    src = build.CSRC / "fedagg.cu"
    assert build.library_path("fedagg").parent == build.build_dir()
    (tmp_path / "fedagg.cu").write_text(src.read_text() + "\n// edit\n")
    before = build.library_path("fedagg")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    assert build.library_path("fedagg").name != before.name


@pytest.mark.cuda
@pytest.mark.parametrize("s,p,offset", [
    (40, 1_605_632, 0), (40, 10, 0), (1, 7, 0), (3, 1001, 0), (8, 4096, 1),
])
@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
def test_kernel_matches_plain_on_card(s, p, offset, dname):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the fedagg kernel is CUDA C++ "
                    "and has no CPU or interpreter mode")
    tdt = DTYPES[dname][0]
    x, w = _inputs(s, p + offset)
    base = _t(x.reshape(-1)[:s * p + offset], tdt).cuda()
    xd = base[offset:].view(s, p)
    wd = _t(w).cuda()
    before = fedagg_mod.fedagg.launches
    got = fedagg_mod.fedagg(xd, wd)
    torch.cuda.synchronize()
    assert fedagg_mod.fedagg.launches == before + 1
    want = fedagg_mod.fedagg_plain(xd, wd)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), **TOL[dname])
