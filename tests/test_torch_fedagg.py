"""The port's fold (``repro_torch.kernels``) against the JAX package's.

On the CPU ``ops.fedagg_op`` and ``ops.fedagg_tree`` run the plain
versions (the CUDA kernel cannot run here, and its wrappers take CUDA
tensors only); the same numpy inputs go through the JAX package's Pallas
``fedagg`` in interpret mode, as ``tests/test_kernels.py`` runs it. The kernel itself is held against
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


def test_cached_build_keeps_its_report(tmp_path, monkeypatch):
    """A library built once reports the compiler's resource report again
    when it is found built (``chip_smoke.py`` reads registers and spills
    from it), with a stand-in compiler that writes the output file."""
    from repro_torch.kernels import build
    (tmp_path / "k.cu").write_text("// a kernel\n")
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\nwhile [ \"$1\" != -o ]; do shift; done\n"
                    "echo built > \"$2\"\n"
                    "echo 'ptxas info    : Used 40 registers'\n")
    fake.chmod(0o755)
    monkeypatch.setattr(build, "CSRC", tmp_path)
    monkeypatch.setattr(build, "build_dir", lambda: tmp_path / "out")
    monkeypatch.setattr(build, "_nvcc", lambda: str(fake))
    first = build.build(["k"])["k"]
    again = build.build(["k"])["k"]
    assert not first["cached"] and again["cached"]
    assert "Used 40 registers" in first["log"]
    assert again["log"] == first["log"]
    assert build.library_path("k").read_text() == "built\n"


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


# --- The multi-leaf fold: one launch per MAX_LEAVES leaves ---------------

def test_leaves_plain_matches_jax_fedagg_tree_on_cnn_tree():
    """fedagg_leaves_plain over the CNN's leaves against the JAX package's
    fedagg_tree (one Pallas call over the concatenated tree, in interpret
    mode on the CPU)."""
    stacked = _cnn_stack(n=3, seed=3)
    w = np.array([0.25, 0.5, 0.25], np.float32)
    want = jax_ops.fedagg_tree({k: jnp.asarray(v) for k, v in stacked.items()},
                               jnp.asarray(w))
    keys = list(stacked)
    got = fedagg_mod.fedagg_leaves_plain(
        [_t(stacked[k].reshape(3, -1)) for k in keys], _t(w))
    for k, g in zip(keys, got):
        assert g.shape == (stacked[k][0].size,)
        np.testing.assert_allclose(g.numpy(),
                                   np.asarray(want[k]).reshape(-1),
                                   **TOL["float32"])


@pytest.mark.parametrize("elem,p,x_ptr,out_ptr,vec", [
    (4, 1_605_632, 0, 0, True), (4, 10, 0, 0, False), (4, 12, 0, 0, True),
    (4, 12, 4, 0, False), (4, 12, 0, 8, False), (2, 16, 0, 0, True),
    (2, 12, 0, 0, False), (2, 16, 2, 0, False), (4, 1, 0, 0, False),
])
def test_vector_path_choice_per_leaf(elem, p, x_ptr, out_ptr, vec):
    """16-byte loads need P a multiple of 4 (f32) or 8 (bf16) and both x
    and out 16-byte aligned, each leaf on its own."""
    (table,) = fedagg_mod.plan_launches([(4096 + x_ptr, 8192 + out_ptr, p)],
                                        elem)
    assert table == [dict(leaf=0, x=4096 + x_ptr, out=8192 + out_ptr, P=p,
                          vec=vec)]


def test_plan_splits_past_the_leaf_maximum():
    """Leaves beyond MAX_LEAVES go to further launches, in order, each
    leaf's vector flag its own; empty leaves have no entry."""
    n = 2 * fedagg_mod.MAX_LEAVES + 5
    ps = [(i % 7) * 300 for i in range(n)]
    leaves = [(16 * (i + 1), 32 * (i + 1), p) for i, p in enumerate(ps)]
    tables = fedagg_mod.plan_launches(leaves, 4)
    kept = [i for i, p in enumerate(ps) if p]
    assert [e["leaf"] for t in tables for e in t] == kept
    assert all(len(t) == fedagg_mod.MAX_LEAVES for t in tables[:-1])
    assert 0 < len(tables[-1]) <= fedagg_mod.MAX_LEAVES
    assert len(tables) == -(-len(kept) // fedagg_mod.MAX_LEAVES)
    for e in (e for t in tables for e in t):
        assert e["P"] == ps[e["leaf"]] and e["vec"] == (e["P"] % 4 == 0)
    assert fedagg_mod.plan_launches([(0, 0, 0)], 4) == []


@pytest.mark.parametrize("elem", [4, 2])
def test_out_offsets_are_16_byte_aligned(elem):
    ps = [800, 32, 51200, 64, 1605632, 512, 5120, 10, 1, 7]
    offsets, total = fedagg_mod.out_offsets(ps, elem)
    assert offsets[0] == 0 and all(o * elem % 16 == 0 for o in offsets)
    ends = [o + p for o, p in zip(offsets, ps)]
    assert all(e <= o for e, o in zip(ends, offsets[1:]))
    assert ends[-1] <= total < ends[-1] + 16 // elem


def test_tree_wrapper_launches_nothing_on_cpu_and_keeps_leaf_order():
    tree = {k: _t(v) for k, v in _cnn_stack(n=2, seed=4).items()}
    before = fedagg_mod.fedagg.launches
    got = ops.fedagg_tree(tree, [0.5, 0.5])
    assert fedagg_mod.fedagg.launches == before
    assert list(got) == list(tree)
    for k in tree:
        torch.testing.assert_close(got[k], tree[k].mean(0), atol=1e-7,
                                   rtol=1e-6)


def _ragged(dtype, device, seed=0):
    """Ragged, mixed-alignment leaves: unaligned views, P = 1, P not a
    multiple of the vector width, and aligned vector leaves."""
    rng = np.random.default_rng(seed)
    xs = []
    for s_p_off in [(5, 1, 0), (5, 7, 1), (5, 1001, 3), (5, 4096, 0),
                    (5, 4096, 1), (5, 333, 0), (5, 8, 0), (5, 24, 2)]:
        s, p, off = s_p_off
        base = torch.from_numpy(rng.standard_normal(s * p + off).astype(
            np.float32)).to(dtype).to(device)
        xs.append(base[off:].view(s, p))
    return xs


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["cnn", "ragged", "many"])
@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
def test_leaves_match_plain_on_card(case, dname):
    """fedagg_leaves on the card: within the tolerance of the plain fold,
    bit-equal to one-leaf launches of the same kernel (the per-leaf fold's
    arithmetic), one launch per MAX_LEAVES leaves."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the fedagg kernel is CUDA C++ "
                    "and has no CPU or interpreter mode")
    tdt = DTYPES[dname][0]
    rng = np.random.default_rng(7)
    if case == "cnn":
        xs = [_t(v.reshape(40, -1), tdt).cuda()
              for v in _cnn_stack(n=40, seed=5).values()]
    elif case == "ragged":
        xs = _ragged(tdt, "cuda")
    else:
        xs = _ragged(tdt, "cuda") * 9                  # 72 leaves
    w = _t(rng.random(xs[0].shape[0]).astype(np.float32)).cuda()
    before = fedagg_mod.fedagg.launches
    got = fedagg_mod.fedagg_leaves(xs, w)
    torch.cuda.synchronize()
    assert fedagg_mod.fedagg.launches == before + -(
        -len(xs) // fedagg_mod.MAX_LEAVES)
    for g, x, one, want in zip(got, xs, [fedagg_mod.fedagg(x, w) for x in xs],
                               fedagg_mod.fedagg_leaves_plain(xs, w)):
        assert g.dtype == tdt and g.shape == (x.shape[1],)
        assert torch.equal(g, one)
        np.testing.assert_allclose(g.float().cpu().numpy(),
                                   want.float().cpu().numpy(), **TOL[dname])
