"""Tensor parallelism over ``model`` (``models/sharding.py``): every
family of the zoo, reduced, on a ``(data=1, model=2)`` gloo mesh against
the port's own unsharded path, and the shards' invariants.

One module fixture spawns 2 gloo ranks (``tests/_torch_dist.py``) that
run every case of ``_torch_tp.CASES``: dense GQA (qwen3-0.6b), MLA
(minicpm3-4b), MoE (granite, qwen3-moe), one jamba period (Mamba + MoE
at own fan-in), RWKV-6 and whisper (its embedding and head relocated by
an odd vocab), each once more with heads (or experts) that 2 does not
divide, and on ``(data=1, model=4)`` the families whose heads 4 divides.
Each case holds the sharded forward's logits and loss, every
leaf's gradient (gathered) and six decode steps' logits (the sharded
caches) to the unsharded ones within ``REL`` of each array's largest
magnitude (measured: at most 6.4e-6, rwkv's gradients; logits 1.2e-6;
the gathering cases' logits bit-equal), and each rank's replicated leaves
after one SGD step bitwise equal across the ``model`` ranks. The
shards are contiguous and gather back bit for bit.
"""
import numpy as np
import pytest
import torch

import _torch_tp as tt
from _torch_dist import spawn
from repro_torch.configs import get_config, list_configs
from repro_torch.models import Transformer
from repro_torch.models import sharding as sh

torch.set_num_threads(2)

NAMES = [c[0] for c in tt.CASES]
REL = 2e-5
#: The leaves each case's layers must gather (by leaf name) and those
#: sanitize_specs relocates; every other sharded leaf stays local.
GATHERED = {
    "dense_split": {"wq", "wk", "wv", "wo"},
    "mla_split": {"w_uq", "w_uk", "w_uv", "wo"},
    "moe_split": {"w_gate", "w_up", "w_down"},
    "jamba_split": {"wq", "wk", "wv", "wo"},
    "rwkv": {"mix_w2", "w_r"},
    "rwkv_split": {"mix_w2", "w_r", "w_k", "w_v", "w_g", "w_o",
                   "decay_w2"},
    "whisper": {"table", "head"},
    "whisper_split": {"wq", "wk", "wv", "wo"},
}
RELOCATED = {"moe_split": {"w_gate", "w_up", "w_down"},
             "whisper": {"table", "head"}}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return spawn("_torch_tp:family_ranks", 2,
                 tmp_path_factory.mktemp("tp"), deadline=300)


@pytest.fixture(scope="module")
def ranks4(tmp_path_factory):
    return spawn("_torch_tp:family_ranks", 4,
                 tmp_path_factory.mktemp("tp4"), deadline=300)


def _close(got, want, what):
    err = float(np.max(np.abs(got - want)))
    scale = float(np.max(np.abs(want)))
    assert err <= REL * scale, (what, err, scale)


def _matches_unsharded(r):
    _close(r["logits_s"], r["logits"], "logits")
    assert r["loss_s"] == pytest.approx(r["loss"], rel=1e-6)
    assert set(r["grads_s"]) == set(r["grads"])
    for k, g in r["grads"].items():
        assert r["grads_s"][k].shape == g.shape, k
        _close(r["grads_s"][k], g, k)
    _close(r["decode_s"], r["decode"], "decode")


def _replicated_equal(ranks, case):
    a = ranks[0][case]["replicated"]
    assert a
    for other in ranks[1:]:
        b = other[case]["replicated"]
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("case", NAMES)
def test_family_matches_unsharded(ranks, case):
    _matches_unsharded(ranks[0][case])


@pytest.mark.parametrize("case", NAMES)
def test_replicated_leaves_stay_bitwise_equal(ranks, case):
    _replicated_equal(ranks, case)


@pytest.mark.parametrize("case", tt.CASES_4)
def test_family_matches_unsharded_at_model_4(ranks4, case):
    """model = 4 where it divides the heads, channels and experts: no
    leaf is gathered."""
    _matches_unsharded(ranks4[0][case])
    _replicated_equal(ranks4, case)
    assert all(not r[case]["gathered"] or case == "rwkv" for r in ranks4)


@pytest.mark.parametrize("case", NAMES)
def test_gathers_only_where_heads_do_not_divide(ranks, case):
    for r in ranks:
        got = r[case]
        names = {k.rsplit("/", 1)[-1] for k in got["gathered"]}
        assert names == GATHERED.get(case, set()), got["gathered"]
        assert ({k.rsplit("/", 1)[-1] for k in got["relocated"]}
                == RELOCATED.get(case, set()))
        assert got["contiguous"] and got["roundtrip"]


@pytest.mark.parametrize("m", [2, 4, 16])
@pytest.mark.parametrize("arch", list_configs())
def test_shards_gather_back_bitwise(arch, m):
    """Every leaf of every arch (reduced values) sharded over m ranks and
    joined again is itself, bit for bit; Mamba's in_proj by its halves."""
    model = Transformer(get_config(arch).reduced())
    full = model.init(torch.Generator().manual_seed(1), "cpu")
    specs = sh.sanitize_specs(model.defs(), model.specs(), {"model": m})
    for k, x in full.items():
        parts = sh.fused_parts(k)
        pieces = [sh.shard_leaf(x, specs[k], m, r, parts) for r in range(m)]
        assert all(p.is_contiguous() for p in pieces)
        assert pieces[0].shape == sh.local_shape(x.shape, specs[k], m)
        assert torch.equal(sh.unshard_leaf(pieces, specs[k], parts), x), k
        npieces = [sh.shard_leaf(x.numpy(), specs[k], m, r, parts)
                   for r in range(m)]
        np.testing.assert_array_equal(
            sh.unshard_leaf(npieces, specs[k], parts), x.numpy())


def test_in_proj_shards_by_its_halves():
    """A rank's in_proj shard holds its own x channels then its own z
    channels, which match conv_w's shard."""
    x = torch.arange(2 * 8).reshape(1, 16).float()       # x: 0..7, z: 8..15
    got = [sh.shard_leaf(x, (None, "model"), 2, r, 2) for r in range(2)]
    assert got[0].tolist() == [[0, 1, 2, 3, 8, 9, 10, 11]]
    assert got[1].tolist() == [[4, 5, 6, 7, 12, 13, 14, 15]]
    assert sh.fused_parts("layers/b0/mixer/in_proj") == 2
    assert sh.fused_parts("layers/b0/mixer/out_proj") == 1


def test_one_rank_axis_is_the_unsharded_path(tmp_path):
    """On a 1-rank group every leaf is its own shard and the sharded
    forward and backward are bit-equal to the unsharded ones."""
    from torch.distributed.device_mesh import init_device_mesh

    from _torch_dist import one_rank_group
    cfg = get_config("qwen3-0.6b").reduced()
    model = Transformer(cfg)
    full = model.init(torch.Generator().manual_seed(0), "cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 8),
                           generator=torch.Generator().manual_seed(2))
    with one_rank_group(tmp_path):
        mesh = init_device_mesh("cpu", (1, 1),
                                mesh_dim_names=("data", "model"))
        specs = sh.sanitize_specs(model.defs(), model.specs(), mesh)
        axis = model.model_axis(mesh, specs)
        outs = []
        for ax in (None, axis):
            p = {k: v.clone().requires_grad_() for k, v in full.items()}
            logits, _ = model.forward(p, tokens, None, ax)
            grads = torch.autograd.grad(logits.square().mean(),
                                        list(p.values()))
            outs.append((logits, grads))
    assert torch.equal(outs[0][0], outs[1][0])
    for a, b in zip(outs[0][1], outs[1][1]):
        assert torch.equal(a, b)
