"""The port's federated LM training (``repro_torch.launch.train``,
``repro_torch.core.fed_step``) against the JAX package's single-device
round (``repro.launch.train._single_device_round``), mirroring
``tests/test_fed_train.py``.

Reduced qwen3-0.6b (2 layers, d_model 256, f32), 4 satellites over 2
orbits, sequence 32, 2 local steps, lr 0.1 (and the round test also at
reduced rwkv6-3b, reduced jamba-v0.1-52b and reduced minicpm3-4b, whose
MLA attends through the flash pair (24, 16), below): params made by the JAX
package and carried into the port with ``params_from_numpy``, batches
bit-equal (numpy), the same visibility draws. Tolerance of the two
rounds: losses ``rtol=1e-6`` and every leaf ``atol=5e-6`` after two
rounds of 2 SGD steps and a fold: both sides are full f32 and differ
only in the order of their sums (the port's attention on the CPU is the
dense plain version and its autograd, the JAX package's the blockwise
jnp loop and ``jax.grad``); per-step differences of a few f32 ulps in
the grads move the O(0.05-1) params by ~lr·|Δg|. Measured here: losses
within 9e-8 relative, leaves within 4.8e-7.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import load_checkpoint as jax_load_checkpoint
from repro.configs import get_config as jax_get_config
from repro.core.dissemination import ConstellationMeshMap as JaxCmap
from repro.core.fed_step import FedTrainConfig as JaxFedTrainConfig
from repro.core.fed_step import stack_params as jax_stack_params
from repro.core.mesh_round import FedRoundConfig as JaxFedRoundConfig
from repro.launch import train as jax_train
from repro.models import Transformer as JaxTransformer
from repro_torch.configs import get_config
from repro_torch.core.dissemination import ConstellationMeshMap
from repro_torch.core.fed_step import (FedTrainConfig, satellite_loss,
                                       stack_params, unstack_params)
from repro_torch.core.mesh_round import FedRoundConfig
from repro_torch.launch import train
from repro_torch.models import Transformer, params_from_numpy
from repro_torch.models import transformer

from _torch_jamba import JAMBA, jamba_pair
from _torch_zoo import aux_inputs, zoo_pair

torch.set_num_threads(2)

ARCH = "qwen3-0.6b"
# MLA (q·k 24, v 16 at reduced size: the flash pair (24, 16)).
MLA = "minicpm3-4b"
# An encoder-decoder stack: the decoder's and the encoder's stacks.
WHISPER = "whisper-small"
N_SATS, BATCH, SEQ = 4, 2, 32
LOSS_TOL = dict(rtol=1e-6, atol=0)
LEAF_TOL = dict(atol=5e-6, rtol=0)
# rwkv6-3b: the JAX package's mixer is the chunked form ``_wkv_chunk``
# (cumulative log decays inside a chunk of 16, exp'd back), the port's
# the sequential recurrence: their f32 roundings differ by ~1e-6 relative
# per WKV output, more than attention's sums in another order, and the two
# SGD steps at lr 0.1 carry that into the embedding rows. Measured here:
# losses within 1.05e-6 relative, leaves within 1.5e-5 (embed/table,
# |leaf| up to 6). jamba (own fan-in) meets qwen3-0.6b's tolerance:
# 4.7e-7 and 2.0e-6.
ROUND_TOL = {"rwkv6-3b": (dict(rtol=5e-6, atol=0), dict(atol=5e-5, rtol=0))}


def _fed_cfgs(local_steps=2, lr=0.1):
    cmap = ConstellationMeshMap(n_orbits=2, sats_per_orbit=2, n_pods=1)
    jcmap = JaxCmap(n_orbits=2, sats_per_orbit=2, n_pods=1)
    return (FedTrainConfig(round_cfg=FedRoundConfig(
                cmap=cmap, ship_global_echo=False),
                learning_rate=lr, local_steps=local_steps),
            JaxFedTrainConfig(round_cfg=JaxFedRoundConfig(
                cmap=jcmap, ship_global_echo=False),
                learning_rate=lr, local_steps=local_steps))


def _reduced_pair(arch: str):
    """(port model, JAX model, JAX params) of ``arch``'s reduced config;
    jamba's params at own fan-in (``tests/_torch_jamba.py``)."""
    if arch == JAMBA:
        tm, jm, jp, _ = jamba_pair()
        return tm, jm, jp
    if arch == MLA:
        tm, jm, jp, _ = mla_pair()
        return tm, jm, jp
    jm = JaxTransformer(jax_get_config(arch).reduced())
    return Transformer(get_config(arch).reduced()), jm, \
        jm.init(jax.random.key(0))


def mla_pair():
    """The reduced minicpm3-4b at own fan-in (``chip_smoke
    .own_fan_in_factors`` applied to the JAX-made params, as
    ``tests/_torch_zoo.py`` does for whisper-small): at the reference's
    init (every stacked matrix at std 1/sqrt(2)) its MLA layers put out
    |y| ~ 100 on unit inputs, and two rounds of SGD at lr 0.1 carry the
    f32 sums' order into the losses at 1.2e-3 relative (the first
    round's at 2.9e-6); at own fan-in both stay within ``LOSS_TOL``."""
    return zoo_pair(MLA, own_fan_in=True)


@pytest.fixture(scope="module")
def pair():
    """(port model, JAX model, JAX params) of the reduced config."""
    return _reduced_pair(ARCH)


def _port_params(jp):
    return params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _flat_jax(tree) -> dict:
    """The JAX package's nested params as the port's flat keys."""
    return {k: np.asarray(v) for k, v in
            params_from_numpy(jax.tree.map(np.asarray, tree),
                              "cpu").items()}


# -------------------------------------------------------------- batches
@pytest.mark.parametrize("step", [0, 3])
def test_make_batches_bit_equal(step):
    cfg = get_config(ARCH).reduced()
    got = train.make_batches(cfg, N_SATS, BATCH, SEQ, step, cfg.vocab_size)
    want = jax_train.make_batches(jax_get_config(ARCH).reduced(), N_SATS,
                                  BATCH, SEQ, step, cfg.vocab_size)
    for k in ("tokens", "labels"):
        assert got[k].shape == (N_SATS, BATCH, SEQ)
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


@pytest.mark.parametrize("p", [0.0, 0.3, 0.5, 1.0])
def test_ensure_coverage_bit_equal(p):
    cmap = ConstellationMeshMap(n_orbits=3, sats_per_orbit=4, n_pods=1)
    jcmap = JaxCmap(n_orbits=3, sats_per_orbit=4, n_pods=1)
    r1, r2 = np.random.default_rng(11), np.random.default_rng(11)
    for _ in range(6):
        got = train._ensure_coverage(r1, cmap, p)
        np.testing.assert_array_equal(got,
                                      jax_train._ensure_coverage(r2, jcmap, p))
        assert got.reshape(3, 4).any(axis=1).all()


@pytest.mark.parametrize("mode", ["paper", "exact"])
@pytest.mark.parametrize("weighting", ["paper", "global"])
def test_mu_weights_match_reference(mode, weighting):
    cmap = ConstellationMeshMap(n_orbits=2, sats_per_orbit=4, n_pods=1)
    jcmap = JaxCmap(n_orbits=2, sats_per_orbit=4, n_pods=1)
    rng = np.random.default_rng(5)
    for _ in range(5):
        vis = train._ensure_coverage(rng, cmap, 0.5)
        sizes = rng.uniform(1, 9, 8).astype(np.float32)
        got = train._mu_weights(vis, sizes, cmap, mode, weighting)
        want = np.asarray(jax_train._mu_weights(
            jnp.asarray(vis), jnp.asarray(sizes), jcmap, mode, weighting))
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(float(got.sum()), 1.0, rtol=1e-6)


# ------------------------------------------------------------ fed_step
def test_stack_params_makes_real_copies():
    params = {"a": torch.arange(6.0).view(2, 3), "b": torch.ones(4)}
    stacked = stack_params(params, 3)
    assert stacked["a"].shape == (3, 2, 3)
    stacked["a"][1].add_(1.0)
    assert torch.equal(stacked["a"][0], params["a"])
    assert torch.equal(stacked["a"][1], params["a"] + 1)
    assert all(x.is_contiguous() for x in stacked.values())
    one = unstack_params(stacked, 2)
    assert torch.equal(one["b"], params["b"])


def test_satellite_loss_matches_reference(pair):
    model, jm, jp = pair
    cfg = model.cfg
    batch = train.make_batches(cfg, 1, BATCH, SEQ, 0, cfg.vocab_size)
    one = {k: v[0] for k, v in batch.items()}
    got = satellite_loss(model, _port_params(jp), one)
    from repro.core.fed_step import satellite_loss as jax_loss
    want = jax_loss(jm, jp, {k: jnp.asarray(v.numpy())
                             for k, v in one.items()})
    np.testing.assert_allclose(float(got), float(want), **LOSS_TOL)


def test_mesh_paths_raise_naming_their_item(tmp_path, pair):
    """Outside a process group the mesh entry points raise ValueError; on
    a 1-rank gloo group ``build_round`` and the train step run (the
    many-rank cases: ``tests/test_torch_mesh_round.py``)."""
    from torch.distributed.device_mesh import init_device_mesh

    from _torch_dist import one_rank_group
    from repro_torch.core import fed_step, mesh_round
    one = FedRoundConfig(cmap=ConstellationMeshMap(1, 1, 1))
    with pytest.raises(ValueError, match="not initialised"):
        mesh_round.build_round(None, one, None)
    with pytest.raises(ValueError, match="not initialised"):
        mesh_round.sharded_fold({"w": torch.ones(1, 2)}, [1.0], None)
    with pytest.raises(ValueError, match="not initialised"):
        fed_step.build_fed_train_step(pair[0], FedTrainConfig(), None)
    model, _, jp = pair
    with one_rank_group(tmp_path):
        mesh = init_device_mesh("cpu", (1, 1),
                                mesh_dim_names=("data", "model"))
        p = {"w": torch.randn(1, 3), "b": torch.randn(1, 2)}
        new, stats = mesh_round.build_round(mesh, one, None)(
            p, torch.ones(1), torch.ones(1, dtype=torch.bool))
        assert all(torch.equal(new[k], p[k]) for k in p)
        assert float(stats["gate"]) == 1.0
        step = fed_step.build_fed_train_step(
            model, FedTrainConfig(round_cfg=one, learning_rate=0.1), mesh)
        batch = train.make_batches(model.cfg, 1, BATCH, SEQ, 0,
                                   model.cfg.vocab_size)
        params, metrics = step(stack_params(_port_params(jp), 1), batch,
                               torch.ones(1), torch.ones(1, dtype=torch.bool))
        assert set(metrics) == {"local_loss", "gate", "covered",
                                "upload_mass"}
        assert np.isfinite(float(metrics["local_loss"]))
        assert all(torch.isfinite(x).all() for x in params.values())


# --------------------------------------------------------------- round
def _run_both(pair, rounds: int, vis_seed: int = 0):
    """``rounds`` rounds of the port and of the JAX package from the same
    params, batches and visibility; returns per-round losses and the
    final params (flat numpy) of both."""
    model, jm, jp = pair
    cfg = model.cfg
    fed, jfed = _fed_cfgs()
    step = train.single_device_round(model, fed)
    jstep = jax.jit(jax_train._single_device_round(jm, jfed))
    params_S = stack_params(_port_params(jp), N_SATS)
    jparams_S = jax_stack_params(jp, N_SATS)
    sizes = np.ones(N_SATS, np.float32)
    rng = np.random.default_rng(vis_seed)
    cmap = fed.round_cfg.cmap
    losses, jlosses = [], []
    for rnd in range(rounds):
        batch = train.make_batches(cfg, N_SATS, BATCH, SEQ, rnd,
                                   cfg.vocab_size)
        jbatch = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
        vis = train._ensure_coverage(rng, cmap, 0.5)
        params_S, m = step(params_S, batch, sizes, vis)
        jparams_S, jm_ = jstep(jparams_S, jbatch, jnp.asarray(sizes),
                               jnp.asarray(vis))
        losses.append(float(m["local_loss"]))
        jlosses.append(float(jm_["local_loss"]))
        assert set(m) == set(jm_)
    return (losses, {k: v.numpy() for k, v in params_S.items()},
            jlosses, _flat_jax(jparams_S))


@pytest.mark.parametrize("arch", [ARCH, "rwkv6-3b", JAMBA, MLA])
def test_two_rounds_match_jax_single_device_round(arch, pair):
    """Two rounds of each family's mixer: attention (qwen3-0.6b), the
    WKV recurrence (rwkv6-3b; the JAX package's chunked ``_wkv_chunk``,
    whose clamp does not bind at the init's decays and chunk 16), the
    Mamba scan with MoE (jamba at own fan-in) and MLA (minicpm3-4b at own
    fan-in: q·k 24, v 16, the port's split flash pair)."""
    p = pair if arch == ARCH else _reduced_pair(arch)
    losses, got, jlosses, want = _run_both(p, 2)
    loss_tol, leaf_tol = ROUND_TOL.get(arch, (LOSS_TOL, LEAF_TOL))
    np.testing.assert_allclose(losses, jlosses, **loss_tol)
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k], want[k], **leaf_tol, err_msg=k)


def test_round_synchronizes_replicas(pair):
    model, _, jp = pair
    cfg = model.cfg
    fed, _ = _fed_cfgs()
    step = train.single_device_round(model, fed)
    params_S = stack_params(_port_params(jp), N_SATS)
    batch = train.make_batches(cfg, N_SATS, BATCH, SEQ, 0, cfg.vocab_size)
    vis = np.array([True, False, True, True])
    new_S, metrics = step(params_S, batch, np.ones(N_SATS, np.float32), vis)
    assert new_S is params_S                    # updated in place
    for k, leaf in new_S.items():
        for s in range(1, N_SATS):
            assert torch.equal(leaf[s], leaf[0]), k
    assert float(metrics["gate"]) == 1.0


def test_fed_training_reduces_loss(pair):
    model, _, jp = pair
    cfg = model.cfg
    fed, _ = _fed_cfgs()
    step = train.single_device_round(model, fed)
    params_S = stack_params(_port_params(jp), N_SATS)
    rng = np.random.default_rng(0)
    losses = []
    for rnd in range(8):
        batch = train.make_batches(cfg, N_SATS, BATCH, SEQ, rnd,
                                   cfg.vocab_size)
        vis = train._ensure_coverage(rng, fed.round_cfg.cmap, 0.5)
        params_S, m = step(params_S, batch, np.ones(N_SATS, np.float32), vis)
        losses.append(float(m["local_loss"]))
    assert np.mean(losses[-3:]) < np.mean(losses[:3]), losses


@pytest.mark.parametrize("arch", [ARCH, "rwkv6-3b", JAMBA, MLA])
def test_remat_gives_the_same_gradients(arch, pair):
    """``cfg.remat`` recomputes each period in the backward: the same
    loss and gradients, bit for bit on the CPU, for each family's mixer
    (the Mamba mixer's in-place ``exp_`` of abar included)."""
    model, _, jp = pair if arch == ARCH else _reduced_pair(arch)
    params = _port_params(jp)
    batch = train.make_batches(model.cfg, 1, BATCH, SEQ, 0,
                               model.cfg.vocab_size)
    one = {k: v[0] for k, v in batch.items()}
    out = []
    for remat in (False, True):
        m = Transformer(dataclasses.replace(model.cfg, remat=remat))
        p = {k: v.clone().requires_grad_() for k, v in params.items()}
        loss = satellite_loss(m, p, one)
        out.append((loss.detach(), torch.autograd.grad(loss, list(p.values()))))
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(out[0][1], out[1][1]):
        assert torch.equal(a, b)


def _index_path(params: dict, *prefixes: str) -> dict:
    """The per-layer index path in place of ``transformer._split``: the
    stacked leaves themselves, which ``_layer`` then indexes once per
    layer (``leaf[i]``)."""
    return {k: v for k, v in params.items() if k.startswith(prefixes)}


def _leaf_nodes(loss: torch.Tensor, leaves: dict) -> tuple[dict, dict]:
    """For each key of ``leaves``: the ``UnbindBackward0`` and the
    ``SelectBackward0`` nodes of ``loss``'s graph whose input is that
    leaf."""
    key_of = {id(v): k for k, v in leaves.items()}
    unbind = {k: 0 for k in leaves}
    select = {k: 0 for k in leaves}
    seen, todo = set(), [loss.grad_fn]
    while todo:
        node = todo.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        nxt = [n for n, _ in node.next_functions]
        kind = {"UnbindBackward0": unbind,
                "SelectBackward0": select}.get(node.name())
        if kind is not None:
            var = getattr(nxt[0], "variable", None)
            if id(var) in key_of:
                kind[key_of[id(var)]] += 1
        todo.extend(nxt)
    return unbind, select


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("arch", [ARCH, "rwkv6-3b", JAMBA, MLA, WHISPER])
def test_stacked_leaves_split_once_per_forward(arch, remat, pair,
                                               monkeypatch):
    """A forward splits each stacked leaf once (``transformer._split``)
    and hands layer i its i-th piece: the loss and every gradient bit for
    bit those of the per-layer index path ``leaf[i]`` (each slice of whose
    gradient is its layer's plus zeros), for each family, the encoder's
    stack included, with remat off and on; the graph holds one
    ``UnbindBackward0`` per stacked leaf and no ``SelectBackward0`` on
    one, where the index path holds one ``SelectBackward0`` per layer."""
    if arch == WHISPER:
        model, _, _, params = zoo_pair(WHISPER)
    else:
        model, _, jp = pair if arch == ARCH else _reduced_pair(arch)
        params = _port_params(jp)
    model = Transformer(dataclasses.replace(model.cfg, remat=remat))
    batch = train.make_batches(model.cfg, 1, BATCH, SEQ, 0,
                               model.cfg.vocab_size)
    one = {k: v[0] for k, v in batch.items()}
    if model.cfg.is_encdec:
        one["frames"] = torch.from_numpy(
            aux_inputs(model.cfg, BATCH)["frames"])
    stacked = ("layers/", "encoder/layers/")
    out = []
    for split in (True, False):
        if not split:
            monkeypatch.setattr(transformer, "_split", _index_path)
        p = {k: v.clone().requires_grad_() for k, v in params.items()}
        loss = satellite_loss(model, p, one)
        unbind, select = _leaf_nodes(
            loss, {k: v for k, v in p.items() if k.startswith(stacked)})
        out.append((loss.detach(),
                    torch.autograd.grad(loss, list(p.values()))))
        n_layers = {k: p[k].shape[0] for k in unbind}
        if split:
            assert unbind == {k: 1 for k in unbind}
            assert select == {k: 0 for k in select}
        else:
            assert unbind == {k: 0 for k in unbind}
            assert select == n_layers
    assert any(k.startswith("encoder/") for k in unbind) == \
        model.cfg.is_encdec
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(out[0][1], out[1][1]):
        assert torch.equal(a, b)


# ----------------------------------------------------------------- CLI
def test_cli_on_cpu_writes_a_checkpoint_the_reference_loads(tmp_path, pair):
    res = train.main(["--device", "cpu", "--rounds", "2", "--seq", "16",
                      "--batch-per-sat", "1", "--ckpt-dir", str(tmp_path)])
    assert len(res["losses"]) == 2 and np.isfinite(res["losses"]).all()
    _, jm, jp = pair
    tree, manifest = jax_load_checkpoint(tmp_path, jp)
    assert manifest["step"] == 2
    assert manifest["metadata"] == {"arch": "qwen3-0.6b-reduced"}
    got = _flat_jax(tree)
    for k, leaf in res["params_S"].items():
        np.testing.assert_array_equal(got[k], leaf[0].numpy(), err_msg=k)


def test_cli_trains_mla_on_cpu():
    """``--arch minicpm3-4b`` with the CLI's defaults but the device (the
    reduced config: MLA with q·k 24 and v 16, f32): two rounds, finite
    losses, the single-device path, rows equal after each fold."""
    res = train.main(["--arch", MLA, "--device", "cpu", "--rounds", "2",
                      "--seq", "32"])
    assert res["path"] == "single_device"
    assert len(res["losses"]) == 2 and np.isfinite(res["losses"]).all()
    for k, leaf in res["params_S"].items():
        assert all(torch.equal(leaf[s], leaf[0])
                   for s in range(1, leaf.shape[0])), k


def test_cli_rejects_sats_not_a_multiple_of_orbits():
    with pytest.raises(SystemExit):
        train.main(["--device", "cpu", "--sats", "5", "--orbits", "2",
                    "--rounds", "1"])


# ------------------------------------------------------- dissemination
@pytest.mark.parametrize("shape", [(2, 2, 1), (4, 4, 1), (3, 5, 2)])
def test_mesh_map_matches_reference(shape):
    from repro.core import dissemination as jd
    from repro_torch.core import dissemination as td
    L, k, pods = shape
    cm, jcm = (td.ConstellationMeshMap(L, k, pods),
               jd.ConstellationMeshMap(L, k, pods))
    assert (cm.sats_per_pod, cm.total_sats) == (jcm.sats_per_pod,
                                                jcm.total_sats)
    for d in range(cm.sats_per_pod):
        assert (cm.orbit_of(d), cm.slot_of(d)) == (jcm.orbit_of(d),
                                                   jcm.slot_of(d))
    for direction in (1, -1):
        assert cm.ring_permutation(direction) == \
            jcm.ring_permutation(direction)
    assert td.hap_chain_down(pods + 2) == jd.hap_chain_down(pods + 2)
    assert td.hap_chain_up(pods + 2) == jd.hap_chain_up(pods + 2)

    class Shell:
        num_orbits, sats_per_orbit = L * pods, k
    assert td.ConstellationMeshMap.from_constellation(Shell, pods) == cm
    cm.validate_mesh({"data": cm.sats_per_pod, "pod": pods})
    with pytest.raises(ValueError, match="cannot tile"):
        cm.validate_mesh({"data": cm.sats_per_pod + 1, "pod": pods})
    with pytest.raises(ValueError, match="whole number"):
        td.ConstellationMeshMap.from_constellation(Shell, L * pods + 1)
