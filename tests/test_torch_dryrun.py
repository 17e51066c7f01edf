"""The port's dry run on the meta device (``repro_torch.launch.specs`` and
``launch.dryrun``) against the JAX package's.

- Specs: for each of the 10 archs x 4 ``SHAPES``, the port's input specs
  (empty meta tensors) have the shapes and dtypes of the JAX package's
  ``ShapeDtypeStruct``s; the decode caches are compared leaf by leaf
  after ``flatten_defs`` (the JAX cache's ``idx`` is an int32 scalar, the
  port's a Python int at 0); ``use_window_for`` agrees.
- Param counts: ``count_params`` and ``active_param_count`` equal the JAX
  ``Transformer``'s for all 10 archs at full width.
- Collectives: the JAX package's ``build_round`` (``model_specs=None``)
  lowered on 8 forced host devices in a subprocess and read by its
  ``parse_collective_bytes``, against the port's ``build_round`` traced
  on a fake mesh of the same shape, for fedhap (echo on and off),
  fedhap_fused and fedavg on the single-pod ``(data=8, model=1)`` and the
  two-pod ``(pod=2, data=2, model=2)`` maps of ``tests/_torch_mesh.py``.
  The model's leaves are whole multiples of 16 floats, so the port's
  pack alignment adds nothing to them. Compared per kind:
  - all-gather: count equal; bytes equal, but the fused round gathers
    visibility as f32 where XLA gathers a pred: 3 bytes more a
    satellite of the axis.
  - all-reduce: bytes only, since XLA's all-reduce combiner merges them
    (and the port's fused and fedavg rounds read the axis size from the
    group as a host int, where the JAX rounds psum a constant one: 4
    bytes fewer).
  - collective-permute: bytes only, since XLA sends each leaf of a
    permuted tree as its own op where the port packs a hop's message
    into one f32 buffer. There the three scalars (mass, count, ready)
    take 64 bytes each (the pack's alignment) against XLA's 4 + 4 + 1
    (ready a pred), and eager torch sends the last hop's echo, which XLA
    drops as nothing reads it.
- FLOPs: the reduced qwen3-0.6b's prefill and local SGD step (B=2,
  S=128, f32, one satellite), the port's count against
  ``cost_analysis()["flops"]`` of the JAX package's unrolled step on one
  CPU device. Two differences are stated and added to the port's count:
  XLA's attention is dense (every (q, k) pair, the masked half
  included; its backward, by autodiff, 8D a pair with P saved), where
  the port counts the flash kernels' causal pairs (2D + 2Dv forward,
  6D + 4Dv backward, Q·Kᵀ recomputed); and the JAX prefill unembeds
  every position before taking the last, the port's the last only. What
  is left is XLA's count of elementwise work (norms, RoPE, softmax, SiLU,
  the loss), which the port does not count: it must lie in [0, 3%) of
  XLA's total (measured here: 0.9% prefill, 1.3% train).
- Stacked leaves: the full-width minicpm3-4b's local SGD step (one
  satellite, B=2, S=1024, bf16, remat) accesses under 0.6 TB with a temp
  peak under 12.94 GB: each stacked leaf's layers' gradients are stacked
  once (measured here: 0.459 TB, 12.21 GB), where a view per layer fills
  a whole-stack zero gradient and adds it into the leaf's for each of
  the 62 layers (2.356 TB, 12.94 GB).
"""
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jget
from repro.launch import specs as jspecs
from repro.launch.mesh import make_constellation_map as jcmap
from repro.models.transformer import Transformer as JTransformer
from repro.models.transformer import cross_entropy_loss as jloss
from repro_torch.configs import SHAPES, get_config, list_configs
from repro_torch.core import mesh_round as mr
from repro_torch.core.dissemination import ConstellationMeshMap
from repro_torch.core.fed_step import local_sgd
from repro_torch.launch import dryrun, specs
from repro_torch.launch.mesh import make_constellation_map
from repro_torch.models.params import flatten_defs
from repro_torch.models.transformer import Transformer

torch.set_num_threads(2)

HERE = pathlib.Path(__file__).resolve().parent
ARCHS = list_configs()
ELEMENTWISE_SHARE = 0.03
_DTYPES = {"int32": torch.int32, "float32": torch.float32,
           "bfloat16": torch.bfloat16, "bool": torch.bool}


def _same(port, ref) -> None:
    """A meta tensor against a ShapeDtypeStruct: shape and dtype."""
    assert port.device.type == "meta"
    assert tuple(port.shape) == tuple(ref.shape)
    assert port.dtype == _DTYPES[str(ref.dtype)]


@pytest.mark.parametrize("shape_name", list(SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_specs_match_jax(arch, shape_name):
    cfg, jcfg = get_config(arch), jget(arch)
    shape, jshape = SHAPES[shape_name], JSHAPES[shape_name]
    assert specs.use_window_for(cfg, shape) == jspecs.use_window_for(
        jcfg, jshape)
    if shape.mode == "train":
        got = specs.train_input_specs(cfg, shape, make_constellation_map())
        want = jspecs.train_input_specs(jcfg, jshape, jcmap())
        assert sorted(got["batch"]) == sorted(want["batch"])
        for k, v in want["batch"].items():
            _same(got["batch"][k], v)
        for k in ("sizes", "visible"):
            _same(got[k], want[k])
    elif shape.mode == "prefill":
        got = specs.prefill_input_specs(cfg, shape)
        want = jspecs.prefill_input_specs(jcfg, jshape)
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            _same(got[k], v)
    else:
        use_window = specs.use_window_for(cfg, shape)
        got = specs.decode_input_specs(cfg, shape, Transformer(cfg),
                                       use_window)
        want = jspecs.decode_input_specs(jcfg, jshape, JTransformer(jcfg),
                                         use_window)
        _same(got["token"], want["token"])
        cache = flatten_defs(want["cache"])
        assert str(cache.pop("idx").dtype) == "int32"
        assert got["cache"].pop("idx") == 0
        assert sorted(got["cache"]) == sorted(cache)
        for k, v in cache.items():
            _same(got["cache"][k], v)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_match_jax(arch):
    model, ref = Transformer(get_config(arch)), JTransformer(jget(arch))
    assert model.count_params() == ref.count_params()
    assert model.active_param_count() == ref.active_param_count()


# ---------------------------------------------------------- collectives
# The mesh-round cases of tests/_torch_mesh.py: (where, n satellites,
# cmap), with model leaves of 32 and 16 floats.
MESHES = {"pod1": (dict(mesh=(8, 1), names=("data", "model")), 8, (2, 4, 1)),
          "pod2": (dict(mesh=(2, 2, 2), names=("pod", "data", "model")), 4,
                   (1, 2, 2))}
LEAVES = {"w": (8, 4), "b": (16,)}
ROUNDS = [(m, k, e) for m in MESHES
          for k, e in (("fedhap", True), ("fedhap", False),
                       ("fedhap_fused", True), ("fedavg", True))]

JAX_ROUNDS = textwrap.dedent("""
    import os, json, sys
    os.environ['XLA_FLAGS'] = '--xla_force_host_platform_device_count=8'
    import numpy as np, jax, jax.numpy as jnp
    from repro.compat import set_mesh
    from repro.core.dissemination import ConstellationMeshMap
    from repro.core.mesh_round import FedRoundConfig, build_round
    from repro.launch.dryrun import parse_collective_bytes
    cases, leaves = json.loads(sys.argv[1]), json.loads(sys.argv[2])
    out = {}
    for name, mesh_shape, names, n, cmap, kind, echo in cases:
        mesh = jax.make_mesh(tuple(mesh_shape), tuple(names))
        params = {k: jnp.zeros((n, *s), jnp.float32)
                  for k, s in leaves.items()}
        cfg = FedRoundConfig(cmap=ConstellationMeshMap(*cmap),
                             ship_global_echo=echo)
        with set_mesh(mesh):
            fn = jax.jit(build_round(mesh, cfg,
                                     {k: v[0] for k, v in params.items()},
                                     kind=kind))
            hlo = fn.lower(params, jnp.ones(n, jnp.float32),
                           jnp.ones(n, bool)).compile().as_text()
        out[name] = parse_collective_bytes(hlo)
    print('COLLECTIVES:' + json.dumps(out))
""")


def _name(m, kind, echo) -> str:
    return f"{m}/{kind}/echo{int(echo)}"


@pytest.fixture(scope="module")
def jax_collectives():
    cases = [(_name(m, k, e), MESHES[m][0]["mesh"], MESHES[m][0]["names"],
              MESHES[m][1], MESHES[m][2], k, e) for m, k, e in ROUNDS]
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "PYTHONPATH": os.pathsep.join(
               [str(HERE.parent / "src"), os.environ.get("PYTHONPATH", "")])}
    env.pop("XLA_FLAGS", None)
    res = subprocess.run(
        [sys.executable, "-c", JAX_ROUNDS, json.dumps(cases),
         json.dumps(LEAVES)], capture_output=True, text=True, env=env,
        timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    line = next(l for l in res.stdout.splitlines()
                if l.startswith("COLLECTIVES:"))
    return json.loads(line[len("COLLECTIVES:"):])


@pytest.mark.parametrize("m,kind,echo", ROUNDS)
def test_round_collectives_match_jax(jax_collectives, m, kind, echo):
    where, _, cmap = MESHES[m]
    with dryrun.fake_mesh(where["mesh"], where["names"]) as mesh:
        cfg = mr.FedRoundConfig(cmap=ConstellationMeshMap(*cmap),
                                ship_global_echo=echo)
        fn = mr.build_round(mesh, cfg, None, kind=kind)
        params = {k: torch.empty((1, *s), device="meta")
                  for k, s in LEAVES.items()}
        _, counts = dryrun.trace(
            fn, params, torch.empty(1, device="meta"),
            torch.empty(1, dtype=torch.bool, device="meta"))
    got, want = counts.collectives, jax_collectives[_name(m, kind, echo)]
    model_bytes = 4 * sum(torch.Size(s).numel() for s in LEAVES.values())
    n_data = where["mesh"][list(where["names"]).index("data")]
    hops = ConstellationMeshMap(*cmap).sats_per_orbit
    for op in ("reduce-scatter", "all-to-all"):
        assert got[op]["count"] == want[op]["count"] == 0
    assert got["all-gather"]["count"] == want["all-gather"]["count"]
    fused = kind == "fedhap_fused"
    assert got["all-gather"]["bytes"] == (want["all-gather"]["bytes"]
                                          + (3 * n_data if fused else 0))
    assert got["all-reduce"]["bytes"] == (want["all-reduce"]["bytes"]
                                          - (4 if kind != "fedhap" else 0))
    permute = (hops * (3 * 64 - 9) + (model_bytes if echo else 0)
               if kind == "fedhap" else 0)
    assert got["collective-permute"]["bytes"] == (
        want["collective-permute"]["bytes"] + permute)
    if kind == "fedhap":
        pods = ConstellationMeshMap(*cmap).n_pods
        assert got["collective-permute"]["count"] == hops + 2 * (pods - 1)
    else:
        assert got["collective-permute"]["count"] == 0


# ---------------------------------------------------------------- FLOPs
B, S = 2, 128


def _xla_flops(fn, *args) -> float:
    cost = jax.jit(fn).lower(*args).compile().cost_analysis()
    cost = cost[0] if isinstance(cost, (list, tuple)) else cost
    return float(cost["flops"])


def _dense_attention(cfg, backward: bool) -> int:
    """XLA's attention FLOP for every (q, k) pair of every layer: Q·Kᵀ and
    P·V forward (4D a pair), and by autodiff dP, dV, dQ, dK (8D)."""
    per_pair = 4 * cfg.head_dim + (8 * cfg.head_dim if backward else 0)
    return cfg.num_layers * B * cfg.num_heads * S * S * per_pair


@pytest.mark.parametrize("mode", ["prefill", "train"])
def test_flops_match_xla(mode):
    cfg = get_config("qwen3-0.6b").reduced()
    jm = JTransformer(jget("qwen3-0.6b").reduced())
    jparams = jax.eval_shape(lambda: jm.init(jax.random.key(0),
                                             jnp.float32))
    tok = jax.ShapeDtypeStruct((B, S), jnp.int32)
    model = Transformer(cfg)
    meta = {"device": "meta", "dtype": torch.int32}
    if mode == "prefill":
        def jax_step(p, t):
            return jm.forward(p, t, None, unroll=True)[0][:, -1, :]
        xla = _xla_flops(jax_step, jparams, tok)
        _, counts = dryrun.trace(
            specs.make_prefill_step(model),
            dryrun.meta_params(model, dtype=torch.float32),
            {"tokens": torch.empty((B, S), **meta)})
        unembed = 2 * B * (S - 1) * cfg.d_model * cfg.vocab_size
    else:
        def jax_step(p, batch):
            def loss(p):
                logits, aux = jm.forward(p, batch["tokens"], None,
                                         unroll=True)
                return jloss(logits, batch["labels"]) + aux
            value, g = jax.value_and_grad(loss)(p)
            return jax.tree.map(lambda a, b: a - 0.01 * b, p, g), value
        xla = _xla_flops(jax_step, jparams, {"tokens": tok, "labels": tok})
        batch = {k: torch.empty((1, B, S), **meta)
                 for k in ("tokens", "labels")}
        _, counts = dryrun.trace(
            lambda p, b: local_sgd(model, p, b, 0.01, 1),
            dryrun.meta_params(model, (1,), dtype=torch.float32), batch)
        unembed = 0
    flash = sum(r["flops"] for r in counts.kernels.values())
    expected = (counts.flops - flash + unembed
                + _dense_attention(cfg, mode == "train"))
    assert 0 <= (xla - expected) / xla < ELEMENTWISE_SHARE, (xla, expected)


# -------------------------------------------------------- stacked leaves
def test_train_step_stacks_each_leafs_gradient_once():
    cfg = get_config("minicpm3-4b")
    assert cfg.remat and cfg.param_dtype == "bfloat16"
    model = Transformer(cfg)
    batch = {k: torch.empty((1, 2, 1024), device="meta", dtype=torch.int32)
             for k in ("tokens", "labels")}
    _, counts = dryrun.trace(
        lambda p, b: local_sgd(model, p, b, 0.01, 1),
        dryrun.meta_params(model, (1,), dtype=torch.bfloat16), batch)
    assert counts.bytes < 0.6e12, counts.bytes
    assert counts.temp_bytes < 12.94e9, counts.temp_bytes
