"""The dry run with the params sharded over ``model``
(``launch/dryrun.py``, ``models/sharding.py``) against the JAX package.

- Per-device parameter bytes: one ``prefill_32k`` cell per family
  (dense GQA, MLA, MoE, Mamba + MoE, RWKV-6, whisper's relocated
  embedding) traced on a fake ``(data=2, model=4)`` mesh; the step's
  argument bytes are the params' local shards in bf16, by the JAX
  package's ``sanitize_specs`` on an ``AbstractMesh`` of that shape,
  plus the device's inputs. The artifact's per-leaf specs are the
  reference's and its local shapes the shards'.
- FLOPs: qwen3-0.6b's prefill at full width (B=4, S=128: at 32768
  positions the unrolled JAX program is too large to compile on the
  CPU) on a ``(data=2, model=2)`` mesh, the port's per-device count
  against the JAX package's unrolled prefill compiled with
  ``make_prefill_step``'s shardings on 4 forced host devices
  (``tests/_torch_dryrun_tp.py``). XLA's ``cost_analysis()`` of that
  SPMD program counts the whole mesh (it equals the unsharded program's
  count within 0.0002%), so the device's share is a quarter of it. The
  stated differences of ``tests/test_torch_dryrun.py`` are added to the
  port's count, on the device's heads and vocab shard: XLA's dense
  attention (every (q, k) pair) and its unembedding of every position.
  What is left is XLA's elementwise work: within [0, 3%) (measured:
  0.16%). The port all-reduces once for the embedding and twice a
  layer.
"""
import json
import math
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import get_config as jget
from repro.launch import specs as jspecs
from repro.models.transformer import Transformer as JTransformer
from repro_torch.configs import SHAPES, get_config
from repro_torch.launch import dryrun, specs
from repro_torch.models import sharding as sh
from repro_torch.models.transformer import Transformer

import _torch_dryrun_tp as jside

torch.set_num_threads(2)

HERE = pathlib.Path(__file__).resolve().parent
FAMILIES = ["qwen3-0.6b", "minicpm3-4b", "granite-moe-1b-a400m",
            "jamba-v0.1-52b", "rwkv6-3b", "whisper-small"]
MESH = (2, 4)
ELEMENTWISE_SHARE = 0.03


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


@pytest.mark.parametrize("arch", FAMILIES)
def test_device_param_bytes_are_the_reference_shards(arch):
    jm = JTransformer(jget(arch))
    example = jax.eval_shape(lambda: jm.init(jax.random.key(0),
                                             jnp.bfloat16))
    ref = _flat(jspecs.sanitize_specs(example, jm.specs(),
                                      AbstractMesh(MESH, ("data", "model"))))
    leaves = _flat(example)
    m = MESH[1]
    want_params = 0
    for k, spec in ref.items():
        n = math.prod(leaves[k].shape)
        want_params += 2 * (n // m if "model" in tuple(spec) else n)
    art = dryrun.lower_one(arch, "prefill_32k", False, mesh_shape=MESH)
    cfg = get_config(arch)
    inputs = specs.prefill_input_specs(cfg, SHAPES["prefill_32k"])
    want_inputs = sum(x.numel() * x.element_size() // MESH[0]
                      for x in inputs.values())
    assert (art["memory_analysis"]["argument_size_in_bytes"]
            == want_params + want_inputs)
    assert art["model_axis"] == "sharded" and art["devices"] == 8
    got = art["sharding"]
    assert {k: tuple(s) for k, s in got["specs"].items()} == {
        k: tuple(s) for k, s in ref.items()}
    for k, shape in got["local_shapes"].items():
        assert tuple(shape) == sh.local_shape(leaves[k].shape,
                                              tuple(ref[k]), m)
    assert art["collectives"]["all-reduce"]["count"] > 0


def test_dryrun_records_the_gathered_leaves():
    """qwen3-0.6b at model = 16: its 8 KV heads do not divide, so every
    layer's attention leaves are gathered at use; whisper-small's
    relocated table and head are gathered once a step."""
    art = dryrun.lower_one("qwen3-0.6b", "decode_32k", False)
    names = {k.rsplit("/", 1)[-1] for k in art["sharding"]["gathered"]}
    assert names == {"wq", "wk", "wv", "wo"}
    art = dryrun.lower_one("whisper-small", "decode_32k", False)
    assert {"embed/table", "head"} <= set(art["sharding"]["gathered"])


def test_sharded_prefill_flops_match_xla(tmp_path):
    out = tmp_path / "xla.json"
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "PYTHONPATH": os.pathsep.join(
               [str(HERE.parent / "src"), str(HERE),
                os.environ.get("PYTHONPATH", "")])}
    env.pop("XLA_FLAGS", None)
    res = subprocess.run([sys.executable, str(HERE / "_torch_dryrun_tp.py"),
                          str(out)], capture_output=True, text=True,
                         timeout=600, env=env)
    assert res.returncode == 0, res.stdout + res.stderr
    devices = math.prod(jside.MESH)
    xla = json.loads(out.read_text())["flops"] / devices
    cfg = get_config("qwen3-0.6b")
    model = Transformer(cfg)
    sizes = dict(zip(("data", "model"), jside.MESH))
    m, b = sizes["model"], jside.B // sizes["data"]
    with dryrun.fake_mesh(jside.MESH, ("data", "model")) as mesh:
        params = dryrun.meta_params(model,
                                    specs=specs.model_specs(model, sizes),
                                    m=m)
        tok = torch.empty((b, jside.S), dtype=torch.int32, device="meta")
        _, counts = dryrun.trace(specs.make_prefill_step(model, mesh),
                                 params, {"tokens": tok})
    flash = sum(r["flops"] for r in counts.kernels.values())
    unembed = 2 * b * (jside.S - 1) * cfg.d_model * cfg.vocab_size // m
    dense = (cfg.num_layers * b * (cfg.num_heads // m) * jside.S ** 2
             * 4 * cfg.head_dim)
    expected = counts.flops - flash + unembed + dense
    assert 0 <= (xla - expected) / xla < ELEMENTWISE_SHARE, (xla, expected)
    assert (counts.collectives["all-reduce"]["count"]
            == 1 + 2 * cfg.num_layers)
