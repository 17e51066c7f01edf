"""Cases of ``tests/test_torch_tp_train.py``: the federated train step
tensor-parallel over ``model`` on a ``(data=2, model=2)`` mesh (one
orbit of 2 satellites), the port's gloo ranks against the JAX package's
``build_fed_train_step(..., model_specs=sanitized)`` on 4 forced host
devices, and the training CLI under 4 gloo ranks.

The initial params are the port's seeded init (f32, CPU), written to an
npz by the test and read by both sides; the batches are
``make_batches``' (numpy, bit-equal on both sides). ``python
tests/_torch_tp_train.py jax IN.npz OUT.npz`` runs the JAX half; the
rank halves import no jax.
"""
from __future__ import annotations

import os
import sys

import numpy as np

ARCHS = ("qwen3-0.6b", "rwkv6-3b")
MESH = (2, 2)
STEPS, BATCH, SEQ, LR = 2, 2, 32, 0.1
CLI = ["--device", "cpu", "--rounds", "2", "--seq", "32", "--sats", "2",
       "--orbits", "1", "--batch-per-sat", "2", "--local-steps", "2",
       "--lr", "0.1", "--round-kind", "fedhap_fused"]


def init_params(arch: str) -> dict:
    """The port's seeded init of the reduced ``arch``, flat numpy."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import Transformer
    model = Transformer(get_config(arch).reduced())
    full = model.init(torch.Generator().manual_seed(3), "cpu",
                      torch.float32)
    return {k: v.numpy() for k, v in full.items()}


def visible(step: int) -> np.ndarray:
    return np.array([True, step % 2 == 0])


def _fed_cfg(cmap_cls, round_cls, train_cls):
    cmap = cmap_cls(n_orbits=1, sats_per_orbit=2, n_pods=1)
    return train_cls(round_cfg=round_cls(cmap=cmap, ship_global_echo=False),
                     round_kind="fedhap_fused", local_steps=1,
                     learning_rate=LR)


# ------------------------------------------------------------ port ranks
def step_ranks(rank: int, world: int) -> dict:
    """Every arch's two steps on this rank; returns per arch the data
    index, the losses and the params gathered over ``model`` after each
    step."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import get_config
    from repro_torch.core.dissemination import ConstellationMeshMap
    from repro_torch.core.fed_step import (FedTrainConfig,
                                           build_fed_train_step,
                                           stack_params)
    from repro_torch.core.mesh_round import FedRoundConfig
    from repro_torch.launch.train import make_batches
    from repro_torch.models import Transformer
    from repro_torch.models.sharding import gather_params, shard_params

    mesh = init_device_mesh("cpu", MESH, mesh_dim_names=("data", "model"))
    sat = mesh.get_local_rank("data")
    fed = _fed_cfg(ConstellationMeshMap, FedRoundConfig, FedTrainConfig)
    out = {}
    for arch in ARCHS:
        model = Transformer(get_config(arch).reduced())
        full = {k: torch.from_numpy(v) for k, v in init_params(arch).items()}
        step = build_fed_train_step(model, fed, mesh)
        params = stack_params(shard_params(full, step.axis.specs,
                                           step.axis), 1)
        losses, snaps = [], []
        for i in range(STEPS):
            batch = make_batches(model.cfg, 2, BATCH, SEQ, i,
                                 model.cfg.vocab_size, clients=[sat])
            params, metrics = step(
                params, batch, torch.ones(1),
                torch.from_numpy(visible(i)[sat:sat + 1].copy()))
            losses.append(float(metrics["local_loss"]))
            whole = gather_params({k: v[0] for k, v in params.items()},
                                  step.axis.specs, step.axis)
            snaps.append({k: v.numpy() for k, v in whole.items()})
        out[arch] = {"sat": sat, "losses": losses, "params": snaps,
                     "specs": dict(step.axis.specs)}
    return out


def cli_ranks(rank: int, world: int) -> dict:
    """``launch.train`` on 4 ranks with ``--sats 2``: a ``(data=2,
    model=2)`` mesh; rank 0 then runs the single-device round on both
    satellites with the same flags. Each writes a checkpoint."""
    import pathlib

    from repro_torch.launch import train
    work = pathlib.Path(os.environ["TP_CLI_DIR"])
    res = train.main(CLI + ["--ckpt-dir", str(work / "mesh")])
    out = {"path": res["path"], "losses": res["losses"],
           "shapes": {k: tuple(v.shape) for k, v in res["params_S"].items()}}
    if rank == 0:
        ref = train.main(CLI + ["--single-device", "--ckpt-dir",
                                str(work / "single")])
        out["ref"] = {"path": ref["path"], "losses": ref["losses"]}
        out["ckpt"] = {}
        for tag in ("mesh", "single"):
            with np.load(sorted((work / tag).glob("ckpt_*.npz"))[-1]) as f:
                out["ckpt"][tag] = dict(f)
    return out


# ---------------------------------------------------------------- JAX
def jax_main(inp: str, path: str) -> None:
    import jax
    import jax.numpy as jnp
    from jax.sharding import AxisType, NamedSharding, PartitionSpec as P

    from repro.compat import set_mesh
    from repro.configs import get_config
    from repro.core.dissemination import ConstellationMeshMap
    from repro.core.fed_step import (FedTrainConfig, build_fed_train_step,
                                     stack_params)
    from repro.core.mesh_round import FedRoundConfig
    from repro.launch.specs import sanitize_specs
    from repro.launch.train import make_batches
    from repro.models.transformer import Transformer

    assert jax.device_count() == 4, jax.device_count()
    # Auto axes: GSPMD partitions the step. On an explicit-axes mesh
    # (jax.make_mesh's default here) concrete arrays carry their
    # shardings in their types, and the vocab-sharded embedding's gather
    # then asks for an out_sharding.
    mesh = jax.make_mesh(MESH, ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    fed = _fed_cfg(ConstellationMeshMap, FedRoundConfig, FedTrainConfig)
    out = {}
    with np.load(inp) as f:
        flat = dict(f)
    for arch in ARCHS:
        jm = Transformer(get_config(arch).reduced())
        params = {}
        for key, v in flat.items():
            a, rest = key.split(":", 1)
            if a != arch:
                continue
            node = params
            *path_, name = rest.split("/")
            for part in path_:
                node = node.setdefault(part, {})
            node[name] = jnp.asarray(v)
        example = jax.tree.map(
            lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), params)
        trailing = sanitize_specs(example, jm.specs(), mesh)
        # placed as the reference's make_train_step places them
        params_sh = jax.tree.map(lambda s: NamedSharding(mesh, P("data",
                                                                 *s)),
                                 trailing, is_leaf=lambda x: isinstance(x,
                                                                        P))
        lead = NamedSharding(mesh, P("data"))
        with set_mesh(mesh):
            step = jax.jit(build_fed_train_step(jm, fed, mesh,
                                                model_specs=trailing),
                           in_shardings=(params_sh, lead, lead, lead))
            params_s = jax.device_put(stack_params(params, 2), params_sh)
            for i in range(STEPS):
                batch = make_batches(jm.cfg, 2, BATCH, SEQ, i,
                                     jm.cfg.vocab_size)
                args = jax.device_put(
                    (batch, jnp.ones(2, jnp.float32),
                     jnp.asarray(visible(i))), lead)
                params_s, metrics = step(params_s, *args)
                out[f"{arch}:loss{i}"] = np.asarray(metrics["local_loss"])
                for k, v in _flat(params_s).items():
                    out[f"{arch}:step{i}:{k}"] = np.asarray(v)
    np.savez(path, **out)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


if __name__ == "__main__" and sys.argv[1:2] == ["jax"]:
    os.environ["XLA_FLAGS"] = (
        "--xla_force_host_platform_device_count=4 "
        + os.environ.get("XLA_FLAGS", ""))
    jax_main(sys.argv[2], sys.argv[3])
