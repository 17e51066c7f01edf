"""Cases of the mesh-round tests (``tests/test_torch_mesh_round.py``),
shared by both sides:

- ``python tests/_torch_mesh.py jax OUT.npz`` runs every case through the
  JAX package's ``build_round`` on 8 forced host devices (set before jax
  starts) and writes the outputs;
- :func:`round_ranks` runs the same cases through the port's
  ``build_round`` on 8 gloo ranks (``_torch_dist.spawn``), each rank on
  its own satellite, and returns what each rank holds.

Inputs are made from seeded numpy, so both sides see the same bits. The
JAX half imports jax only under ``__main__``; the rank half imports no
jax.
"""
from __future__ import annotations

import os
import sys

import numpy as np

# single pod: 2 orbits x 4 satellites on a (data=8, model=1) mesh
POD1 = dict(cmap=(2, 4, 1), mesh=(8, 1), names=("data", "model"))
# two pods: 1 orbit x 2 satellites per pod on (pod=2, data=2, model=2)
POD2 = dict(cmap=(1, 2, 2), mesh=(2, 2, 2), names=("pod", "data", "model"))
KINDS = ("fedhap", "fedhap_fused", "fedavg")
TRIALS = 2


def make_params(n: int, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((n, 6, 4)).astype(np.float32),
            "b": rng.standard_normal((n, 4)).astype(np.float32),
            "t": rng.standard_normal((n, 3)).astype(np.float32)}


def _covering(rng, n_orbits: int, k: int) -> np.ndarray:
    visible = rng.random(n_orbits * k) < 0.45
    for l in range(n_orbits):
        if not visible[l * k:(l + 1) * k].any():
            visible[l * k + rng.integers(k)] = True
    return visible


def cases() -> list[dict]:
    """Every case: its name, mesh, map, round config, kind and inputs."""
    out = []
    n = 8
    params = make_params(n, 0)
    rng = np.random.default_rng(3)
    for trial in range(TRIALS):
        visible = _covering(rng, 2, 4)
        sizes = rng.uniform(1, 20, size=n).astype(np.float32)
        for kind in KINDS:
            for mode in ("paper", "exact"):
                for echo in (True, False):
                    out.append(dict(
                        name=f"pod1/t{trial}/{kind}/{mode}/echo{int(echo)}",
                        where=POD1, kind=kind, mode=mode, weighting="paper",
                        hap_ring=True, echo=echo, params=params,
                        sizes=sizes, visible=visible))
            out.append(dict(
                name=f"pod1/t{trial}/{kind}/exact/global", where=POD1,
                kind=kind, mode="exact", weighting="global", hap_ring=True,
                echo=False, params=params, sizes=sizes, visible=visible))
    # Eq. 15 gate: orbit 1 sees no HAP, so the replicas stay as they are
    gate_vis = np.zeros(n, bool)
    gate_vis[:4] = True
    for kind in ("fedhap", "fedhap_fused"):
        out.append(dict(name=f"pod1/gate/{kind}", where=POD1, kind=kind,
                        mode="paper", weighting="paper", hap_ring=True,
                        echo=True, params=params,
                        sizes=np.ones(n, np.float32), visible=gate_vis))
    params2 = make_params(4, 5)
    sizes2 = np.random.default_rng(7).uniform(1, 9, size=4).astype(
        np.float32)
    vis2 = np.array([True, False, True, True])
    for kind in KINDS:
        for mode in ("paper", "exact"):
            for ring in ((True, False) if kind == "fedhap" else (True,)):
                out.append(dict(
                    name=f"pod2/{kind}/{mode}/ring{int(ring)}", where=POD2,
                    kind=kind, mode=mode, weighting="paper", hap_ring=ring,
                    echo=False, params=params2, sizes=sizes2,
                    visible=vis2))
    return out


# ------------------------------------------------------------ port ranks
def _sat_index(mesh, names) -> int:
    """This rank's satellite: ``pod * sats_per_pod + data``."""
    data = mesh.get_local_rank("data")
    if "pod" in names:
        return mesh.get_local_rank("pod") * mesh.shape[1] + data
    return data


def round_ranks(rank: int, world: int) -> dict:
    """Every case through the port's ``build_round`` on this rank, plus
    ``sharded_fold`` of S=5 rows over a (data=4, model=2) mesh. Returns
    ``{case: (satellite, params, stats)}`` and ``{"fold": ...}``."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.core import mesh_round as mr
    from repro_torch.core.dissemination import ConstellationMeshMap
    from repro_torch.kernels.ops import fold_stacked_tree
    from repro_torch.sim.executor import FusedExecutor

    meshes = {}
    for where in (POD1, POD2):
        meshes[where["names"]] = init_device_mesh(
            "cpu", where["mesh"], mesh_dim_names=where["names"])
    out = {}
    for c in cases():
        names = c["where"]["names"]
        mesh = meshes[names]
        cfg = mr.FedRoundConfig(
            cmap=ConstellationMeshMap(*c["where"]["cmap"]),
            partial_mode=c["mode"], orbit_weighting=c["weighting"],
            hap_ring=c["hap_ring"], ship_global_echo=c["echo"])
        s = _sat_index(mesh, names)
        local = {k: torch.from_numpy(v[s:s + 1].copy())
                 for k, v in c["params"].items()}
        fn = mr.build_round(mesh, cfg, None, kind=c["kind"])
        new, stats = fn(local, torch.from_numpy(c["sizes"][s:s + 1]),
                        torch.from_numpy(c["visible"][s:s + 1]))
        out[c["name"]] = (s, {k: v.numpy() for k, v in new.items()},
                          {k: float(v) for k, v in stats.items()})

    # sharded_fold, S=5 padded over data=4 (two rows a rank, the last
    # rank's both dead), replicated over model=2.
    mesh4 = init_device_mesh("cpu", (4, 2), mesh_dim_names=("data", "model"))
    fold = fold_inputs()
    mine = FusedExecutor._pad_sat_axis(
        {"w": fold["w"][None], **{k: v[None] for k, v in
                                  fold["rows"].items()}},
        ["w", *fold["rows"]], 1, 4)
    d = mesh4.get_local_rank("data")
    rows = {k: torch.from_numpy(mine[k][0, 2 * d:2 * d + 2].copy())
            for k in fold["rows"]}
    w = torch.from_numpy(mine["w"][0, 2 * d:2 * d + 2].copy())
    part = fold_stacked_tree(rows, w)
    got = mr.sharded_fold(rows, w, mesh4, ("data",))
    out["fold"] = dict(data=d,
                       part={k: v.numpy() for k, v in part.items()},
                       got={k: v.numpy() for k, v in got.items()})
    return out


def fold_inputs() -> dict:
    rng = np.random.default_rng(11)
    w = rng.random(5).astype(np.float32)
    return {"w": w / w.sum(),
            "rows": {"a": rng.standard_normal((5, 7, 3)).astype(np.float32),
                     "b": rng.standard_normal((5, 5)).astype(np.float32)}}


# ------------------------------------------------------------- LM step
LM_ARGS = ["--device", "cpu", "--rounds", "2", "--seq", "32", "--sats", "4",
           "--orbits", "2", "--batch-per-sat", "2", "--local-steps", "2",
           "--lr", "0.1", "--round-kind", "fedhap_fused"]


def lm_ranks(rank: int, world: int) -> dict:
    """``launch.train`` on 4 ranks, one per satellite (the mesh path of
    ``build_fed_train_step``); rank 0 then runs the single-device round
    on all 4 satellites with the same flags."""
    from repro_torch.launch import train
    res = train.main(LM_ARGS)
    out = {"path": res["path"], "losses": res["losses"],
           "params": {k: v.numpy() for k, v in res["params_S"].items()}}
    if rank == 0:
        ref = train.main(LM_ARGS + ["--single-device"])
        out["ref"] = {"path": ref["path"], "losses": ref["losses"],
                      "params": {k: v.numpy()
                                 for k, v in ref["params_S"].items()}}
    return out


# ---------------------------------------------------------------- JAX
def jax_main(path: str) -> None:
    """Every case through the JAX package's ``build_round`` (8 forced
    host devices); writes ``{case}/{leaf}`` and ``{case}/stat/{name}``."""
    import jax
    import jax.numpy as jnp

    from repro.compat import set_mesh
    from repro.core.dissemination import ConstellationMeshMap
    from repro.core.mesh_round import FedRoundConfig, build_round

    assert jax.device_count() == 8, jax.device_count()
    meshes = {w["names"]: jax.make_mesh(w["mesh"], w["names"])
              for w in (POD1, POD2)}
    fns = {}
    out = {}
    for c in cases():
        mesh = meshes[c["where"]["names"]]
        key = (c["where"]["names"], c["kind"], c["mode"], c["weighting"],
               c["hap_ring"], c["echo"])
        if key not in fns:
            cfg = FedRoundConfig(
                cmap=ConstellationMeshMap(*c["where"]["cmap"]),
                partial_mode=c["mode"], orbit_weighting=c["weighting"],
                hap_ring=c["hap_ring"], ship_global_echo=c["echo"])
            example = {k: v[0] for k, v in c["params"].items()}
            with set_mesh(mesh):
                fns[key] = jax.jit(build_round(mesh, cfg, example,
                                               kind=c["kind"]))
        with set_mesh(mesh):
            new, stats = fns[key](
                {k: jnp.asarray(v) for k, v in c["params"].items()},
                jnp.asarray(c["sizes"]), jnp.asarray(c["visible"]))
        for k, v in new.items():
            out[f"{c['name']}/{k}"] = np.asarray(v)
        for k, v in stats.items():
            out[f"{c['name']}/stat/{k}"] = np.asarray(v)
    np.savez(path, **out)


if __name__ == "__main__" and sys.argv[1:2] == ["jax"]:
    os.environ["XLA_FLAGS"] = (
        "--xla_force_host_platform_device_count=8 "
        + os.environ.get("XLA_FLAGS", ""))
    jax_main(sys.argv[2])
