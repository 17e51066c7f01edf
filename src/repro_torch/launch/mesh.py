"""Process groups and device meshes for the mesh rounds (port of
``repro.launch.mesh``).

The port runs SPMD over ``torch.distributed``: one process per rank,
each holding its own shard of the satellite axis. A mesh is a
:class:`torch.distributed.device_mesh.DeviceMesh` with the reference's
axis names (``("data",)``, ``("data", "model")`` or ``("pod", "data",
"model")``) over an initialised default process group; its device type
follows the group's backend (NCCL: ``"cuda"``, gloo: ``"cpu"``).

Start the ranks with torchrun, one per card::

  torchrun --standalone --nproc-per-node 4 -m repro_torch.launch.train \
      --full --sats 4 --orbits 2

and call :func:`init_ranks` in each (``repro_torch.launch.train`` does).
Like the reference's, these are functions, never module constants:
importing this module touches no process group.
"""
from __future__ import annotations

import datetime
import math
import os
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.core.dissemination import ConstellationMeshMap

#: How long a rank waits in a collective before it raises.
DEFAULT_TIMEOUT = datetime.timedelta(minutes=10)

_LAUNCH_HINT = ("start one process per rank with torchrun (torchrun "
                "--standalone --nproc-per-node N ...) and call "
                "repro_torch.launch.mesh.init_ranks, or "
                "torch.distributed.init_process_group yourself")


def init_ranks(device: str = "cuda",
               timeout: datetime.timedelta = DEFAULT_TIMEOUT
               ) -> Optional[tuple[int, int]]:
    """Join the process group that torchrun describes (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK`` and its rendezvous address in the
    environment) with the backend of ``device``: NCCL for ``"cuda"``,
    where each rank's card becomes ``cuda:LOCAL_RANK`` (so
    ``SimConfig(device="cuda")`` resolves to it), gloo for ``"cpu"``.

    Returns ``(rank, world_size)``; ``None`` when the environment names no
    world (the process was not started by torchrun). A group that is
    already initialised is kept as it is."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return None
    kind = torch.device(device).type
    if kind == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_ranks(device='cuda') but "
                               "torch.cuda.is_available() is False")
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    dist.init_process_group(backend_for(kind), timeout=timeout)
    return dist.get_rank(), dist.get_world_size()


def backend_for(device_type: str) -> str:
    """The collective backend of a device type: NCCL for CUDA tensors,
    gloo for CPU tensors."""
    if device_type == "cuda":
        return "nccl"
    if device_type == "cpu":
        return "gloo"
    raise ValueError(f"no collective backend for device type "
                     f"{device_type!r}")


def mesh_device_type() -> str:
    """The device type of the initialised default group's backend."""
    backend = dist.get_backend()
    if backend == "nccl":
        return "cuda"
    if backend == "gloo":
        return "cpu"
    raise ValueError(f"unsupported process group backend {backend!r}")


def _world(what: str, need: int) -> None:
    """Raise unless the default group is initialised with ``need`` ranks."""
    if not (dist.is_available() and dist.is_initialized()):
        raise ValueError(f"{what} needs a process group of world size "
                         f"{need}, but torch.distributed is not "
                         f"initialised: {_LAUNCH_HINT}")
    world = dist.get_world_size()
    if world != need:
        raise ValueError(f"{what} needs a process group of world size "
                         f"{need}, not {world}: {_LAUNCH_HINT}")


def _mesh(shape: tuple[int, ...], names: tuple[str, ...]):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(mesh_device_type(), shape,
                            mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False):
    """16x16 = 256 ranks per pod; 2x16x16 = 512 ranks multi-pod (the
    reference's production layout). Raises on any other world size."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    _world("make_production_mesh", math.prod(shape))
    return _mesh(shape, names)


def make_constellation_map(*, multi_pod: bool = False,
                           constellation=None) -> ConstellationMeshMap:
    """Mesh map of the constellation the round aggregates: derived from
    ``constellation``'s plane layout when given
    (:meth:`ConstellationMeshMap.from_constellation`), else the
    production default of 4 orbits x 4 satellites per pod, one HAP per
    pod."""
    n_pods = 2 if multi_pod else 1
    if constellation is not None:
        return ConstellationMeshMap.from_constellation(
            constellation, n_pods=n_pods)
    return ConstellationMeshMap(n_orbits=4, sats_per_orbit=4, n_pods=n_pods)


def make_sim_mesh(n_data: int):
    """1-D ``("data",)`` satellite-sharding mesh for the simulator's fused
    blocks (:class:`repro_torch.sim.executor.FusedExecutor`): ``n_data``
    ranks, each holding a contiguous shard of the stacked satellite axis.
    Raises ``ValueError`` unless the process group holds exactly
    ``n_data`` ranks."""
    if n_data < 1:
        raise ValueError(f"need at least one rank, got {n_data}")
    _world(f"SimConfig(data_shards={n_data})", n_data)
    return _mesh((n_data,), ("data",))


def make_debug_mesh(n_data: int = 4, n_model: int = 2,
                    multi_pod: bool = False):
    """Small mesh for integration tests: ``(n_data, n_model)`` over
    ``("data", "model")``, or ``(2, n_data, n_model)`` over ``("pod",
    "data", "model")``; the world must hold exactly that many ranks."""
    if multi_pod:
        shape, names = (2, n_data, n_model), ("pod", "data", "model")
    else:
        shape, names = (n_data, n_model), ("data", "model")
    _world("make_debug_mesh", math.prod(shape))
    return _mesh(shape, names)


__all__ = ["DEFAULT_TIMEOUT", "backend_for", "init_ranks",
           "make_constellation_map", "make_debug_mesh",
           "make_production_mesh", "make_sim_mesh", "mesh_device_type"]
