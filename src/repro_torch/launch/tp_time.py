"""Time federated LM training tensor-parallel over ``model`` against the
same training replicated over ``model``, on several cards.

Run under torchrun, one rank per card, with the world a multiple of
``--sats``; the mesh is ``launch.train``'s ``(data=sats, model=world //
sats)``:

    torchrun --standalone --nproc-per-node 4 \\
        -m repro_torch.launch.tp_time --arch qwen3-0.6b --sats 2

(``--device cpu --reduced`` rehearses it over gloo on the CPU, where the
times say nothing of a card and no memory is read.)

Both runs start from the same seeded init (``launch.train``'s, full
width), take the same batches and visibilities and run
``build_fed_train_step`` on the same mesh: first with the sanitized
``model.specs()`` (each rank holds and trains its shard of every leaf:
``models/sharding.py``), then with specs that shard nothing (each rank
of a ``model`` group trains the whole replica, as the port did before
tensor parallelism). For each: the per-round losses (``local_loss``),
seconds a round after the first (the host clock around each round,
ended by ``torch.cuda.synchronize``), and each card's peak memory
(``torch.cuda.max_memory_allocated`` after ``reset_peak_memory_stats``,
init included). Rank 0 prints one JSON line with both runs, the largest
relative difference of their losses, and the card's name and power
limit (``nvidia-smi``).
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time
import warnings

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import get_config, list_configs
from repro_torch.core.dissemination import ConstellationMeshMap
from repro_torch.core.fed_step import (FedTrainConfig, build_fed_train_step,
                                       stack_params)
from repro_torch.core.mesh_round import FedRoundConfig
from repro_torch.debug.sanitize import to_device
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.train import _ensure_coverage, make_batches
from repro_torch.models.sharding import sanitize_specs, shard_params
from repro_torch.models.transformer import Transformer


def _run(model, fed_cfg, mesh, specs, args, device) -> dict:
    """One training run on ``mesh`` with ``specs``; this rank's losses,
    seconds per round and peak memory."""
    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda _: None)
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    step = build_fed_train_step(model, fed_cfg, mesh, model_specs=specs)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    full = model.init(gen, device)
    params = stack_params(shard_params(full, step.axis.specs, step.axis), 1)
    del full
    sat = mesh.get_local_rank("data")
    cmap = fed_cfg.round_cfg.cmap
    rng = np.random.default_rng(args.seed)
    sizes = np.ones((args.sats,), np.float32)
    losses, walls = [], []
    for rnd in range(args.rounds):
        visible = _ensure_coverage(rng, cmap, args.visibility)
        batch = make_batches(model.cfg, args.sats, args.batch_per_sat,
                             args.seq, rnd, model.cfg.vocab_size,
                             device=device, clients=[sat])
        sync(device)
        t0 = time.perf_counter()
        params, metrics = step(params, batch,
                               to_device(sizes[sat:sat + 1], device),
                               to_device(visible[sat:sat + 1], device))
        losses.append(float(metrics["local_loss"]))
        sync(device)
        walls.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    del params, step
    if cuda:
        torch.cuda.empty_cache()
    return {"losses": losses, "s_per_round": walls[1:] or walls,
            "peak_bytes": peak,
            "sharded_leaves": sum(1 for s in specs.values() if "model" in s)}


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b", choices=list_configs())
    ap.add_argument("--sats", type=int, default=2)
    ap.add_argument("--orbits", type=int, default=1)
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--batch-per-sat", type=int, default=2)
    ap.add_argument("--local-steps", type=int, default=1)
    ap.add_argument("--lr", type=float, default=0.01)
    ap.add_argument("--visibility", type=float, default=0.5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reduced", action="store_true")
    args = ap.parse_args(argv)

    if mesh_lib.init_ranks(args.device) is None:
        raise SystemExit("tp_time: start it under torchrun, one rank per "
                         "card")
    world = dist.get_world_size()
    if world % args.sats:
        raise SystemExit(f"tp_time: {world} ranks do not tile --sats "
                         f"{args.sats}")
    from torch.distributed.device_mesh import init_device_mesh
    if args.device == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    else:
        device = torch.device(args.device)
    mesh = init_device_mesh(device.type, (args.sats, world // args.sats),
                            mesh_dim_names=("data", "model"))
    cfg = get_config(args.arch)
    model = Transformer(cfg.reduced() if args.reduced else cfg)
    cmap = ConstellationMeshMap(n_orbits=args.orbits,
                                sats_per_orbit=args.sats // args.orbits,
                                n_pods=1)
    fed_cfg = FedTrainConfig(
        round_cfg=FedRoundConfig(cmap=cmap, ship_global_echo=False),
        round_kind="fedhap_fused", local_steps=args.local_steps,
        learning_rate=args.lr)
    sharded = sanitize_specs(model.defs(), model.specs(), mesh)
    whole = {k: (None,) * len(s) for k, s in sharded.items()}
    runs = {"tensor_parallel": _run(model, fed_cfg, mesh, sharded, args,
                                    device),
            "replicated": _run(model, fed_cfg, mesh, whole, args, device)}
    peaks = torch.tensor([[r["peak_bytes"] for r in runs.values()]],
                         dtype=torch.float64, device=device)
    every = torch.empty((world, 2), dtype=torch.float64, device=device)
    with warnings.catch_warnings():
        # torch >= 2.12 renames it all_gather_single; the call is the same.
        warnings.simplefilter("ignore", FutureWarning)
        dist.all_gather_into_tensor(every, peaks)
    out = {}
    if dist.get_rank() == 0:
        card = (subprocess.run(
            ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip() if device.type == "cuda"
            else "cpu (no card)")
        a, b = (np.asarray(runs[k]["losses"]) for k in runs)
        out = {"arch": args.arch, "mesh": dict(zip(mesh.mesh_dim_names,
                                                   mesh.shape)),
               "card": card, "runs": runs,
               "peak_gib_per_card": {
                   k: (every[:, i] / 2**30).tolist()
                   for i, k in enumerate(runs)},
               "max_rel_loss_diff": float(np.max(np.abs(a - b) / np.abs(b)))}
        print(json.dumps(out), flush=True)
    dist.destroy_process_group()
    return out


if __name__ == "__main__":
    main()
