"""Federated LM training driver (port of ``repro.launch.train``), on the
card unless ``--device cpu`` is given.

Trains an architecture of the zoo with FedHAP rounds over synthetic
per-satellite token corpora:

  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
      --rounds 3 --seq 64
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \
      --full --rounds 3 --sats 4 --orbits 2 --seq 1024 --batch-per-sat 2 \
      --local-steps 2
  PYTHONPATH=src python -m repro_torch.launch.train --arch rwkv6-3b \
      --full --rounds 3 --sats 4 --orbits 2 --seq 1024 --batch-per-sat 2 \
      --local-steps 2
  PYTHONPATH=src torchrun --standalone --nproc-per-node 4 \
      -m repro_torch.launch.train --full --rounds 3 --sats 4 --orbits 2 \
      --round-kind fedhap_fused

Same flags as the JAX package's CLI, plus ``--device`` and
``--single-device``. Like the reference, the CLI shards the
satellites over a mesh when the world holds one rank per satellite
(torchrun with ``--nproc-per-node`` equal to ``--sats``, or a multiple of
it, the extra ranks replicating over ``model``): each rank trains its own
satellite's replica and the round is ``--round-kind``'s collective round
(:func:`repro_torch.core.fed_step.build_fed_train_step`). Run alone with
``--sats 1``, it starts a 1-rank group itself (NCCL on the card, gloo on
the CPU, from a ``file://`` store in a temporary directory), so the mesh
path runs on one card as the reference's does on a ``(1, 1)`` mesh.
Otherwise (or with ``--single-device``) a round is
:func:`single_device_round`, the counterpart of the reference's
``_single_device_round``: each satellite's local SGD, then the FedHAP
fold of the S replicas with the closed-form Eq. 14-16 weights in one
``fedagg_leaves`` launch; ``--round-kind`` does not change it, as in the
reference's single-device path. On the card each mixer runs forward and
backward through its kernels: attention through ``flash_attention`` and
``flash_attention_bwd``, RWKV-6's time mix through ``rwkv6_wkv`` and
``rwkv6_wkv_bwd``, Mamba's scan through ``selective_scan`` and
``selective_scan_bwd``. Full-width jamba-v0.1-52b does not fit one card
(52 B params per replica); one replica per card over several cards is
ROADMAP Queue A item 19, and its mixer trains at reduced size here.
"""
from __future__ import annotations

import argparse
import contextlib
import tempfile
import time
from typing import Callable, Iterator, Mapping, Sequence

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint import save_checkpoint
from repro_torch.configs import get_config, list_configs
from repro_torch.core.dissemination import ConstellationMeshMap
from repro_torch.core.fed_step import (FedTrainConfig,
                                       build_fed_train_step, local_sgd,
                                       stack_params)
from repro_torch.core.mesh_round import FedRoundConfig
from repro_torch.core.weights import mu_weights
from repro_torch.data.tokens import TokenTaskConfig, make_token_dataset
from repro_torch.debug.sanitize import to_device
from repro_torch.kernels import ops
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models.transformer import Transformer


def make_batches(cfg, n_sats: int, batch: int, seq: int, step: int,
                 vocab: int, skew: float = 0.3,
                 device: torch.device | str = "cpu",
                 clients: Sequence[int] | None = None) -> dict:
    """Per-satellite next-token batches from the synthetic chain corpus
    (numpy, bit-equal to the reference's), moved to ``device``:
    ``tokens`` and ``labels`` of shape (S, batch, seq), for satellites
    ``0 .. n_sats - 1`` or, given ``clients``, for those only (a rank's
    own shard)."""
    tok_cfg = TokenTaskConfig(vocab_size=vocab, client_skew=skew, seed=7)
    toks = np.stack([
        make_token_dataset(batch * (seq + 1), tok_cfg, client=s,
                           seed_offset=step)
        .reshape(batch, seq + 1)
        for s in (range(n_sats) if clients is None else clients)
    ])
    return {"tokens": torch.from_numpy(toks[:, :, :-1].copy()).to(device),
            "labels": torch.from_numpy(toks[:, :, 1:].copy()).to(device)}


def _ensure_coverage(rng, cmap: ConstellationMeshMap, p: float):
    """Random visibility with >=1 visible satellite per orbit (so rounds
    aggregate; gating still exercised via the mask)."""
    v = rng.random(cmap.total_sats) < p
    k = cmap.sats_per_orbit
    for l in range(cmap.n_orbits * cmap.n_pods):
        if not v[l * k:(l + 1) * k].any():
            v[l * k + rng.integers(k)] = True
    return v


def _mu_weights(visible, sizes, cmap, partial_mode, orbit_weighting
                ) -> np.ndarray:
    """Per-satellite global weights: the closed-form engine
    (``repro_torch.core.weights``) on the host, numpy. The plan stays
    numpy: no device value is read back to compute it."""
    return np.asarray(mu_weights(
        np.asarray(visible), np.asarray(sizes, np.float32),
        cmap.sats_per_orbit, partial_mode, orbit_weighting), np.float32)


def single_device_round(model: Transformer, fed_cfg: FedTrainConfig
                        ) -> Callable:
    """The reference's ``_single_device_round``: returns
    ``step(params_S, batch, sizes, visible) -> (params_S, metrics)``.

    ``params_S`` leaves are satellite-stacked ``(S, ...)`` and are updated
    in place (the reference returns new arrays); ``batch`` leaves are
    ``(S, batch, seq)``; ``sizes`` and ``visible`` are host vectors. Every
    satellite's local SGD (:func:`~repro_torch.core.fed_step.local_sgd`,
    the mesh step's own), then one ``ops.fedagg_tree`` fold with the
    host's μ (one ``fedagg_leaves`` launch on the card) and the global
    copied into every row.

    Metrics as the reference returns them: ``local_loss`` (the last local
    step's mean over satellites, a device scalar: nothing is read back),
    ``gate``, ``covered`` and ``upload_mass``."""
    cmap = fed_cfg.round_cfg.cmap

    def step(params_S: dict, batch: Mapping[str, torch.Tensor], sizes,
             visible):
        loss = local_sgd(model, params_S, batch, fed_cfg.learning_rate,
                         fed_cfg.local_steps)
        mu = _mu_weights(visible, sizes, cmap,
                         fed_cfg.round_cfg.partial_mode,
                         fed_cfg.round_cfg.orbit_weighting)
        with torch.no_grad():
            glob = ops.fedagg_tree(params_S, mu)
            for k, x in params_S.items():
                x.copy_(glob[k].expand_as(x))
        dev = next(iter(params_S.values())).device
        return params_S, {
            "local_loss": loss,
            "gate": torch.ones((), device=dev),
            "covered": torch.zeros((), device=dev),
            "upload_mass": torch.zeros((), device=dev)}

    return step


@contextlib.contextmanager
def _one_rank_group(device: torch.device) -> Iterator[None]:
    """A 1-rank process group of ``device``'s backend, from a ``file://``
    store in a temporary directory (no network), destroyed on exit."""
    with tempfile.TemporaryDirectory() as d:
        if device.type == "cuda" and device.index is not None:
            torch.cuda.set_device(device)
        dist.init_process_group(
            mesh_lib.backend_for(device.type),
            init_method=f"file://{d}/store", rank=0, world_size=1,
            timeout=mesh_lib.DEFAULT_TIMEOUT)
        try:
            yield
        finally:
            dist.destroy_process_group()


def _train_mesh(device: torch.device, n_sats: int):
    """The ``(data, model)`` mesh of one rank per satellite, or None where
    the world holds one rank and more satellites (the single-device
    round). Raises SystemExit on a world that cannot tile the
    satellites, or whose backend is not ``device``'s."""
    from torch.distributed.device_mesh import init_device_mesh
    world = dist.get_world_size()
    if world == 1 and n_sats > 1:
        return None
    if world % n_sats:
        raise SystemExit(f"train: the process group holds {world} ranks; "
                         f"the mesh rounds take one rank per satellite "
                         f"(--sats {n_sats}) or a multiple of it")
    if dist.get_backend() != mesh_lib.backend_for(device.type):
        raise SystemExit(f"train: --device {device} wants the "
                         f"{mesh_lib.backend_for(device.type)} backend, the "
                         f"process group runs {dist.get_backend()}")
    return init_device_mesh(device.type, (n_sats, world // n_sats),
                            mesh_dim_names=("data", "model"))


def main(argv: list[str] | None = None) -> dict:
    """The CLI; returns ``{"losses", "params_S", "path"}``: the per-round
    losses, this rank's satellite-stacked params (``(1, ...)`` leaves on
    the mesh path) and ``"mesh"`` or ``"single_device"``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b", choices=list_configs())
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--sats", type=int, default=4)
    ap.add_argument("--orbits", type=int, default=2)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--batch-per-sat", type=int, default=2)
    ap.add_argument("--local-steps", type=int, default=1)
    ap.add_argument("--lr", type=float, default=0.01)
    ap.add_argument("--round-kind", default="fedhap",
                    choices=["fedhap", "fedhap_fused", "fedavg"])
    ap.add_argument("--partial-mode", default="paper",
                    choices=["paper", "exact"])
    ap.add_argument("--visibility", type=float, default=0.5,
                    help="per-round probability a satellite sees its HAP")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default: the kernels) or cpu (the "
                         "plain versions)")
    ap.add_argument("--single-device", action="store_true",
                    help="time-multiplex every satellite on this device "
                         "(single_device_round) even where the world "
                         "holds one rank per satellite")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("train: --device cuda needs an NVIDIA card; pass "
                         "--device cpu for the plain versions")
    if args.sats % args.orbits:
        raise SystemExit(f"train: --sats {args.sats} is not a multiple of "
                         f"--orbits {args.orbits}")
    with contextlib.ExitStack() as stack:
        if not args.single_device and not dist.is_initialized():
            if (mesh_lib.init_ranks(device.type) is None
                    and args.sats == 1):
                stack.enter_context(_one_rank_group(device))
        return _run(args, device)


def _run(args: argparse.Namespace, device: torch.device) -> dict:
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = Transformer(cfg)
    n_sats = args.sats
    cmap = ConstellationMeshMap(
        n_orbits=args.orbits, sats_per_orbit=n_sats // args.orbits,
        n_pods=1)
    mesh = (None if args.single_device or not dist.is_initialized()
            else _train_mesh(device, n_sats))
    lead = dist.get_rank() == 0 if dist.is_initialized() else True
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if lead:
        print(f"[train] mesh run: {n_sats} satellites over "
              f"{dist.get_world_size()} rank(s), mesh "
              f"{dict(zip(mesh.mesh_dim_names, mesh.shape))}"
              if mesh is not None else
              f"[train] single-device run; logical satellites={n_sats}"
              + (f" (torchrun --nproc-per-node {n_sats} runs one rank "
                 f"per satellite)" if n_sats > 1 else ""))

    fed_cfg = FedTrainConfig(
        round_cfg=FedRoundConfig(cmap=cmap, partial_mode=args.partial_mode,
                                 ship_global_echo=False),
        round_kind=args.round_kind,
        local_steps=args.local_steps,
        learning_rate=args.lr,
    )
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = model.init(gen, device)
    sizes = np.ones((n_sats,), np.float32)
    rng = np.random.default_rng(args.seed)
    if mesh is None:
        params_S = stack_params(params, n_sats)
        step_fn = single_device_round(model, fed_cfg)
        mine = None
    else:
        sat = mesh.get_local_rank("data")
        params_S = stack_params(params, 1)
        step_fn = build_fed_train_step(model, fed_cfg, mesh)
        mine = slice(sat, sat + 1)
    del params

    if lead:
        print(f"[train] {cfg.name}: {model.count_params()/1e6:.1f}M params, "
              f"{n_sats} satellites, {args.round_kind}, device {device}")
    losses = []
    t0 = time.perf_counter()
    for rnd in range(args.rounds):
        visible = _ensure_coverage(rng, cmap, args.visibility)
        if mine is None:
            batch = make_batches(cfg, n_sats, args.batch_per_sat, args.seq,
                                 rnd, cfg.vocab_size, device=device)
            params_S, metrics = step_fn(params_S, batch, sizes, visible)
        else:
            batch = make_batches(cfg, n_sats, args.batch_per_sat, args.seq,
                                 rnd, cfg.vocab_size, device=device,
                                 clients=[mine.start])
            params_S, metrics = step_fn(
                params_S, batch, to_device(sizes[mine], device),
                to_device(visible[mine], device))
        loss = float(metrics["local_loss"])
        losses.append(loss)
        if lead:
            print(f"  round {rnd:4d}  loss {loss:.4f}  "
                  f"gate {float(metrics['gate']):.0f}  "
                  f"({time.perf_counter()-t0:.1f}s)", flush=True)
    if args.ckpt_dir and lead:
        save_checkpoint(args.ckpt_dir, {k: x[0] for k, x in params_S.items()},
                        args.rounds, {"arch": cfg.name})
        print(f"[train] checkpoint written to {args.ckpt_dir}")
    return {"losses": losses, "params_S": params_S,
            "path": "single_device" if mesh is None else "mesh"}


if __name__ == "__main__":
    main()
