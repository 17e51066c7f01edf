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

Same flags as the JAX package's CLI, plus ``--device``. A round is
:func:`single_device_round`, the counterpart of the reference's
``_single_device_round``: each satellite's local SGD, then the FedHAP
fold of the S replicas with the closed-form Eq. 14-16 weights in one
``fedagg_leaves`` launch. On the card each mixer runs forward and
backward through its kernels: attention through ``flash_attention`` and
``flash_attention_bwd``, RWKV-6's time mix through ``rwkv6_wkv`` and
``rwkv6_wkv_bwd``, Mamba's scan through ``selective_scan`` and
``selective_scan_bwd``. Full-width jamba-v0.1-52b does not fit one card
(S >= 2 replicas of 52 B params); its mixer trains at reduced size here,
and full width waits on one replica per card (ROADMAP Queue A item 12). The reference shards satellites over a
device mesh when it has one device per satellite (``build_fed_train_step``);
the mesh rounds wait on ROADMAP Queue A item 12, so the port runs the
single-device round on any number of devices, and ``--round-kind``
(which names a mesh round) does not change it, as in the reference's
single-device path.
"""
from __future__ import annotations

import argparse
import time
from typing import Callable, Mapping

import numpy as np
import torch

from repro_torch.checkpoint import save_checkpoint
from repro_torch.configs import get_config, list_configs
from repro_torch.core.dissemination import ConstellationMeshMap
from repro_torch.core.fed_step import (FedTrainConfig, satellite_loss,
                                       stack_params)
from repro_torch.core.mesh_round import FedRoundConfig
from repro_torch.core.weights import mu_weights
from repro_torch.data.tokens import TokenTaskConfig, make_token_dataset
from repro_torch.kernels import ops
from repro_torch.models.transformer import Transformer


def make_batches(cfg, n_sats: int, batch: int, seq: int, step: int,
                 vocab: int, skew: float = 0.3,
                 device: torch.device | str = "cpu") -> dict:
    """Per-satellite next-token batches from the synthetic chain corpus
    (numpy, bit-equal to the reference's), moved to ``device``:
    ``tokens`` and ``labels`` of shape (S, batch, seq)."""
    tok_cfg = TokenTaskConfig(vocab_size=vocab, client_skew=skew, seed=7)
    toks = np.stack([
        make_token_dataset(batch * (seq + 1), tok_cfg, client=s,
                           seed_offset=step)
        .reshape(batch, seq + 1)
        for s in range(n_sats)
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
    ``(S, batch, seq)``; ``sizes`` and ``visible`` are host vectors. For
    each of ``local_steps`` steps and each satellite s: a forward and
    backward of ``satellite_loss`` on detached leaves ``params_S[k][s]``,
    then the reference's update ``p - lr * g.astype(p.dtype)`` with its
    two roundings (the product, then the difference), written into row s.
    A Python loop over satellites stands in for ``jax.vmap``: the
    attention kernels are ctypes launches with no batching rule, and an
    LM has no grouped-op form like the CNN's convolutions. Then one
    ``ops.fedagg_tree`` fold with the host's μ (one ``fedagg_leaves``
    launch on the card) and the global copied into every row.

    Metrics as the reference returns them: ``local_loss`` (the last local
    step's mean over satellites, a device scalar: nothing is read back),
    ``gate``, ``covered`` and ``upload_mass``."""
    cmap = fed_cfg.round_cfg.cmap
    lr = fed_cfg.learning_rate

    def step(params_S: dict, batch: Mapping[str, torch.Tensor], sizes,
             visible):
        keys = list(params_S)
        n_sats = params_S[keys[0]].shape[0]
        loss = None
        for _ in range(fed_cfg.local_steps):
            losses = []
            for s in range(n_sats):
                p = {k: params_S[k][s].detach().requires_grad_()
                     for k in keys}
                sat_loss = satellite_loss(
                    model, p, {k: v[s] for k, v in batch.items()})
                grads = torch.autograd.grad(sat_loss, [p[k] for k in keys])
                with torch.no_grad():
                    for k, g in zip(keys, grads):
                        leaf = params_S[k][s]
                        leaf.copy_(leaf - lr * g.to(leaf.dtype))
                losses.append(sat_loss.detach())
            loss = torch.stack(losses).mean()
        mu = _mu_weights(visible, sizes, cmap,
                         fed_cfg.round_cfg.partial_mode,
                         fed_cfg.round_cfg.orbit_weighting)
        with torch.no_grad():
            glob = ops.fedagg_tree(params_S, mu)
            for k in keys:
                params_S[k].copy_(glob[k].expand_as(params_S[k]))
        dev = params_S[keys[0]].device
        return params_S, {
            "local_loss": loss,
            "gate": torch.ones((), device=dev),
            "covered": torch.zeros((), device=dev),
            "upload_mass": torch.zeros((), device=dev)}

    return step


def main(argv: list[str] | None = None) -> dict:
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
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("train: --device cuda needs an NVIDIA card; pass "
                         "--device cpu for the plain versions")
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = Transformer(cfg)
    n_sats = args.sats
    if n_sats % args.orbits:
        raise SystemExit(f"train: --sats {n_sats} is not a multiple of "
                         f"--orbits {args.orbits}")
    cmap = ConstellationMeshMap(
        n_orbits=args.orbits, sats_per_orbit=n_sats // args.orbits,
        n_pods=1)
    n_dev = torch.cuda.device_count() if device.type == "cuda" else 1
    print(f"[train] single-device run; logical satellites={n_sats}"
          + (f" (the mesh rounds over {n_dev} devices wait on ROADMAP "
             f"Queue A item 12)" if n_dev >= n_sats > 1 else ""))

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
    params_S = stack_params(model.init(gen, device), n_sats)
    sizes = np.ones((n_sats,), np.float32)
    rng = np.random.default_rng(args.seed)
    step_fn = single_device_round(model, fed_cfg)

    print(f"[train] {cfg.name}: {model.count_params()/1e6:.1f}M params, "
          f"{n_sats} satellites, {args.round_kind}, device {device}")
    losses = []
    t0 = time.perf_counter()
    for rnd in range(args.rounds):
        batch = make_batches(cfg, n_sats, args.batch_per_sat, args.seq,
                             rnd, cfg.vocab_size, device=device)
        visible = _ensure_coverage(rng, cmap, args.visibility)
        params_S, metrics = step_fn(params_S, batch, sizes, visible)
        loss = float(metrics["local_loss"])
        losses.append(loss)
        print(f"  round {rnd:4d}  loss {loss:.4f}  "
              f"gate {float(metrics['gate']):.0f}  "
              f"({time.perf_counter()-t0:.1f}s)", flush=True)
    if args.ckpt_dir:
        save_checkpoint(args.ckpt_dir, {k: x[0] for k, x in params_S.items()},
                        args.rounds, {"arch": cfg.name})
        print(f"[train] checkpoint written to {args.ckpt_dir}")
    return {"losses": losses, "params_S": params_S}


if __name__ == "__main__":
    main()
