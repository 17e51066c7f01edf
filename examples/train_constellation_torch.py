"""End-to-end federated LM pre-training on the PyTorch/CUDA port:
``examples/train_constellation.py`` on ``repro_torch``.

Trains a qwen3-family decoder (f32) federated across 4 satellites (2
orbits) with FedHAP rounds on synthetic per-satellite token corpora. The
defaults train a 32.5M-parameter model for 30 rounds; ``--rounds 200
--d-model 768`` trains the 70.0M one of the reference's "few hundred
steps" deliverable. It runs on the card (attention forward and backward
on the flash kernels' mma variant, f32 at head dim 64; each round's
fold in one ``fedagg_leaves`` launch); ``--cpu`` runs it on the CPU
(without a card and without ``--cpu`` it raises).

  PYTHONPATH=src python examples/train_constellation_torch.py --rounds 30
  PYTHONPATH=src python examples/train_constellation_torch.py --cpu \
      --rounds 3 --d-model 64 --layers 2 --vocab 256 --seq 32
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Mapping, Optional

import numpy as np
import torch

from repro_torch.checkpoint import save_checkpoint
from repro_torch.configs import get_config
from repro_torch.core.dissemination import ConstellationMeshMap
from repro_torch.core.fed_step import FedTrainConfig, stack_params
from repro_torch.core.mesh_round import FedRoundConfig
from repro_torch.kernels.fedagg import fedagg
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.launch.train import (_ensure_coverage, make_batches,
                                      single_device_round)
from repro_torch.models import params_from_numpy
from repro_torch.models.transformer import Transformer

# The kernel launch counts the run reports (on the card).
COUNTS = ((fedagg, "launches", "fedagg_leaves"),
          (flash_attention, "launches", "flash forward"),
          (flash_attention, "launches_mma", "flash forward (mma)"),
          (flash_attention, "launches_bwd", "flash backward"),
          (flash_attention, "launches_bwd_mma", "flash backward (mma)"))


def build_model(d_model: int, layers: int, vocab: int) -> Transformer:
    cfg = get_config("qwen3-0.6b")
    cfg = dataclasses.replace(
        cfg, name=f"qwen3-{d_model}d{layers}L", num_layers=layers,
        d_model=d_model, d_ff=4 * d_model, vocab_size=vocab,
        num_heads=max(4, d_model // 128), num_kv_heads=max(2, d_model //
                                                           256),
        head_dim=64, param_dtype="float32", act_dtype="float32",
        remat=False, attn_chunk_q=256, sliding_window=None,
        long_context_mode="native")
    return Transformer(cfg)


def train(model: Transformer, rounds: int, sats: int, seq: int,
          batch_per_sat: int, lr: float, partial_mode: str,
          visibility: float, device: torch.device,
          init_params: Optional[Mapping] = None) -> dict:
    """``rounds`` FedHAP rounds of ``model`` on ``sats`` satellites over 2
    orbits (one local step each, every satellite's batch from its own
    corpus, visibility drawn per round with each orbit covered), from
    ``init_params`` (a numpy param tree, e.g. the JAX package's init) or
    the port's seeded init. Returns ``{"losses", "params_S",
    "tokens_per_s"}``."""
    cfg = model.cfg
    cmap = ConstellationMeshMap(n_orbits=2, sats_per_orbit=sats // 2,
                                n_pods=1)
    fed_cfg = FedTrainConfig(
        round_cfg=FedRoundConfig(cmap=cmap, partial_mode=partial_mode,
                                 ship_global_echo=False),
        round_kind="fedhap", local_steps=1, learning_rate=lr)
    if device.type == "cuda":
        # f32 GEMMs in f32, not TF32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    params = (params_from_numpy(init_params, device)
              if init_params is not None else
              model.init(torch.Generator(device=device).manual_seed(0),
                         device))
    params_S = stack_params(params, sats)
    del params
    sizes = np.ones((sats,), np.float32)
    rng = np.random.default_rng(0)
    step_fn = single_device_round(model, fed_cfg)

    t0 = time.perf_counter()
    losses, tok_s = [], 0.0
    for rnd in range(rounds):
        batch = make_batches(cfg, sats, batch_per_sat, seq, rnd,
                             cfg.vocab_size, device=device)
        visible = _ensure_coverage(rng, cmap, visibility)
        params_S, metrics = step_fn(params_S, batch, sizes, visible)
        losses.append(float(metrics["local_loss"]))
        tok_s = (sats * batch_per_sat * seq * (rnd + 1)
                 / (time.perf_counter() - t0))
        if rnd % 5 == 0 or rnd == rounds - 1:
            print(f"  round {rnd:4d}  loss {losses[-1]:.4f}  "
                  f"({tok_s:,.0f} tok/s)", flush=True)
    return {"losses": losses, "params_S": params_S, "tokens_per_s": tok_s}


def main(argv=None) -> dict:
    """The CLI; returns :func:`train`'s dict."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=30)
    ap.add_argument("--d-model", type=int, default=512)
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--vocab", type=int, default=8192)
    ap.add_argument("--sats", type=int, default=4)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--batch-per-sat", type=int, default=2)
    ap.add_argument("--lr", type=float, default=0.02)
    ap.add_argument("--partial-mode", default="exact",
                    choices=["paper", "exact"])
    ap.add_argument("--visibility", type=float, default=0.5)
    ap.add_argument("--ckpt-dir", default="runs/train_constellation_torch")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the card")
    args = ap.parse_args(argv)
    device = torch.device("cpu" if args.cpu else "cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False; pass --cpu "
                           "to run on the CPU")

    model = build_model(args.d_model, args.layers, args.vocab)
    cfg = model.cfg
    n_params = model.count_params()
    print(f"[fed-train] {cfg.name}: {n_params/1e6:.1f}M params, "
          f"{args.sats} satellites, FedHAP partial_mode={args.partial_mode}"
          f", device {device}")
    before = [getattr(fn, attr) for fn, attr, _ in COUNTS]
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    out = train(model, args.rounds, args.sats, args.seq, args.batch_per_sat,
                args.lr, args.partial_mode, args.visibility, device)
    losses = out["losses"]
    assert losses[-1] < losses[0], "federated training must reduce loss"
    save_checkpoint(args.ckpt_dir,
                    {k: x[0] for k, x in out["params_S"].items()},
                    args.rounds, {"arch": cfg.name, "losses": losses})
    print(f"[fed-train] loss {losses[0]:.3f} -> {losses[-1]:.3f}; "
          f"checkpoint in {args.ckpt_dir}")
    if device.type == "cuda":
        per_round = ", ".join(
            f"{label} {(getattr(fn, attr) - b) / args.rounds:g}"
            for (fn, attr, label), b in zip(COUNTS, before))
        print(f"[fed-train] kernel launches per round: {per_round}; peak "
              f"device memory "
              f"{torch.cuda.max_memory_allocated(device) / 2**30:.2f} GiB")
    return out


if __name__ == "__main__":
    main()
