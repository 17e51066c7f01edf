"""Serving entry point: batched greedy decoding of an LM (port of
``repro.launch.serve``), on the card unless ``--device cpu`` is given.

  PYTHONPATH=src python -m repro_torch.launch.serve --full --device cuda
  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-3b \
      --full --device cuda
  PYTHONPATH=src python -m repro_torch.launch.serve --arch jamba-v0.1-52b \
      --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-small \
      --full --device cuda

Every zoo architecture of the JAX package serves (``--arch``, see
``repro_torch.configs``). ``--full`` jamba-v0.1-52b is 51.6e9 params,
96 GiB in bf16: more than one card holds (``chip_smoke.py`` serves one
period of it); ``--full`` deepseek-coder-33b (62 GiB in bf16) and
qwen3-moe-30b-a3b (57 GiB) fit an 80 GB card's weights but not the f32
draw of their largest stacked leaf beside them (``chip_smoke.py`` serves
them at a cut depth). For an encoder-decoder architecture (whisper) the
CLI primes the cross-attention caches from seeded frame embeddings,
standing in for the stub frontend, as the JAX CLI does.

Same flags as the JAX package's serve CLI, plus ``--device``. The CLI
decodes with :func:`greedy_generate`, which steps the prompt through
``decode_step`` as the JAX CLI does: it launches no prefill kernel. The
kernels' entry point is :func:`prefill`, the counterpart of the inner
function of ``repro.launch.specs.make_prefill_step``: one forward over
the prompt through the model's prefill kernels (``flash_attention`` for
an attention block, MLA and cross-attention alike, ``rwkv6_wkv`` for
RWKV, ``selective_scan`` for Mamba), returning the last position's
logits; the stub frontends' inputs go in as ``aux_in`` (whisper's
frames, which its encoder reads, and pixtral's patches, prepended to
the prompt in the one causal pass). The mesh and sharding
half of ``specs`` waits for ROADMAP Queue A item 19.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, list_configs
from repro_torch.data.tokens import TokenTaskConfig, make_token_dataset
from repro_torch.models.transformer import Transformer


def _device_of(params: dict) -> torch.device:
    return next(iter(params.values())).device


@torch.no_grad()
def prefill(model: Transformer, params: dict, tokens: torch.Tensor,
            aux_in: dict | None = None) -> torch.Tensor:
    """Last-position logits (B, V) of ``model.forward(params, tokens,
    aux_in)``; only that position is unembedded ("what serving
    needs")."""
    x, _ = model.hidden_states(params, tokens, aux_in)
    return model.logits(params, x[:, -1:])[:, 0]


@torch.no_grad()
def greedy_generate(model: Transformer, params: dict, prompts: np.ndarray,
                    gen: int, use_window: bool = False,
                    frames: torch.Tensor | None = None) -> np.ndarray:
    """Greedy decoding of ``prompts`` (B, P) for ``gen`` more tokens on the
    params' device -> tokens (B, P + gen) int32.

    As the JAX package's serve loop does, the prompt is prefilled by stepping
    it through ``decode_step`` (cache-correct for every family), and the
    last generated token is not fed back. An encoder-decoder model takes
    ``frames`` (B, S_enc, d_model), from which ``prime_encdec`` fills its
    cross-attention caches first."""
    dev = _device_of(params)
    prompts_t = torch.as_tensor(np.asarray(prompts), device=dev).long()
    b, plen = prompts_t.shape
    max_len = plen + gen
    cache = model.init_cache(b, max_len, use_window=use_window, device=dev)
    if model.cfg.is_encdec:
        if frames is None:
            raise ValueError(f"{model.cfg.name}: an encoder-decoder model "
                             f"decodes against frames; pass frames")
        cache = model.prime_encdec(params, cache, frames.to(dev))
    tok = prompts_t[:, 0]
    generated = [tok]
    for i in range(1, max_len):
        logits, cache = model.decode_step(params, cache, tok,
                                          use_window=use_window)
        tok = prompts_t[:, i] if i < plen else torch.argmax(logits, dim=-1)
        generated.append(tok)
    return torch.stack(generated, dim=1).cpu().numpy().astype(np.int32)


def main(argv: list[str] | None = None) -> np.ndarray:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b", choices=list_configs())
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--window", action="store_true",
                    help="serve through the sliding-window cache")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: torch.cuda.is_available() is "
                           "False; pass --device cpu to run on the CPU")
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = Transformer(cfg)
    params = model.init(torch.Generator(device=device).manual_seed(
        args.seed), device)

    tok_cfg = TokenTaskConfig(vocab_size=cfg.vocab_size, seed=3)
    prompts = np.stack([
        make_token_dataset(args.prompt_len, tok_cfg, client=i)
        for i in range(args.batch)
    ])
    max_len = args.prompt_len + args.gen
    frames = None
    if cfg.is_encdec:
        frames = torch.from_numpy(np.random.default_rng(1).standard_normal(
            (args.batch, cfg.encoder_seq, cfg.d_model)).astype(np.float32))

    t0 = time.perf_counter()
    out = greedy_generate(model, params, prompts, args.gen,
                          use_window=args.window, frames=frames)
    dt = time.perf_counter() - t0
    print(f"[serve] {cfg.name} on {device}: {args.batch} seqs x {max_len} "
          f"steps in {dt:.2f}s ({args.batch * max_len / dt:.1f} tok/s)")
    for b in range(min(args.batch, 2)):
        print(f"  seq{b}: prompt={out[b, :args.prompt_len].tolist()} "
              f"gen={out[b, args.prompt_len:].tolist()}")
    return out


if __name__ == "__main__":
    main()
