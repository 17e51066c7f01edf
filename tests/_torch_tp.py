"""Cases of the tensor-parallel family tests
(``tests/test_torch_tensor_parallel.py``): every family of the zoo,
reduced, on a ``(data=1, model=2)`` gloo mesh (and those whose heads 4
divides on ``(data=1, model=4)``) against the port's own unsharded path
in the same process.

:func:`family_ranks` runs on each rank (``_torch_dist.spawn``): per case
it draws the full params from a seeded ``torch.Generator`` (f32, on the
CPU), shards them by the sanitized specs, and runs the forward, the
backward and a few decode steps both sharded (``axis``) and unsharded.
Rank 0 returns both sides' logits, losses, gradients (the sharded ones
gathered) and decode logits; every rank returns its replicated leaves
after one SGD step, for the bitwise check across ``model`` ranks, and
the leaves its layers gathered. No jax is imported.
"""
from __future__ import annotations

import dataclasses

import numpy as np

B, S, DECODE = 2, 16, 6
LR = 0.1

#: (case, arch, config overrides, own fan-in). The ``*_split`` cases
#: choose heads (experts) that ``model = 2`` does not divide, so their
#: layers gather; ``moe_split``'s 3 experts and whisper's vocab of 515
#: are relocated by ``sanitize_specs``. Own fan-in where the reference's
#: init is chaotic at the reduced depth (jamba, whisper: ``_torch_zoo``;
#: granite's MoE output reaches ~2e3 there, and a 1e-7 difference in
#: its input flips near-tied routes).
CASES = [
    ("dense", "qwen3-0.6b", {}, False),
    ("dense_split", "qwen3-0.6b", {"num_kv_heads": 1}, False),
    ("mla", "minicpm3-4b", {}, False),
    ("mla_split", "minicpm3-4b", {"num_heads": 3}, False),
    ("moe", "granite-moe-1b-a400m", {}, True),
    ("moe_head", "qwen3-moe-30b-a3b", {}, False),
    ("moe_split", "granite-moe-1b-a400m", {"num_experts": 3}, True),
    ("moe_local", "granite-moe-1b-a400m",
     {"moe_dispatch_local": True, "moe_dispatch_blocks": 4}, True),
    ("jamba", "jamba-v0.1-52b", {}, True),
    ("jamba_split", "jamba-v0.1-52b", {"num_kv_heads": 1}, True),
    ("rwkv", "rwkv6-3b", {}, False),
    ("rwkv_split", "rwkv6-3b", {"d_model": 96}, False),
    ("whisper", "whisper-small", {"vocab_size": 515}, True),
    ("whisper_split", "whisper-small", {"num_kv_heads": 1}, True),
]


def make_config(arch: str, overrides: dict):
    """The reduced port config with ``overrides``; ``num_experts`` goes
    into the MoE config."""
    from repro_torch.configs import get_config
    cfg = get_config(arch).reduced()
    over = dict(overrides)
    if "num_experts" in over:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, num_experts=over.pop("num_experts")))
    return dataclasses.replace(cfg, **over)


def make_params(model, own_fan_in: bool):
    import torch
    full = model.init(torch.Generator().manual_seed(0), "cpu",
                      torch.float32)
    if own_fan_in:
        from _torch_flash import chip_smoke
        for k, f in chip_smoke().own_fan_in_factors(model).items():
            full[k] = full[k] * f
    return full


def inputs(cfg):
    """Seeded tokens (B, S) and the stub frontends' inputs."""
    import torch
    rng = np.random.default_rng(5)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S)))
    aux = {}
    if cfg.is_encdec:
        aux["frames"] = torch.from_numpy(rng.standard_normal(
            (B, cfg.encoder_seq, cfg.d_model)).astype(np.float32))
    return tokens, aux or None


def _loss(model, params, tokens, aux_in, axis=None):
    from repro_torch.models.transformer import cross_entropy_loss
    logits, aux = model.forward(params, tokens, aux_in, axis)
    return logits, cross_entropy_loss(logits[:, :-1], tokens[:, 1:]) + aux


def _decode(model, params, tokens, aux_in, axis=None):
    cache = model.init_cache(B, DECODE, device="cpu", axis=axis)
    if model.cfg.is_encdec:
        model.prime_encdec(params, cache, aux_in["frames"], axis)
    out = []
    for t in range(DECODE):
        logits, cache = model.decode_step(params, cache, tokens[:, t],
                                          axis=axis)
        out.append(logits)
    return np.stack([x.numpy() for x in out])


def run_case(name: str, arch: str, overrides: dict, own: bool, mesh):
    """One case on this rank; see the module's text."""
    import torch

    from repro_torch.models import Transformer
    from repro_torch.models.sharding import (gather_params, model_dim,
                                             sanitize_specs, shard_params)
    cfg = make_config(arch, overrides)
    model = Transformer(cfg)
    full = make_params(model, own)
    specs = sanitize_specs(model.defs(), model.specs(), mesh)
    axis = model.model_axis(mesh, specs)
    local = shard_params(full, specs, axis)
    tokens, aux_in = inputs(cfg)

    p = {k: v.clone().requires_grad_() for k, v in full.items()}
    logits, loss = _loss(model, p, tokens, aux_in)
    grads = dict(zip(p, torch.autograd.grad(loss, list(p.values()))))
    q = {k: v.clone().requires_grad_() for k, v in local.items()}
    logits_s, loss_s = _loss(model, q, tokens, aux_in, axis)
    grads_s = dict(zip(q, torch.autograd.grad(loss_s, list(q.values()))))
    with torch.no_grad():
        stepped = {k: local[k] - LR * g for k, g in grads_s.items()}
        dec = _decode(model, full, tokens, aux_in)
        dec_s = _decode(model, local, tokens, aux_in, axis)
    gathered = gather_params(grads_s, specs, axis)
    back = gather_params(local, specs, axis)
    roundtrip = all(torch.equal(back[k], full[k]) for k in full)
    out = {"replicated": {k: v.numpy() for k, v in stepped.items()
                          if model_dim(specs[k]) is None},
           "local_shapes": {k: tuple(v.shape) for k, v in local.items()},
           "gathered": sorted(axis.gathered),
           "relocated": sorted(axis.relocated),
           "contiguous": all(v.is_contiguous() for v in local.values()),
           "roundtrip": roundtrip}
    if mesh.get_local_rank("model") == 0:
        out.update(
            logits=logits.detach().numpy(), logits_s=logits_s.detach().numpy(),
            loss=float(loss), loss_s=float(loss_s),
            grads={k: v.numpy() for k, v in grads.items()},
            grads_s={k: v.numpy() for k, v in gathered.items()},
            decode=dec, decode_s=dec_s)
    return out


#: The cases whose heads, channels and experts ``model = 4`` divides.
CASES_4 = ("dense", "mla", "moe", "jamba", "rwkv")


def family_ranks(rank: int, world: int) -> dict:
    """Every case on a ``(1, world)`` mesh; on 4 ranks, :data:`CASES_4`."""
    from torch.distributed.device_mesh import init_device_mesh
    mesh = init_device_mesh("cpu", (1, world),
                            mesh_dim_names=("data", "model"))
    return {name: run_case(name, arch, over, own, mesh)
            for name, arch, over, own in CASES
            if world == 2 or name in CASES_4}
