"""Runner of federated LM rounds on one card: the program's
``single_device_round`` (every satellite's local SGD, then the FedHAP
fold with the host's Eq. 14-16 weights), each timed unit one round.

Set-up builds the one step object and the satellite-stacked weights
(the benchmark's own draw from the seed, at each matrix's own fan-in),
the round's token batches and visibility masks (``inputs/traffic.py``,
cycled through the window), and drives the first ``check_rounds``
rounds through the same step and feed: they compile and warm every
shape, and they are what the reference follows. Their losses and each
leaf's change from the first weights are read then; the window goes on
from the state they leave.

The check runs the plain reference (``reference/mla_lm.py``) after the
window, once the program's state is freed, over the same rounds from
the same first weights, and compares each round's loss and, leaf by
leaf, the norm of the change after the first round and after the last.
"""
from __future__ import annotations

import statistics
import time
import types

import numpy as np
import torch

from chipbench import costs
from chipbench.inputs import traffic, weights

#: ArchConfig fields of the port and the configuration's keys they take.
ARCH_KEYS = {"num_layers": "num_hidden_layers", "d_model": "hidden_size",
             "d_ff": "intermediate_size", "vocab_size": "vocab_size",
             "num_heads": "num_attention_heads",
             "num_kv_heads": "num_key_value_heads",
             "rope_theta": "rope_theta",
             "tie_embeddings": "tie_word_embeddings",
             "param_dtype": "torch_dtype", "act_dtype": "torch_dtype",
             "remat": "remat"}
MLA_KEYS = ("q_lora_rank", "kv_lora_rank", "qk_nope_head_dim",
            "qk_rope_head_dim", "v_head_dim")


def arch(cfg: dict):
    """The port's architecture ``port_arch`` (its layer kinds), with every
    size the configuration's file gives."""
    import dataclasses
    from repro_torch.configs import get_config
    a = get_config(cfg["port_arch"])
    if a.attention_kind != "mla":
        raise RuntimeError(f"{cfg['port_arch']} is not an MLA decoder")
    return dataclasses.replace(
        a, mla=dataclasses.replace(a.mla, **{k: cfg[k] for k in MLA_KEYS}),
        **{f: cfg[k] for f, k in ARCH_KEYS.items()})


def change_norms(params: dict, start: dict) -> dict:
    """Each leaf's ``‖row 0 - start‖`` in f32."""
    return {k: float((params[k][0].float() - start[k].float()).norm())
            for k in start}


def setup(cell, log):
    from repro_torch.core.dissemination import ConstellationMeshMap
    from repro_torch.core.fed_step import FedTrainConfig, stack_params
    from repro_torch.core.mesh_round import FedRoundConfig
    from repro_torch.launch.train import single_device_round
    from repro_torch.models.transformer import Transformer

    cfg, wl, dev = cell.config, cell.workload, cell.device
    model = Transformer(arch(cfg))
    specs = weights.mla_lm_specs(cfg)
    mine = {k: tuple(s) for k, s, _ in specs}
    theirs = {k: tuple(d.shape) for k, d in model.defs().items()}
    if mine != theirs:
        raise RuntimeError(f"the port's leaves {theirs} differ from the "
                           f"configuration's {mine}")
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    dtype = getattr(torch, cfg["torch_dtype"])
    t = time.perf_counter()
    start = weights.materialize(specs, cell.seed, dev, dtype)
    params_s = stack_params(start, wl["sats"])
    tokens = traffic.lm_tokens(wl, cfg["vocab_size"], cell.seed, dev)
    visible = traffic.visibility(wl, cell.seed)
    log(f"{model.count_params()} params x {wl['sats']} satellites drawn and "
        f"stacked in {time.perf_counter() - t:.2f} s")
    fed = FedTrainConfig(
        round_cfg=FedRoundConfig(
            cmap=ConstellationMeshMap(n_orbits=wl["orbits"],
                                      sats_per_orbit=wl["sats"] // wl["orbits"],
                                      n_pods=1),
            partial_mode=wl["partial_mode"], ship_global_echo=False),
        round_kind="fedhap", local_steps=wl["local_steps"],
        learning_rate=wl["lr"])
    st = types.SimpleNamespace(
        cell=cell, cfg=cfg, wl=wl, model=model, step=single_device_round(
            model, fed), params=params_s, tokens=tokens, visible=visible,
        sizes=np.ones(wl["sats"], np.float32), losses=[], changes=[],
        window_losses=[], specs=specs, dtype=dtype)
    for r in range(wl["check_rounds"]):
        t = time.perf_counter()
        loss = _round(st, r)
        st.losses.append(loss)
        st.changes.append(change_norms(st.params, start))
        log(f"check round {r}: loss {loss!r} in "
            f"{time.perf_counter() - t:.2f} s")
    del start
    return st


def _round(st, r: int) -> float:
    i = r % st.wl["sets"]
    batch = {"tokens": st.tokens[i, :, :, :-1],
             "labels": st.tokens[i, :, :, 1:]}
    st.params, metrics = st.step(st.params, batch, st.sizes, st.visible[i])
    return float(metrics["local_loss"])


def unit(st, i: int) -> None:
    st.window_losses.append(_round(st, st.wl["check_rounds"] + i))


def _tokens_per_round(wl: dict) -> int:
    return wl["sats"] * wl["local_steps"] * wl["batch_per_sat"] * wl["seq"]


def window_metrics(st, units: int, elapsed: float, peak: int) -> dict:
    return {"train_tokens_per_s": units * _tokens_per_round(st.wl) / elapsed,
            "peak_mem_gib": peak / 2**30}


def context(st, units: int, elapsed: float):
    cfg, wl = st.cfg, st.wl
    sat_steps = units * wl["sats"] * wl["local_steps"]
    itemsize = torch.empty((), dtype=st.dtype).element_size()
    return types.SimpleNamespace(
        kind="train", cell=st.cell, units=units, elapsed=elapsed,
        sat_steps=sat_steps,
        model_flop=sat_steps * costs.mla_lm_train_flop(
            cfg, wl["batch_per_sat"], wl["seq"]),
        peak_flop_per_s=costs.BF16_FLOP_PER_S,
        flash=dict(b=wl["batch_per_sat"], h=cfg["num_attention_heads"],
                   s=wl["seq"],
                   d=cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"],
                   dv=cfg["v_head_dim"], itemsize=itemsize),
        fold=dict(s=wl["sats"], itemsize=itemsize, launches=units,
                  p=sum(int(np.prod(s)) for _, s, _ in st.specs)))


def release(st) -> None:
    st.params = st.step = st.model = None
    if st.cell.device.type == "cuda":
        torch.cuda.empty_cache()


def reference(st, control: bool = False):
    from chipbench.reference import mla_lm
    start = weights.materialize(st.specs, st.cell.seed, st.cell.device,
                                st.dtype)
    return mla_lm.rounds(st.cfg, st.wl, start, st.tokens, st.visible,
                         st.wl["check_rounds"], control=control)


def leaf_gaps(prog: dict, want: dict, grad0: dict) -> dict:
    """Each leaf's gap between the program's and the reference's change
    norms, against the larger of that leaf's reference norm and the
    median leaf's. Leaves whose first reference gradient is under a
    thousandth of the median leaf's move by round-off alone and are left
    out."""
    med_g = statistics.median(grad0.values())
    keep = [k for k, g in grad0.items() if g >= 1e-3 * med_g]
    med = statistics.median(want[k] for k in keep)
    return {k: abs(prog[k] - want[k]) / max(want[k], med, 1e-30)
            for k in keep}


def compare(losses: list, changes: list, ref) -> dict:
    """The numbers a cell may compare (its ``limits`` say which): the
    largest gap of a round's loss, and the worst leaf's gap
    (:func:`leaf_gaps`) after the first round and after the last (where
    the check follows more than one)."""
    ref_losses, grad0, ref_changes = ref
    out = {"loss_gap": max(abs(a - b) for a, b in zip(losses, ref_losses)),
           "step1_gap": max(leaf_gaps(changes[0], ref_changes[0],
                                      grad0).values())}
    if len(changes) > 1:
        out["last_gap"] = max(leaf_gaps(changes[-1], ref_changes[-1],
                                        grad0).values())
    return out


def check(st, log):
    t = time.perf_counter()
    ref = reference(st)
    log(f"reference: losses {ref[0]} in {time.perf_counter() - t:.2f} s; "
        f"program's {st.losses}")
    limits = st.wl["limits"]
    found = compare(st.losses, st.changes, ref)
    failed = sum(1 for x in st.losses + st.window_losses
                 if not np.isfinite(x))
    return {k: {"value": found[k], "limit": v}
            for k, v in limits.items()}, failed

