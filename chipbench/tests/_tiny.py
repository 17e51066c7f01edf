"""Tiny cells for the CPU tests: the real configurations and traffic with
their sizes cut until a run takes seconds on a CPU."""
import copy
import time

import torch

from chipbench import harness


#: The benchmark's cells of federated LM rounds of minicpm3-4b.
LM_CELLS = [w["name"] for w in harness.manifest()["workloads"]
            if w["config"] == "minicpm3-4b"]


def lm_cell(name: str = LM_CELLS[0], dtype: str = "bfloat16",
            seed: int = 2**31 + 17, trace: bool = False) -> harness.Cell:
    cfg = copy.deepcopy(harness.load_json("configs", "minicpm3-4b"))
    cfg.update(hidden_size=64, num_hidden_layers=2, intermediate_size=96,
               num_attention_heads=4, num_key_value_heads=4, vocab_size=128,
               q_lora_rank=32, kv_lora_rank=16, qk_nope_head_dim=16,
               qk_rope_head_dim=8, v_head_dim=16, torch_dtype=dtype)
    wl = copy.deepcopy(harness.load_json("workloads", name))
    wl.update(seq=40, chips=1)
    return harness.Cell(name, wl, cfg, seed, 0.05, trace,
                        torch.device("cpu"))


def sim_cell(seed: int = 2**31 + 23, trace: bool = False) -> harness.Cell:
    cfg = copy.deepcopy(harness.load_json("configs", "paper-cnn"))
    cfg["sim"].update(num_samples=2000, eval_samples=400, local_steps=2,
                      horizon_h=12.0, plan_block=2)
    wl = dict(harness.load_json("workloads", "cnn.fedhap-onehap"), chips=1)
    return harness.Cell("cnn.fedhap-onehap", wl, cfg, seed, 0.05, trace,
                        torch.device("cpu"))


def run(cell: harness.Cell, runner=None) -> harness.Outcome:
    return harness.run_cell(cell, time.perf_counter(), harness.manifest(),
                            runner=runner)
