"""The yardstick's FLOP and byte counts, pinned to hand counts at small
shapes and to the port's own cost functions they were copied from."""
import pytest
import torch

from chipbench import costs


def test_flash_costs_by_hand():
    # b=1, h=2, s=3, d=4, dv=2: 6 causal pairs a head.
    assert costs.causal_pairs(3) == 6
    flop, nbytes = costs.flash_fwd_cost(1, 2, 3, 4, 2, 2)
    assert flop == 2 * 6 * 2 * (4 + 2)
    assert nbytes == 2 * 2 * 3 * (4 + 4 + 2 + 2) + 4 * 2 * 3
    flop, nbytes = costs.flash_bwd_cost(1, 2, 3, 4, 2, 2)
    assert flop == 2 * 6 * (6 * 4 + 4 * 2)
    assert nbytes == 2 * 2 * 2 * 3 * (4 + 4 + 2 + 2) + 4 * 2 * 3


@pytest.mark.parametrize("shape", [(1, 2, 3, 4, 2), (2, 40, 1024, 96, 64)])
def test_flash_costs_match_the_port(shape):
    from repro_torch.kernels import flash_attention as fa
    b, h, s, d, dv = shape
    q, k, v = (b, h, s, d), (b, h, s, d), (b, h, s, dv)
    assert costs.flash_fwd_cost(*shape, 2) == fa.flash_attention_cost(
        q, k, v, torch.bfloat16, causal=True, with_lse=True)
    assert costs.flash_bwd_cost(*shape, 2) == fa.flash_attention_bwd_cost(
        q, k, v, torch.bfloat16, causal=True)


def test_fold_cost_by_hand_and_port():
    from repro_torch.kernels.fedagg import fedagg_cost
    assert costs.fold_cost(2, 3, 4) == (12, 3 * 3 * 4 + 8)
    assert costs.fold_cost(4, 10, 2) == fedagg_cost(4, [6, 4],
                                                    torch.bfloat16)


def test_bound_takes_the_larger_term():
    assert costs.bound_s(989e12, 0, costs.BF16_FLOP_PER_S) == 1.0
    assert costs.bound_s(0, 3.35e12, costs.BF16_FLOP_PER_S) == 1.0


def test_cnn_flop_by_hand():
    # image 4, one channel each, 1x1 kernel, hidden 2, 2 classes:
    # 16 + 4 conv products, 1*2 + 2*2 dense, 2 FLOP a product.
    assert costs.cnn_forward_flop(4, (1, 1), 1, 2, 2) == 2 * (16 + 4 + 2 + 4)
    # the paper's CNN, ~24.5 MFLOP a sample
    assert costs.cnn_forward_flop(28, (32, 64), 5, 512, 10) == 2 * (
        28 * 28 * 32 * 25 + 14 * 14 * 64 * 25 * 32 + 3136 * 512 + 5120)


def test_mla_flop_by_hand():
    cfg = dict(hidden_size=4, num_attention_heads=2, qk_nope_head_dim=2,
               qk_rope_head_dim=1, v_head_dim=2, q_lora_rank=3,
               kv_lora_rank=2, intermediate_size=5, num_hidden_layers=1,
               vocab_size=7)
    per_layer = 4 * 3 + 3 * 6 + 4 * 2 + 2 * 4 + 2 * 4 + 4 * 1 + 4 * 4 + 60
    assert costs.mla_lm_matmul_params(cfg) == per_layer + 28
    # batch 1, seq 2: 3 causal pairs, 2 heads, 2*(3+2) FLOP a pair.
    assert costs.mla_lm_train_flop(cfg, 1, 2) == (
        6 * (per_layer + 28) * 2 + 3 * 2 * 3 * 2 * 5)


def test_mla_params_match_the_port():
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import Transformer
    from chipbench import harness
    cfg = harness.load_json("configs", "minicpm3-4b")
    defs = Transformer(get_config("minicpm3-4b")).defs()
    norms = sum(d.shape[-1] * (d.shape[0] if len(d.shape) > 1 else 1)
                for k, d in defs.items() if "norm" in k)
    total = sum(torch.Size(d.shape).numel() for d in defs.values())
    assert costs.mla_lm_matmul_params(cfg) == total - norms
