"""qwen3-moe-30b-a3b [moe] — 128-expert top-8 MoE with GQA kv=4 + qk_norm.

48L d_model=2048 32H (GQA kv=4) d_ff=768 vocab=151936, MoE 128e top-8.
[hf:Qwen/Qwen3-30B-A3B] d_ff=768 is the per-expert intermediate size
(moe_intermediate_size); every layer is MoE.
"""
from repro_torch.configs.base import ArchConfig, MoEConfig, register


@register("qwen3-moe-30b-a3b")
def config() -> ArchConfig:
    return ArchConfig(
        name="qwen3-moe-30b-a3b",
        family="moe",
        source="hf:Qwen/Qwen3-30B-A3B",
        num_layers=48,
        d_model=2048,
        d_ff=768,
        vocab_size=151936,
        num_heads=32,
        num_kv_heads=4,
        head_dim=128,
        qk_norm=True,
        rope_theta=1e6,
        moe=MoEConfig(num_experts=128, top_k=8, d_ff_expert=768, every=1),
        sliding_window=4096,
        long_context_mode="swa",
    )
