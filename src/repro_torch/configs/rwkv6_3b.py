"""rwkv6-3b [ssm] — RWKV-6 "Finch" with data-dependent decay.

32L d_model=2560 (attention-free) d_ff=8960 vocab=65536.
[arXiv:2404.05892] head_size=64 -> 40 wkv heads; O(1) decode state, so
long_500k runs natively.
"""
from repro_torch.configs.base import ArchConfig, RwkvConfig, register


@register("rwkv6-3b")
def config() -> ArchConfig:
    return ArchConfig(
        name="rwkv6-3b",
        family="ssm",
        source="arXiv:2404.05892",
        num_layers=32,
        d_model=2560,
        d_ff=8960,
        vocab_size=65536,
        num_heads=0,
        num_kv_heads=0,
        block_pattern=("rwkv",),
        use_rope=False,
        rwkv=RwkvConfig(head_size=64, lora_rank_decay=64, lora_rank_mix=32),
        norm_kind="layernorm",   # RWKV uses LayerNorm
        long_context_mode="native",
    )
