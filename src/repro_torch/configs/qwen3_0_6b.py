"""qwen3-0.6b [dense] — small dense decoder with qk_norm + GQA.

28L d_model=1024 16H (GQA kv=8) d_ff=3072 vocab=151936. [hf:Qwen/Qwen3-8B
family card] head_dim=128 (explicit), embeddings tied. The smallest arch:
FedHAP aggregation overhead is proportionally largest here, making it the
representative hillclimb for the paper's technique.
"""
from repro_torch.configs.base import ArchConfig, register


@register("qwen3-0.6b")
def config() -> ArchConfig:
    return ArchConfig(
        name="qwen3-0.6b",
        family="dense",
        source="hf:Qwen/Qwen3-8B",
        num_layers=28,
        d_model=1024,
        d_ff=3072,
        vocab_size=151936,
        num_heads=16,
        num_kv_heads=8,
        head_dim=128,
        qk_norm=True,
        rope_theta=1e6,
        tie_embeddings=True,
        sliding_window=4096,
        long_context_mode="swa",
    )
