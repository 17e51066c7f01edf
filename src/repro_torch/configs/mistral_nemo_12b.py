"""mistral-nemo-12b [dense] — 128k-context dense decoder.

40L d_model=5120 32H (GQA kv=8) d_ff=14336 vocab=131072.
[hf:mistralai/Mistral-Nemo-Base-2407] head_dim=128 (explicit, not
d_model/heads). long_500k uses the sliding-window variant (window 4096).
"""
from repro_torch.configs.base import ArchConfig, register


@register("mistral-nemo-12b")
def config() -> ArchConfig:
    return ArchConfig(
        name="mistral-nemo-12b",
        family="dense",
        source="hf:mistralai/Mistral-Nemo-Base-2407",
        num_layers=40,
        d_model=5120,
        d_ff=14336,
        vocab_size=131072,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        rope_theta=1e6,
        sliding_window=4096,
        long_context_mode="swa",
    )
