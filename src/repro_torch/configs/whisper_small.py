"""whisper-small [audio] — encoder-decoder with a stubbed conv frontend.

12L d_model=768 12H (kv=12, i.e. full MHA) d_ff=3072 vocab=51865.
[arXiv:2212.04356] Whisper-small is 12 encoder + 12 decoder layers; the
mel-spectrogram + conv feature extractor is a STUB — `input_specs`
supplies 1500 pre-computed frame embeddings of width d_model. Decode-shape
caches exceed the real model's 448 learned positions, so the backbone uses
RoPE (DESIGN.md §6 Deviations). Self-attention in the decoder has an SWA
variant for long_500k; cross-attention (1500 frames) is always full.
"""
from repro_torch.configs.base import ArchConfig, register


@register("whisper-small")
def config() -> ArchConfig:
    return ArchConfig(
        name="whisper-small",
        family="audio",
        source="arXiv:2212.04356",
        num_layers=12,           # decoder layers
        encoder_layers=12,
        encoder_seq=1500,
        d_model=768,
        d_ff=3072,
        vocab_size=51865,
        num_heads=12,
        num_kv_heads=12,
        head_dim=64,
        rope_theta=1e4,
        norm_kind="layernorm",
        act="gelu",
        sliding_window=4096,
        long_context_mode="swa",
    )
