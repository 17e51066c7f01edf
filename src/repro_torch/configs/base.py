"""Config dataclasses + registry for the assigned architectures."""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25
    every: int = 1            # MoE in every `every`-th block (jamba: 2)
    aux_loss_coef: float = 0.01


@dataclasses.dataclass(frozen=True)
class MambaConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int | None = None   # default ceil(d_model / 16)
    chunk: int = 256             # chunked-scan block length


@dataclasses.dataclass(frozen=True)
class RwkvConfig:
    head_size: int = 64
    lora_rank_decay: int = 64
    lora_rank_mix: int = 32
    chunk: int = 128


@dataclasses.dataclass(frozen=True)
class MlaConfig:
    q_lora_rank: int = 768
    kv_lora_rank: int = 256
    qk_nope_head_dim: int = 64
    qk_rope_head_dim: int = 32
    v_head_dim: int = 64


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    """A full architecture description (one per assigned arch)."""
    name: str
    family: str                     # dense | moe | ssm | hybrid | vlm | audio
    source: str                     # citation from the assignment table
    num_layers: int
    d_model: int
    d_ff: int
    vocab_size: int
    num_heads: int = 0              # 0 for attention-free archs
    num_kv_heads: int = 0
    head_dim: int = 128
    # Block pattern: cycled over layers; entries in {"attn", "mamba", "rwkv"}.
    block_pattern: tuple[str, ...] = ("attn",)
    attention_kind: str = "gqa"     # gqa | mla
    use_rope: bool = True
    rope_theta: float = 1e6
    qk_norm: bool = False
    sliding_window: Optional[int] = None   # SWA variant available if set
    moe: Optional[MoEConfig] = None
    moe_ep_constraint: bool = False   # constrain dispatch buffers to
                                      # expert-sharded (EP) layout
    moe_dispatch_local: bool = False  # block-local dispatch: tokens stay
                                      # in their data shard; expert weights
                                      # broadcast instead of token exchange
    moe_dispatch_blocks: int = 16     # token blocks (= data-axis size)
    mamba: Optional[MambaConfig] = None
    rwkv: Optional[RwkvConfig] = None
    mla: Optional[MlaConfig] = None
    # Encoder-decoder (whisper): encoder layers with bidirectional attn +
    # decoder layers with self + cross attention.
    encoder_layers: int = 0
    encoder_seq: int = 1500         # stub frontend frames/patches
    # VLM stub frontend: number of patch-embedding positions prepended.
    vision_patches: int = 0
    tie_embeddings: bool = False
    norm_kind: str = "rmsnorm"      # rmsnorm | layernorm
    act: str = "silu"               # silu | gelu
    act_dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"
    # Long-context policy (DESIGN.md §4): how long_500k decode is served.
    long_context_mode: str = "native"  # native | swa
    remat: bool = True              # activation checkpointing for train
    attn_chunk_q: int = 1024        # blockwise-attention query block

    # ---- derived ----
    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def d_inner_mamba(self) -> int:
        assert self.mamba is not None
        return self.mamba.expand * self.d_model

    @property
    def dt_rank(self) -> int:
        assert self.mamba is not None
        return self.mamba.dt_rank or -(-self.d_model // 16)

    @property
    def rwkv_heads(self) -> int:
        assert self.rwkv is not None
        return self.d_model // self.rwkv.head_size

    def block_kind(self, layer: int) -> str:
        return self.block_pattern[layer % len(self.block_pattern)]

    def layer_is_moe(self, layer: int) -> bool:
        return self.moe is not None and (layer % self.moe.every == 0)

    def reduced(self) -> "ArchConfig":
        """CPU smoke-test variant: same family/topology, tiny dims."""
        small_moe = (
            dataclasses.replace(
                self.moe,
                num_experts=min(4, self.moe.num_experts),
                top_k=min(2, self.moe.top_k),
                d_ff_expert=128,
            )
            if self.moe
            else None
        )
        small_mamba = (
            dataclasses.replace(self.mamba, d_state=8, chunk=32)
            if self.mamba else None
        )
        small_rwkv = (
            dataclasses.replace(self.rwkv, head_size=32, lora_rank_decay=16,
                                lora_rank_mix=8, chunk=16)
            if self.rwkv else None
        )
        small_mla = (
            dataclasses.replace(self.mla, q_lora_rank=64, kv_lora_rank=32,
                                qk_nope_head_dim=16, qk_rope_head_dim=8,
                                v_head_dim=16)
            if self.mla else None
        )
        n_layers = min(2, self.num_layers)
        if len(self.block_pattern) > 1:
            # Keep the heterogeneous flavour: one period, trimmed.
            n_layers = len(self.block_pattern)
        d_model = min(256, self.d_model)
        heads = min(4, self.num_heads) if self.num_heads else 0
        kv = min(max(1, self.num_kv_heads), heads) if heads else 0
        return dataclasses.replace(
            self,
            name=self.name + "-reduced",
            num_layers=n_layers,
            d_model=d_model,
            d_ff=min(512, self.d_ff),
            vocab_size=min(512, self.vocab_size),
            num_heads=heads,
            num_kv_heads=kv,
            head_dim=64 if heads else self.head_dim,
            moe=small_moe,
            mamba=small_mamba,
            rwkv=small_rwkv,
            mla=small_mla,
            encoder_layers=min(2, self.encoder_layers),
            encoder_seq=min(64, self.encoder_seq),
            vision_patches=min(16, self.vision_patches),
            param_dtype="float32",
            act_dtype="float32",
            sliding_window=(min(32, self.sliding_window)
                            if self.sliding_window else None),
            attn_chunk_q=32,
            remat=False,
        )


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """An assigned input shape."""
    name: str
    seq_len: int
    global_batch: int
    mode: str                  # "train" | "prefill" | "decode"


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


_REGISTRY: dict[str, Callable[[], ArchConfig]] = {}


def register(name: str):
    def deco(fn: Callable[[], ArchConfig]):
        _REGISTRY[name] = fn
        return fn
    return deco


def get_config(name: str) -> ArchConfig:
    if name not in _REGISTRY:
        raise KeyError(
            f"unknown arch '{name}'; available: {sorted(_REGISTRY)}"
        )
    return _REGISTRY[name]()


def list_configs() -> list[str]:
    return sorted(_REGISTRY)
