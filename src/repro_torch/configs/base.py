"""Model configuration dataclasses (a jax-free copy of ``repro.configs.base``).

Field for field the same as the JAX package's ``ModelConfig`` and its
``MoEConfig`` / ``SSMConfig`` / ``HybridConfig`` parts, so the two packages
describe one model identically; the dry-run helpers (``input_specs``,
``cache_specs``, shapes) stay with the JAX package.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 0
    top_k: int = 1
    capacity_factor: float = 1.25
    moe_every: int = 1          # MoE FFN every Nth layer (1 = every layer)
    shared_expert: bool = False  # extra always-on expert (llama4 style)
    dispatch_groups: int = 32   # capacity enforced per dispatch group


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 128        # N (dstate)
    head_dim: int = 64          # P  (d_inner = heads * head_dim)
    expand: int = 2
    conv_width: int = 4
    chunk: int = 256            # SSD chunk length
    num_groups: int = 1         # B/C groups (like GQA for SSM)


@dataclasses.dataclass(frozen=True)
class HybridConfig:
    """Griffin/RecurrentGemma style block pattern."""
    pattern: Tuple[str, ...] = ()   # e.g. ("rglru", "rglru", "local_attn")
    window: int = 2048              # local attention window
    lru_dim: int = 0                # RG-LRU recurrence width (0 = d_model)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | encdec | vlm | ssm | hybrid
    num_layers: int
    d_model: int
    num_heads: int
    kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0           # 0 -> d_model // num_heads
    qkv_bias: bool = False
    norm: str = "rmsnorm"       # rmsnorm | layernorm
    act: str = "silu"           # silu (gated) | gelu (plain)
    gated_ffn: bool = True
    rope_theta: float = 10_000.0
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    hybrid: Optional[HybridConfig] = None
    enc_layers: int = 0         # >0 -> encoder-decoder
    frontend: Optional[str] = None   # "patch" (vlm) | "frames" (audio)
    frontend_tokens: int = 0
    dtype: str = "bfloat16"
    moment_dtype: str = "float32"
    remat: str = "full"
    decode_kv_chunk: int = 2048
    flash_chunking: bool = True
    # paged decode attention: "kernel" (flash-decode through the block
    # tables) or "gather" (dense pool gather + layers.attend_decode, the
    # reference's baseline); PagedServingEngine(attn_impl=) sets it
    paged_attn_impl: str = "kernel"
    kv_cache_dtype: str = "bfloat16"   # "bfloat16" | "int8"
    kv_scale: float = 8.0              # static absmax bound of int8 caches
    note: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def is_encdec(self) -> bool:
        return self.enc_layers > 0

    def param_count(self) -> int:
        """Analytic parameter count (embedding + attention/MLP blocks) of a
        dense decoder-only stack, the only family the port serves."""
        d, dff, v = self.d_model, self.d_ff, self.vocab
        hd = self.resolved_head_dim
        attn = (d * self.num_heads * hd + 2 * d * self.kv_heads * hd
                + self.num_heads * hd * d)
        if self.qkv_bias:
            attn += (self.num_heads + 2 * self.kv_heads) * hd
        ffn = (3 if self.gated_ffn else 2) * d * dff
        total = self.num_layers * (attn + ffn)
        return int(total + v * d * (1 if self.tie_embeddings else 2))
