"""Model configuration dataclasses (a jax-free copy of ``repro.configs.base``).

Field for field the same as the JAX package's ``ModelConfig`` and its
``MoEConfig`` / ``SSMConfig`` / ``HybridConfig`` parts, so the two packages
describe one model identically; and the dry-run's cells: ``ShapeConfig``,
``SHAPES``, ``cell_runnable``, and ``input_specs`` / ``cache_specs``, whose
stand-ins are tensors on the ``meta`` device (shapes and dtypes, nothing
allocated) with the JAX package's shapes. Tokens and labels are int64, the
dtype the port's ``models.api`` takes (the reference's are int32); ``pos``
is int32 and embeddings take the config dtype, as there.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch


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

    @property
    def subquadratic(self) -> bool:
        """True when the arch supports ~500k-token decode (no full-attn cache)."""
        return self.family in ("ssm", "hybrid")

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks), the JAX package's
        formula: attention/MLP and MoE stacks exactly (an MoE layer every
        ``moe_every``-th: its experts, router and shared expert; an
        encoder-decoder's encoder layers and cross-attention), the Mamba2
        and hybrid families by its approximation."""
        d, dff, v = self.d_model, self.d_ff, self.vocab
        hd = self.resolved_head_dim
        attn = (d * self.num_heads * hd + 2 * d * self.kv_heads * hd
                + self.num_heads * hd * d)
        if self.qkv_bias:
            attn += (self.num_heads + 2 * self.kv_heads) * hd
        ffn = (3 if self.gated_ffn else 2) * d * dff
        if self.family == "ssm":
            s = self.ssm
            d_inner = s.expand * d
            per_layer = (
                d * (2 * d_inner + 2 * s.num_groups * s.state_dim
                     + d_inner // s.head_dim)
                + d_inner * s.conv_width + d_inner * d
                + d_inner // s.head_dim)
            total = self.num_layers * per_layer
        elif self.family == "hybrid":
            h = self.hybrid
            lru = h.lru_dim or d
            n_attn = sum(1 for b in (h.pattern * self.num_layers)
                         [: self.num_layers] if b == "local_attn")
            lru_block = 2 * d * lru + 3 * lru * lru
            total = (n_attn * (attn + ffn)
                     + (self.num_layers - n_attn) * (lru_block + ffn))
        else:
            total = sum(attn + self._ffn_params(layer, ffn)
                        for layer in range(self.num_layers))
            if self.is_encdec:
                # the encoder's self-attention + MLP layers, and each
                # decoder layer's cross-attention
                total += self.enc_layers * (attn + ffn)
                total += self.num_layers * attn
        return int(total + v * d * (1 if self.tie_embeddings else 2))

    def _is_moe_layer(self, layer: int) -> bool:
        m = self.moe
        return (m is not None and m.num_experts > 0
                and layer % m.moe_every == m.moe_every - 1)

    def _ffn_params(self, layer: int, ffn: int) -> int:
        """FFN parameters of ``layer``: every expert, the router and the
        shared expert on an MoE layer, else one dense MLP."""
        if not self._is_moe_layer(layer):
            return ffn
        m = self.moe
        return (m.num_experts * ffn + self.d_model * m.num_experts
                + (ffn if m.shared_expert else 0))

    def active_param_count(self) -> int:
        """Parameters a token runs through: the total for a dense stack;
        on an MoE layer top_k experts (and the shared one) instead of all
        of them, the router left out, as the JAX package counts."""
        if self.moe is None or self.moe.num_experts == 0:
            return self.param_count()
        d, hd = self.d_model, self.resolved_head_dim
        attn = (d * self.num_heads * hd + 2 * d * self.kv_heads * hd
                + self.num_heads * hd * d)
        ffn = (3 if self.gated_ffn else 2) * d * self.d_ff
        m = self.moe
        moe_ffn = m.top_k * ffn + (ffn if m.shared_expert else 0)
        total = sum(attn + (moe_ffn if self._is_moe_layer(layer) else ffn)
                    for layer in range(self.num_layers))
        return int(total + self.vocab * d * (1 if self.tie_embeddings else 2))


# ---------------------------------------------------------------------------
# Shapes (the dry-run's cells)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def cell_runnable(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Whether (arch, shape) is a runnable dry-run cell; reason if not."""
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, "long_500k needs sub-quadratic attention; full-attn arch (see DESIGN.md)"
    return True, ""


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """``meta`` tensors standing in for every model input of this cell.

    train:   {tokens, labels[, frontend_embeds | enc_embeds]}
    prefill: {tokens[, frontend_embeds | enc_embeds]}
    decode:  {tokens (1 new), cache (``cache_specs``), pos}
    """
    b, s = shape.global_batch, shape.seq_len
    dt = getattr(torch, cfg.dtype)

    def spec(shp, dtype):
        return torch.empty(shp, dtype=dtype, device="meta")

    def tok(bb, ss):
        return spec((bb, ss), torch.int64)

    specs: Dict[str, Any] = {}
    if shape.kind in ("train", "prefill"):
        n = s
        if cfg.is_encdec:
            specs["enc_embeds"] = spec((b, s, cfg.d_model), dt)
        elif cfg.frontend == "patch":
            ft = cfg.frontend_tokens
            specs["frontend_embeds"] = spec((b, ft, cfg.d_model), dt)
            n = s - ft
        specs["tokens"] = tok(b, n)
        if shape.kind == "train":
            specs["labels"] = tok(b, n)
    else:  # decode: one new token against a cache of seq_len
        specs["tokens"] = tok(b, 1)
        specs["pos"] = spec((b,), torch.int32)
        specs["cache"] = cache_specs(cfg, b, s)
    return specs


def cache_specs(cfg: ModelConfig, batch: int, seq_len: int) -> Any:
    """The dense decode cache (KV lanes / recurrent state) as ``meta``
    tensors: ``models.api.cache_shapes``."""
    from repro_torch.models import api  # local import to avoid cycles
    return api.cache_shapes(cfg, batch, seq_len)
