"""internvl2-2b [vlm]: 24L d_model=2048 16H (GQA kv=8) d_ff=8192 vocab=92553
(InternLM2-1.8B backbone). The InternViT frontend is a stub: a caller passes
``frontend_tokens`` precomputed patch embeddings (post pixel-shuffle + MLP
projector), which ``api.prefill`` puts before the token stream.
[arXiv:2404.16821]"""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b", family="vlm",
    num_layers=24, d_model=2048, num_heads=16, kv_heads=8,
    d_ff=8192, vocab=92553, head_dim=128,
    norm="rmsnorm", act="silu", gated_ffn=True, rope_theta=1_000_000.0,
    frontend="patch", frontend_tokens=256,
)

SMOKE = dataclasses.replace(
    CONFIG, name="internvl2-smoke", num_layers=2, d_model=64, num_heads=4,
    kv_heads=2, head_dim=16, d_ff=128, vocab=256, frontend_tokens=8)
