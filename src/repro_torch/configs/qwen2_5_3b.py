"""qwen2.5-3b [dense]: 36L d_model=2048 16H (GQA kv=2) d_ff=11008
vocab=151936, GQA + QKV bias. [hf:Qwen/Qwen2.5-3B]"""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-3b", family="dense",
    num_layers=36, d_model=2048, num_heads=16, kv_heads=2,
    d_ff=11008, vocab=151936, head_dim=128, qkv_bias=True,
    norm="rmsnorm", act="silu", gated_ffn=True, rope_theta=1_000_000.0,
)

SMOKE = dataclasses.replace(
    CONFIG, name="qwen2.5-smoke", num_layers=2, d_model=64, num_heads=4,
    kv_heads=2, head_dim=16, d_ff=128, vocab=256)
