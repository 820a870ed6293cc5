"""qwen1.5-4b [dense]: 40L d_model=2560 20H (GQA kv=20) d_ff=6912
vocab=151936, QKV bias. [hf:Qwen/Qwen1.5-4B]"""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-4b", family="dense",
    num_layers=40, d_model=2560, num_heads=20, kv_heads=20,
    d_ff=6912, vocab=151936, head_dim=128, qkv_bias=True,
    norm="rmsnorm", act="silu", gated_ffn=True, rope_theta=5_000_000.0,
)

SMOKE = dataclasses.replace(
    CONFIG, name="qwen1.5-smoke", num_layers=2, d_model=64, num_heads=4,
    kv_heads=4, head_dim=16, d_ff=128, vocab=256)
