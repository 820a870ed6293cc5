"""yi-6b [dense]: 32L d_model=4096 32H (GQA kv=4) d_ff=11008 vocab=64000,
llama-arch GQA. [arXiv:2403.04652]"""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="yi-6b", family="dense",
    num_layers=32, d_model=4096, num_heads=32, kv_heads=4,
    d_ff=11008, vocab=64000, head_dim=128,
    norm="rmsnorm", act="silu", gated_ffn=True, rope_theta=5_000_000.0,
)

SMOKE = dataclasses.replace(
    CONFIG, name="yi-smoke", num_layers=2, d_model=64, num_heads=4,
    kv_heads=2, head_dim=16, d_ff=128, vocab=256)
