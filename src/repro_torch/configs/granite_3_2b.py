"""granite-3-2b [dense]: 40L d_model=2048 32H (GQA kv=8) d_ff=8192
vocab=49155 (padded to 49408 for TP), GQA, tied embeddings.
[hf:ibm-granite/granite-3.0-2b-base]"""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-3-2b", family="dense",
    num_layers=40, d_model=2048, num_heads=32, kv_heads=8,
    d_ff=8192, vocab=49155, head_dim=64, tie_embeddings=True,
    norm="rmsnorm", act="silu", gated_ffn=True, rope_theta=10_000.0,
)

SMOKE = dataclasses.replace(
    CONFIG, name="granite-smoke", num_layers=2, d_model=64, num_heads=4,
    kv_heads=2, head_dim=16, d_ff=128, vocab=250)
