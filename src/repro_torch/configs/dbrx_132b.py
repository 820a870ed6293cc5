"""dbrx-132b [moe]: 40L d_model=6144 48H (GQA kv=8) d_ff=10752 vocab=100352,
MoE 16 experts top-4 (fine-grained). [hf:databricks/dbrx-base]"""
import dataclasses

from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="dbrx-132b", family="moe",
    num_layers=40, d_model=6144, num_heads=48, kv_heads=8,
    d_ff=10752, vocab=100352, head_dim=128,
    norm="layernorm", act="silu", gated_ffn=True, rope_theta=500_000.0,
    moe=MoEConfig(num_experts=16, top_k=4, capacity_factor=1.25),
    moment_dtype="float32",
)

SMOKE = dataclasses.replace(
    CONFIG, name="dbrx-smoke", num_layers=2, d_model=64, num_heads=4,
    kv_heads=2, head_dim=16, d_ff=96, vocab=256,
    moe=MoEConfig(num_experts=4, top_k=2, capacity_factor=1.5))
