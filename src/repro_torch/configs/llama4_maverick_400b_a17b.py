"""llama4-maverick-400b-a17b [moe]: 48L d_model=5120 40H (GQA kv=8) d_ff=8192
vocab=202048, MoE 128 experts top-1 + shared expert, MoE every 2nd layer
(interleaved: the published 400B-total / 17B-active design).
[hf:meta-llama/Llama-4-Maverick-17B-128E]"""
import dataclasses

from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b", family="moe",
    num_layers=48, d_model=5120, num_heads=40, kv_heads=8,
    d_ff=8192, vocab=202048, head_dim=128,
    norm="rmsnorm", act="silu", gated_ffn=True, rope_theta=500_000.0,
    moe=MoEConfig(num_experts=128, top_k=1, capacity_factor=1.25,
                  moe_every=2, shared_expert=True),
    moment_dtype="bfloat16",
)

SMOKE = dataclasses.replace(
    CONFIG, name="llama4-smoke", num_layers=4, d_model=64, num_heads=4,
    kv_heads=2, head_dim=16, d_ff=96, vocab=256,
    moe=MoEConfig(num_experts=8, top_k=1, capacity_factor=1.5,
                  moe_every=2, shared_expert=True))
