"""recurrentgemma-9b [hybrid]: 38L d_model=4096 16H (MQA kv=1) d_ff=12288
vocab=256000, RG-LRU + local attention (window 2048), pattern 1 attn : 2
recurrent -> (rglru, rglru, local_attn) x 12 + (rglru, rglru) tail.
[arXiv:2402.19427]"""
import dataclasses

from repro_torch.configs.base import HybridConfig, ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b", family="hybrid",
    num_layers=38, d_model=4096, num_heads=16, kv_heads=1,
    d_ff=12288, vocab=256000, head_dim=256,
    norm="rmsnorm", act="gelu", gated_ffn=True, rope_theta=10_000.0,
    tie_embeddings=True,
    hybrid=HybridConfig(pattern=("rglru", "rglru", "local_attn"),
                        window=2048, lru_dim=4096),
)

SMOKE = dataclasses.replace(
    CONFIG, name="rgemma-smoke", num_layers=5, d_model=64, num_heads=4,
    kv_heads=1, head_dim=16, d_ff=128, vocab=256,
    hybrid=HybridConfig(pattern=("rglru", "rglru", "local_attn"),
                        window=16, lru_dim=64))
