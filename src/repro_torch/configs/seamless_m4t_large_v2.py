"""seamless-m4t-large-v2 [audio]: 24L d_model=1024 16H (kv=16) d_ff=8192
vocab=256206, encoder-decoder, multimodal. The speech frontend is a stub:
``api.prefill(enc_embeds=)`` takes precomputed frame embeddings (B, S,
d_model) for the encoder. vocab padded 256206 -> 256256 (multiple of 256).
[arXiv:2308.11596]"""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2", family="encdec",
    num_layers=24, d_model=1024, num_heads=16, kv_heads=16,
    d_ff=8192, vocab=256206, head_dim=64,
    norm="layernorm", act="gelu", gated_ffn=False, rope_theta=10_000.0,
    enc_layers=24, frontend="frames",
)

SMOKE = dataclasses.replace(
    CONFIG, name="seamless-smoke", num_layers=2, enc_layers=2, d_model=64,
    num_heads=4, kv_heads=4, head_dim=16, d_ff=128, vocab=256)
