"""mamba2-2.7b [ssm]: 64L d_model=2560, attention-free, ssm_state=128,
SSD (state-space duality). head_dim=64, expand=2 -> d_inner=5120, 80 heads.
[arXiv:2405.21060]"""
import dataclasses

from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b", family="ssm",
    num_layers=64, d_model=2560, num_heads=80, kv_heads=0,
    d_ff=0, vocab=50280, head_dim=64,
    norm="rmsnorm",
    ssm=SSMConfig(state_dim=128, head_dim=64, expand=2, conv_width=4,
                  chunk=256, num_groups=1),
)

SMOKE = dataclasses.replace(
    CONFIG, name="mamba2-smoke", num_layers=2, d_model=64, num_heads=4,
    vocab=256,
    ssm=SSMConfig(state_dim=16, head_dim=32, expand=2, conv_width=4,
                  chunk=8, num_groups=1))
