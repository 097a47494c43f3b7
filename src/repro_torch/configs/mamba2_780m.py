"""Mamba2-780m [arXiv:2405.21060].

Attention-free SSM via SSD (state-space duality): d_state 128, expand 2
(d_inner 3072, 48 heads of dim 64), conv4.
"""
from repro_torch.models.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-780m", family="ssm",
    num_layers=48, d_model=1536, num_heads=0, num_kv_heads=0,
    d_ff=0, vocab_size=50280,
    norm_type="rmsnorm",
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64,
                  chunk_size=256),
    source="arXiv:2405.21060",
)
