"""Zamba2-1.2B [arXiv:2411.15242].

Hybrid: Mamba2 backbone with a SINGLE shared transformer (attention+MLP)
block applied periodically (weight reuse — ``shared_attn_weights``).
ssm_state 64; shared block is MHA (kv == heads) with an 8192 FFN.
"""
from repro_torch.models.config import ModelConfig, SSMConfig

_PATTERN = tuple(
    "attn" if i % 6 == 5 else "ssm" for i in range(38)
)

CONFIG = ModelConfig(
    name="zamba2-1.2b", family="hybrid",
    num_layers=38, d_model=2048, num_heads=32, num_kv_heads=32,
    d_ff=8192, vocab_size=32000, head_dim=64,
    mlp_type="swiglu", norm_type="rmsnorm",
    ssm=SSMConfig(d_state=64, d_conv=4, expand=2, head_dim=64),
    layer_pattern=_PATTERN,
    shared_attn_weights=True,
    source="arXiv:2411.15242",
)
