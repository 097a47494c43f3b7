"""StarCoder2-3B [arXiv:2402.19173].

Dense code model: GQA with 2 kv heads, RoPE (theta 1e5), LayerNorm and a
non-gated GELU MLP (4x).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-3b", family="dense",
    num_layers=30, d_model=3072, num_heads=24, num_kv_heads=2,
    d_ff=12288, vocab_size=49152, head_dim=128,
    rope_theta=1e5,
    mlp_type="gelu", norm_type="layernorm",
    source="arXiv:2402.19173",
)
