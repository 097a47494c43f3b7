"""Phi-4-mini (3.8B) [arXiv:2412.08905].

Dense: RoPE, SwiGLU, GQA with 8 kv heads, 200k vocabulary.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi4-mini-3.8b", family="dense",
    num_layers=32, d_model=3072, num_heads=24, num_kv_heads=8,
    d_ff=8192, vocab_size=200064, head_dim=128,
    mlp_type="swiglu", norm_type="rmsnorm",
    source="arXiv:2412.08905",
)
