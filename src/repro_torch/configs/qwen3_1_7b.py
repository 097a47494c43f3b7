"""Qwen3-1.7B [hf:Qwen/Qwen3-8B family card].

Dense: qk-norm (RMSNorm on per-head q/k), GQA with 8 kv heads, SwiGLU.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-1.7b", family="dense",
    num_layers=28, d_model=2048, num_heads=16, num_kv_heads=8,
    d_ff=6144, vocab_size=151936, head_dim=128,
    rope_theta=1e6, qk_norm=True,
    mlp_type="swiglu", norm_type="rmsnorm", norm_eps=1e-6,
    source="hf:Qwen/Qwen3-8B",
)
