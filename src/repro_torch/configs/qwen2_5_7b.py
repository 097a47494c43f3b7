"""Qwen2.5-7B — the model the paper evaluates with [arXiv:2412.15115]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-7b", family="dense",
    num_layers=28, d_model=3584, num_heads=28, num_kv_heads=4,
    d_ff=18944, vocab_size=152064, head_dim=128,
    rope_theta=1e6,
    mlp_type="swiglu", norm_type="rmsnorm", norm_eps=1e-6,
    source="arXiv:2412.15115",
)
