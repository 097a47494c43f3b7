"""Qwen2-VL-7B transformer backbone [arXiv:2409.12191].

VLM: M-RoPE (temporal/height/width sections 16/24/24 over head_dim 128),
dynamic-resolution patches arrive as precomputed embeddings from the stub
frontend (``uses_extra_embeds``); GQA with 4 kv heads.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-7b", family="vlm",
    num_layers=28, d_model=3584, num_heads=28, num_kv_heads=4,
    d_ff=18944, vocab_size=152064, head_dim=128,
    rope_theta=1e6, mrope_sections=(16, 24, 24),
    mlp_type="swiglu", norm_type="rmsnorm", norm_eps=1e-6,
    uses_extra_embeds=True,
    source="arXiv:2409.12191",
)
