"""H2O-Danube-1.8B [arXiv:2401.16818].

Dense llama/mistral mix with native sliding-window attention (4096),
GQA with 8 kv heads, SwiGLU.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-1.8b", family="dense",
    num_layers=24, d_model=2560, num_heads=32, num_kv_heads=8,
    d_ff=6912, vocab_size=32000, head_dim=80,
    sliding_window=4096,
    mlp_type="swiglu", norm_type="rmsnorm",
    source="arXiv:2401.16818",
)
