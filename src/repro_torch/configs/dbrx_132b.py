"""DBRX-base (132B total / 36B active) [hf:databricks/dbrx-base].

Fine-grained MoE: 16 experts, top-4 routing, expert FFN width 10752;
GQA with 8 kv heads over 48 query heads.
"""
from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="dbrx-132b", family="moe",
    num_layers=40, d_model=6144, num_heads=48, num_kv_heads=8,
    d_ff=10752, vocab_size=100352, head_dim=128,
    rope_theta=5e5,
    mlp_type="swiglu", norm_type="rmsnorm",
    moe=MoEConfig(num_experts=16, top_k=4, d_ff_expert=10752),
    source="hf:databricks/dbrx-base",
)
