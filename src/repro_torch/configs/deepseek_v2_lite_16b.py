"""DeepSeek-V2-Lite (16B total / 2.4B active) [arXiv:2405.04434].

MLA (kv_lora 512, qk_nope 128 + qk_rope 64, v 128) and fine-grained MoE:
64 routed experts top-6 + 2 shared experts (expert FFN width 1408); the
first layer keeps a dense FFN (width 10944).
"""
from repro_torch.models.config import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b", family="moe",
    num_layers=27, d_model=2048, num_heads=16, num_kv_heads=16,
    d_ff=1408, vocab_size=102400, head_dim=128,
    mlp_type="swiglu", norm_type="rmsnorm",
    mla=MLAConfig(kv_lora_rank=512, q_lora_rank=0,
                  qk_nope_head_dim=128, qk_rope_head_dim=64,
                  v_head_dim=128),
    moe=MoEConfig(num_experts=64, top_k=6, d_ff_expert=1408,
                  num_shared_experts=2, dense_layers=(0,),
                  d_ff_dense=10944),
    source="arXiv:2405.04434",
)
