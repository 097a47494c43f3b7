"""MusicGen-medium decoder [arXiv:2306.05284].

Audio: decoder-only transformer over EnCodec tokens — 4 codebooks with
per-codebook embeddings summed at the input and 4 parallel logit heads
(vocab 2048 each).  MHA (kv == heads), LayerNorm + GELU as in the original
seq2seq-style stack.  Deviation noted in DESIGN.md: the original uses
sinusoidal positions; we use RoPE (TPU-idiomatic, same backbone shape).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium", family="audio",
    num_layers=48, d_model=1536, num_heads=24, num_kv_heads=24,
    d_ff=6144, vocab_size=2048, head_dim=64,
    mlp_type="gelu", norm_type="layernorm",
    num_codebooks=4,
    source="arXiv:2306.05284",
)
