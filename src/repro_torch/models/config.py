"""Model configuration for every supported architecture family.

A single ``ModelConfig`` dataclass describes dense, MoE, MLA, SSM, hybrid,
VLM-backbone and audio-decoder architectures.  Family-specific fields are
optional and ignored by families that do not use them.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

# Layer kinds used by hybrid stacks.
ATTN = "attn"
SSM = "ssm"


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    num_shared_experts: int = 0
    # layer indices that stay dense (e.g. deepseek-v2 layer 0)
    dense_layers: Tuple[int, ...] = ()
    d_ff_dense: int = 0          # ffn width for the dense layers
    router_jitter: float = 0.0


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """Multi-head latent attention (DeepSeek-V2, arXiv:2405.04434)."""
    kv_lora_rank: int = 512
    q_lora_rank: int = 0          # 0 => no q compression (V2-Lite)
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba2 SSD (arXiv:2405.21060)."""
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk_size: int = 256

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int                # 0 for attn-free
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0             # 0 => d_model // num_heads
    # --- attention options ---
    rope_theta: float = 10000.0
    qk_norm: bool = False
    sliding_window: int = 0       # 0 => full attention
    mrope_sections: Tuple[int, ...] = ()   # M-RoPE (qwen2-vl)
    attn_logit_softcap: float = 0.0
    # --- mlp options ---
    mlp_type: str = "swiglu"      # swiglu | gelu
    # --- norms ---
    norm_type: str = "rmsnorm"    # rmsnorm | layernorm
    norm_eps: float = 1e-5
    # --- family-specific ---
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    # hybrid: one entry per layer, "attn" or "ssm". empty => uniform family.
    layer_pattern: Tuple[str, ...] = ()
    # hybrid (zamba2-style): attention blocks share a single set of weights
    shared_attn_weights: bool = False
    # --- audio (musicgen): K parallel codebooks, K output heads ---
    num_codebooks: int = 0
    # --- vlm: backbone consumes extra patch embeddings via input stub ---
    uses_extra_embeds: bool = False
    # --- misc ---
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    max_seq_len: int = 32768
    source: str = ""              # citation

    def __post_init__(self):
        if self.head_dim == 0 and self.num_heads > 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.family in ("ssm",) and not self.layer_pattern:
            object.__setattr__(self, "layer_pattern",
                               tuple([SSM] * self.num_layers))
        if not self.layer_pattern:
            object.__setattr__(self, "layer_pattern",
                               tuple([ATTN] * self.num_layers))
        assert len(self.layer_pattern) == self.num_layers

    # ---------- derived quantities ----------
    @property
    def attn_layers(self) -> Tuple[int, ...]:
        return tuple(i for i, k in enumerate(self.layer_pattern) if k == ATTN)

    @property
    def ssm_layers(self) -> Tuple[int, ...]:
        return tuple(i for i, k in enumerate(self.layer_pattern) if k == SSM)

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks)."""
        d = self.d_model
        n = 0
        n += self.vocab_size * d * (self.num_codebooks or 1)  # embed
        if not self.tie_embeddings:
            n += self.vocab_size * d * (self.num_codebooks or 1)
        seen_shared = False
        for i, kind in enumerate(self.layer_pattern):
            if kind == SSM:
                n += self._ssm_layer_params()
            else:
                if self.shared_attn_weights and seen_shared:
                    continue
                seen_shared = True
                n += self._attn_layer_params(i)
        return n

    def _attn_layer_params(self, layer_idx: int) -> int:
        d = self.d_model
        if self.mla is not None:
            m = self.mla
            qk_hd = m.qk_nope_head_dim + m.qk_rope_head_dim
            n = d * (self.num_heads * qk_hd)                     # Wq
            n += d * (m.kv_lora_rank + m.qk_rope_head_dim)       # down + k_rope
            n += m.kv_lora_rank * self.num_heads * (m.qk_nope_head_dim + m.v_head_dim)
            n += self.num_heads * m.v_head_dim * d               # Wo
        else:
            hd = self.head_dim
            n = d * self.num_heads * hd        # Wq
            n += 2 * d * self.num_kv_heads * hd  # Wk, Wv
            n += self.num_heads * hd * d       # Wo
        # mlp
        if self.moe is not None and layer_idx not in self.moe.dense_layers:
            e = self.moe
            per = 3 if self.mlp_type == "swiglu" else 2
            n += e.num_experts * per * d * e.d_ff_expert
            n += e.num_shared_experts * per * d * e.d_ff_expert
            n += d * e.num_experts                     # router
        else:
            ff = (self.moe.d_ff_dense if (self.moe and self.moe.d_ff_dense)
                  else self.d_ff)
            per = 3 if self.mlp_type == "swiglu" else 2
            n += per * d * ff
        return n

    def _ssm_layer_params(self) -> int:
        assert self.ssm is not None
        d = self.d_model
        s = self.ssm
        di = s.d_inner(d)
        nh = s.n_heads(d)
        n = d * (2 * di + 2 * s.d_state * 1 + nh)  # in_proj (z,x,B,C,dt) approx
        n += d * di                                 # out proj
        n += di * s.d_conv                          # conv
        return n

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only routed top-k + shared)."""
        if self.moe is None:
            return self.param_count()
        d = self.d_model
        e = self.moe
        per = 3 if self.mlp_type == "swiglu" else 2
        full_expert = per * d * e.d_ff_expert
        inactive = 0
        for i in range(self.num_layers):
            if self.layer_pattern[i] == ATTN and i not in e.dense_layers:
                inactive += (e.num_experts - e.top_k) * full_expert
        return self.param_count() - inactive


def reduced(cfg: ModelConfig, *, num_layers: int = 2, d_model: int = 256,
            vocab_size: int = 512, max_experts: int = 4) -> ModelConfig:
    """A tiny same-family variant for CPU smoke tests."""
    scale = d_model / cfg.d_model
    num_heads = max(2, min(4, cfg.num_heads)) if cfg.num_heads else 0
    num_kv = max(1, min(num_heads, max(1, int(cfg.num_kv_heads * num_heads
                                              / max(cfg.num_heads, 1)))))
    head_dim = d_model // num_heads if num_heads else 0
    moe = None
    if cfg.moe is not None:
        moe = dataclasses.replace(
            cfg.moe,
            num_experts=min(max_experts, cfg.moe.num_experts),
            top_k=min(2, cfg.moe.top_k),
            d_ff_expert=max(64, int(cfg.moe.d_ff_expert * scale)),
            num_shared_experts=min(1, cfg.moe.num_shared_experts),
            dense_layers=tuple(i for i in cfg.moe.dense_layers if i < num_layers),
            d_ff_dense=max(64, int(cfg.moe.d_ff_dense * scale)) if cfg.moe.d_ff_dense else 0,
        )
    mla = None
    if cfg.mla is not None:
        mla = dataclasses.replace(
            cfg.mla, kv_lora_rank=64, qk_nope_head_dim=head_dim,
            qk_rope_head_dim=max(8, head_dim // 2), v_head_dim=head_dim)
    ssm = None
    if cfg.ssm is not None:
        ssm = dataclasses.replace(cfg.ssm, d_state=16, head_dim=32,
                                  chunk_size=32)
    if cfg.layer_pattern and SSM in cfg.layer_pattern and ATTN in cfg.layer_pattern:
        pattern = tuple([SSM, ATTN][: num_layers]) if num_layers >= 2 else (SSM,)
    elif cfg.family == "ssm":
        pattern = tuple([SSM] * num_layers)
    else:
        pattern = tuple([ATTN] * num_layers)
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-reduced",
        num_layers=num_layers,
        d_model=d_model,
        num_heads=num_heads,
        num_kv_heads=num_kv,
        head_dim=head_dim,
        d_ff=max(128, int(cfg.d_ff * scale)) if cfg.d_ff else 0,
        vocab_size=vocab_size,
        sliding_window=min(cfg.sliding_window, 64) if cfg.sliding_window else 0,
        mrope_sections=(head_dim // 2 - 2 * (head_dim // 8),
                        head_dim // 8, head_dim // 8)
        if cfg.mrope_sections else (),
        moe=moe, mla=mla, ssm=ssm,
        layer_pattern=pattern,
        max_seq_len=512,
    )
