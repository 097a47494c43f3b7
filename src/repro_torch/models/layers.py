"""Shared layer primitives: norms, rotary embeddings (incl. M-RoPE), MLPs.

Counterpart of ``src/repro/models/layers.py``; parameters keep the JAX layout
(``x @ w`` with ``w: [d_in, d_out]``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.device import upcast


def dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` in the wider of the two dtypes, as ``jnp.dot`` promotes:
    float32 activations (a VLM's float32 ``embeds`` batch) meet a bf16
    weight as float32, where ``torch.matmul`` refuses mixed dtypes."""
    if x.dtype != w.dtype:
        dt = torch.promote_types(x.dtype, w.dtype)
        x, w = x.to(dt), w.to(dt)
    return x @ w


# ---------------------------------------------------------------- norms
def rmsnorm(x: torch.Tensor, weight: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = upcast(x)
    var = torch.mean(x * x, dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * upcast(weight)).to(dt)


def layernorm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = upcast(x)
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.var(x, dim=-1, keepdim=True, unbiased=False)
    x = (x - mu) * torch.rsqrt(var + eps)
    return (x * upcast(weight) + upcast(bias)).to(dt)


def apply_norm(x, params, cfg):
    if cfg.norm_type == "layernorm":
        return layernorm(x, params["scale"], params["bias"], cfg.norm_eps)
    return rmsnorm(x, params["scale"], cfg.norm_eps)


def init_norm(cfg, d: int, device: torch.device):
    if cfg.norm_type == "layernorm":
        return {"scale": torch.ones(d, dtype=torch.float32, device=device),
                "bias": torch.zeros(d, dtype=torch.float32, device=device)}
    return {"scale": torch.ones(d, dtype=torch.float32, device=device)}


# ---------------------------------------------------------------- rope
def rope_freqs(head_dim: int, theta: float,
               device: Optional[torch.device] = None) -> torch.Tensor:
    """Inverse frequencies for half the head dim. [hd/2] f32."""
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / (theta ** exps)


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float,
                 mrope_sections: Tuple[int, ...] = ()
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables.

    positions: [..., seq] int for 1-D RoPE, or [..., seq, 3] for M-RoPE
    (temporal, height, width position ids — Qwen2-VL arXiv:2409.12191).
    Returns cos, sin of shape [..., seq, head_dim/2] f32.
    """
    inv = rope_freqs(head_dim, theta, positions.device)      # [hd/2]
    if mrope_sections:
        assert positions.shape[-1] == 3, "M-RoPE needs 3-d position ids"
        ang3 = positions[..., None].float() * inv           # [...,seq,3,hd/2]
        # per-frequency component selector from the section layout
        sec = torch.cat([torch.full((s,), i, dtype=torch.long,
                                    device=positions.device)
                         for i, s in enumerate(mrope_sections)])
        onehot = F.one_hot(sec, 3).float()                  # [hd/2, 3]
        ang = torch.einsum("...kf,fk->...f", ang3, onehot)
    else:
        ang = positions[..., None].float() * inv            # [...,seq,hd/2]
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x: [..., seq, heads, head_dim]; cos/sin: [..., seq, head_dim/2]."""
    dt = x.dtype
    half = x.shape[-1] // 2
    x1, x2 = upcast(x[..., :half]), upcast(x[..., half:])
    c = cos[..., None, :]                  # broadcast over heads
    s = sin[..., None, :]
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return out.to(dt)


# ---------------------------------------------------------------- mlp
def swiglu(x, w_gate, w_up, w_down):
    return dot(F.silu(dot(x, w_gate)) * dot(x, w_up), w_down)


def gelu_mlp(x, w_up, w_down):
    # jax.nn.gelu defaults to the tanh approximation
    return dot(F.gelu(dot(x, w_up), approximate="tanh"), w_down)


def normal(shape, std: float, dtype: torch.dtype, device: torch.device,
           generator: torch.Generator) -> torch.Tensor:
    """N(0, std²) drawn directly on ``device`` in ``dtype``: a 7B bf16
    init never materializes a float32 copy on the host."""
    out = torch.empty(shape, dtype=dtype, device=device)
    out.normal_(0.0, std, generator=generator)
    return out


def init_mlp(cfg, d_model: int, d_ff: int, dtype: torch.dtype,
             device: torch.device, generator: torch.Generator):
    s_in = d_model ** -0.5
    s_ff = d_ff ** -0.5
    if cfg.mlp_type == "swiglu":
        return {
            "w_gate": normal((d_model, d_ff), s_in, dtype, device, generator),
            "w_up": normal((d_model, d_ff), s_in, dtype, device, generator),
            "w_down": normal((d_ff, d_model), s_ff, dtype, device, generator),
        }
    return {
        "w_up": normal((d_model, d_ff), s_in, dtype, device, generator),
        "w_down": normal((d_ff, d_model), s_ff, dtype, device, generator),
    }


def apply_mlp(x, params, cfg):
    if cfg.mlp_type == "swiglu":
        return swiglu(x, params["w_gate"], params["w_up"], params["w_down"])
    return gelu_mlp(x, params["w_up"], params["w_down"])
