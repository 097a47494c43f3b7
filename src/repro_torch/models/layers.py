"""Shared layer primitives: norms, rotary embeddings (incl. M-RoPE), MLPs,
and the tensor-parallel reductions.

Counterpart of ``src/repro/models/layers.py``; parameters keep the JAX layout
(``x @ w`` with ``w: [d_in, d_out]``).

Under a mesh (a ``ShardingCtx``, :mod:`repro_torch.models.moe`) each rank
is a process holding its slice of the weights, and the sums GSPMD inserts
in the JAX package are explicit here: :func:`tp_all_reduce` after a
row-parallel product (``wo``, the MLP's ``w_down``), :func:`tp_all_gather`
where each rank computed a slice of a dim (vocabulary logits, MoE token
slices).  Both are ``all_reduce`` calls on the ctx's tp group, the one
collective gloo runs on CUDA tensors; a bf16 tensor is reduced in float32
and rounded once.  Without a ctx (or at tp 1) they are the identity.
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


# ----------------------------------------------------- tensor parallel
def tp_size(ctx) -> int:
    return 1 if ctx is None else ctx.mesh.shape[ctx.tp_axis]


def tp_rank(ctx) -> int:
    return 0 if ctx is None else ctx.mesh.coords[ctx.tp_axis]


def heads_split(cfg, tp: int) -> bool:
    """Whether a tp-way mesh splits the attention heads over its ranks.
    GQA: both the q and the kv heads must divide it, so that each rank's
    contiguous q heads are the groups of its whole kv heads.  MLA: the
    heads must divide it (each rank ``num_heads / tp`` of them); the
    latent has no heads and stays whole."""
    if tp <= 1 or cfg.num_heads < tp or cfg.num_heads % tp:
        return False
    if cfg.mla is not None:
        return True
    return cfg.num_kv_heads >= tp and cfg.num_kv_heads % tp == 0


def tp_split(full: int, local: int, ctx, what: str = "dim") -> bool:
    """Whether a dim of ``full`` entries is split over the tp axis on
    this rank (the partition rules split it iff the tp axis divides it,
    ``sharding._div``), checked against the extent ``local`` the rank
    holds."""
    tp = tp_size(ctx)
    split = tp > 1 and full % tp == 0 and full >= tp
    want = full // tp if split else full
    if local != want:
        raise ValueError(f"{what}: this rank holds {local} of {full}, the "
                         f"placement rules give it {want} at tp {tp}")
    return split


def _reduce_dtype(x: torch.Tensor) -> torch.dtype:
    return torch.float32 if x.dtype in (torch.bfloat16, torch.float16) \
        else x.dtype


def tp_all_reduce(x: torch.Tensor, ctx) -> torch.Tensor:
    """Sum ``x`` over the ctx's tp group (a row-parallel product's
    partial sums); identity without a ctx."""
    if tp_size(ctx) == 1:
        return x
    import torch.distributed as dist
    y = x.to(_reduce_dtype(x), copy=True).contiguous()
    dist.all_reduce(y, group=ctx.mesh.group(ctx.tp_axis))
    return y.to(x.dtype)


def tp_all_gather(x: torch.Tensor, ctx, dim: int) -> torch.Tensor:
    """Concatenate each rank's ``x`` along ``dim`` in rank order, on
    every rank: each rank writes its slice into zeros and the group sums
    them (a sum with zeros is exact, and every rank gets the same
    bits)."""
    if tp_size(ctx) == 1:
        return x
    import torch.distributed as dist
    dim = dim % x.dim()
    n = x.shape[dim]
    shape = list(x.shape)
    shape[dim] = n * tp_size(ctx)
    full = torch.zeros(shape, dtype=_reduce_dtype(x), device=x.device)
    full.narrow(dim, tp_rank(ctx) * n, n).copy_(x)
    dist.all_reduce(full, group=ctx.mesh.group(ctx.tp_axis))
    return full.to(x.dtype)


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


def apply_mlp(x, params, cfg, ctx=None, d_ff: int = 0):
    """The MLP; under a mesh its ``d_ff`` (the whole width) columns of
    ``w_gate``/``w_up`` and rows of ``w_down`` are split over the tp axis
    where it divides, and the row-parallel ``w_down`` product is summed
    over the ranks."""
    if cfg.mlp_type == "swiglu":
        y = swiglu(x, params["w_gate"], params["w_up"], params["w_down"])
    else:
        y = gelu_mlp(x, params["w_up"], params["w_down"])
    if ctx is not None and tp_split(d_ff, params["w_down"].shape[0], ctx,
                                    "MLP width"):
        y = tp_all_reduce(y, ctx)
    return y
