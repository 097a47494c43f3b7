"""Mixture-of-Experts FFN: a token-choice top-k router over stacked expert
weights (counterpart of ``src/repro/models/moe.py``, single device).

Token-expert pairs are sorted stably by expert id and run through three
grouped products (:func:`repro_torch.kernels.ops.ragged_dot`, the
counterpart of ``jax.lax.ragged_dot``) against the ``[E, d, ff]``
expert weights: no dense ``[T, E, C]`` dispatch tensor.  Each token's k
outputs are written back to their (token, choice) rows, ``[T, k, d]``,
and summed over k in a fixed order, where the JAX package scatter-adds
them; a CUDA ``index_add_`` would add with atomics in no set order, and
the decode round would not repeat bit for bit.  The group sizes are
counted by comparison with the expert ids (``torch.bincount`` reads its
maximum back to the host on a CUDA tensor), so an MoE layer reads
nothing back.

``torch.topk`` and ``jax.lax.top_k`` may break an exact tie between two
router probabilities differently; at seeded random weights no two
float32 probabilities of a token tie, and the tests use such weights.

Not ported yet (ROADMAP M11): the ``ShardingCtx`` / ``shard_map``
branches of ``moe_ffn`` and the expert-parallel ``_local_moe_ep``, which
need a device mesh.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.layers import dot, normal


def init_moe(cfg, dtype: torch.dtype, device: torch.device,
             generator: torch.Generator):
    """The float32 router ``[d, E]``, the stacked expert weights and, with
    ``num_shared_experts``, the shared experts as one MLP of width
    ``ff * num_shared_experts`` (the JAX tree)."""
    e = cfg.moe
    d, ff, n = cfg.d_model, e.d_ff_expert, e.num_experts
    s, sf = d ** -0.5, ff ** -0.5
    p = {"router": normal((d, n), s, torch.float32, device, generator),
         "w_gate": normal((n, d, ff), s, dtype, device, generator),
         "w_up": normal((n, d, ff), s, dtype, device, generator),
         "w_down": normal((n, ff, d), sf, dtype, device, generator)}
    if e.num_shared_experts:
        ff_sh = ff * e.num_shared_experts
        p["shared"] = {
            "w_gate": normal((d, ff_sh), s, dtype, device, generator),
            "w_up": normal((d, ff_sh), s, dtype, device, generator),
            "w_down": normal((ff_sh, d), sf, dtype, device, generator)}
    return p


def _local_moe(x2d, router, w_gate, w_up, w_down, top_k: int):
    """Token-choice top-k MoE over a slab of tokens.  x2d: [T, d].
    Returns ([T, d] in x2d's dtype, router probabilities [T, E] f32)."""
    t, d = x2d.shape
    n_experts = router.shape[1]
    probs = torch.softmax(x2d.float() @ router, dim=-1)        # [T, E]
    gate_vals, expert_idx = torch.topk(probs, top_k, dim=-1)   # [T, k]
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)

    flat_expert = expert_idx.reshape(-1)                       # [T*k]
    order = torch.argsort(flat_expert, stable=True)
    xs = x2d[order // top_k]                                   # [T*k, d]
    group_sizes = (flat_expert[:, None] == torch.arange(
        n_experts, device=x2d.device)).sum(0, dtype=torch.int32)

    g = ops.ragged_dot(xs, w_gate, group_sizes)
    u = ops.ragged_dot(xs, w_up, group_sizes)
    y = ops.ragged_dot(F.silu(g) * u, w_down, group_sizes)    # [T*k, d]

    # row r of y is pair order[r]: back to (token, choice) order (each
    # row written once, so no order of writes matters)
    pairs = torch.empty_like(y)
    pairs[order] = y
    out = (pairs.reshape(t, top_k, d)
           * gate_vals.to(y.dtype)[..., None]).sum(dim=1)
    return out.to(x2d.dtype), probs


def load_balance_loss(probs, expert_idx_probs, top_k: int):
    """Switch-style auxiliary load-balancing loss (f·P formulation)."""
    n_experts = probs.shape[-1]
    p_mean = probs.mean(dim=0)
    # share of tokens whose argmax is each expert (a one-hot by
    # comparison: F.one_hot reads its range back on a CUDA tensor)
    hard = probs.argmax(dim=-1)[:, None] == torch.arange(
        n_experts, device=probs.device)
    return n_experts * torch.sum(hard.float().mean(dim=0) * p_mean)


def moe_ffn(params, cfg, x):
    """MoE FFN over x [B, S, D], shared experts included.  Returns (out,
    the load-balance loss as a float32 0-d tensor)."""
    e = cfg.moe
    b, s, d = x.shape
    out, probs = _local_moe(x.reshape(b * s, d), params["router"],
                            params["w_gate"], params["w_up"],
                            params["w_down"], e.top_k)
    out = out.reshape(b, s, d)
    loss = load_balance_loss(probs, None, e.top_k)
    if e.num_shared_experts:
        sh = params["shared"]
        out = out + dot(F.silu(dot(x, sh["w_gate"])) * dot(x, sh["w_up"]),
                        sh["w_down"])
    return out, loss
