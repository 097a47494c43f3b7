"""Mixture-of-Experts FFN: a token-choice top-k router over stacked expert
weights (counterpart of ``src/repro/models/moe.py``).

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

Under a mesh (a :class:`ShardingCtx`) ``moe_ffn`` takes the reference's
three branches, each rank a process holding its rows of the batch:

* **expert parallel** (``ctx.expert_parallel`` and the experts divide the
  tp axis): a rank holds ``E/tp`` experts, routes every token of its rows
  against the whole router and runs only the pairs its experts own
  (:func:`_local_moe_ep`; the other pairs are absorbed: their rows come
  out zero), and one ``all_reduce`` sums the tp ranks' outputs; the
  load-balance loss is the mean of the data ranks' losses;
* **2-D expert parallel** (the same, under FSDP, for at most 4096 tokens
  of the whole batch): the experts stay as stored, ``E/tp`` of them x
  ``F/data`` of each one's columns; the data ranks' rows are gathered,
  each rank runs every token's pairs over its experts' columns, and the
  outputs are summed over every rank (:func:`_local_moe_2d`);
* **baseline**: each rank holds every expert (the reference's
  ``shard_map`` gathers them to every device), takes its slice of the
  sequence where ``s > 1`` divides the tp axis, and the slices are put
  back together on every rank; the load-balance loss is then the mean
  of the slices' and the data ranks' losses, as the reference's
  ``pmean``.

On a sequence-parallel rank's rows (``rows``, ``attn_sharding="auto"``)
the baseline branch takes the rows as its slice of the sequence (no
second slicing, the slices' outputs stay on their ranks, the loss still
the mean of the slices'); the expert-parallel and 2-D branches gather
the rows, run as on a whole sequence, and hand back the rank's rows; the
shared experts gather the rows and reduce-scatter their output where
the tp axis splits them, else run on the rows.

Under FSDP the expert weights come in as this rank's shards and the
expert-parallel and baseline branches gather them (``fsdp_dims``).  The
gradients are the true ones on every branch: where a replicated tensor
(the tokens, the gates, a weight used on a sequence slice) enters a
computation that each rank does a part of, it goes through
``layers.tp_enter`` (or, in the 2-D branch, a gather whose backward sums
over every rank), so the ranks' parts of its gradient are summed.  The
reference's expert-parallel backward at tp > 1 is not (ROADMAP §3).

The shared experts are an MLP split like any other (columns of
``w_gate``/``w_up``, rows of ``w_down``, then the sum).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.layers import (all_gather, all_reduce,
                                       data_all_reduce, dp_axis, dp_rank,
                                       dp_size, enter, fsdp_gather, normal,
                                       seq_gather, seq_rows, swiglu_mlp,
                                       tp_all_gather, tp_all_reduce,
                                       tp_enter, tp_mlp, tp_rank, tp_size,
                                       tp_split)


class ShardingCtx(NamedTuple):
    """Mesh context threaded through the model's forward passes (the
    reference's fields; ``mesh`` is a :class:`repro_torch.launch.mesh.Mesh`
    holding this rank's coordinates and process groups)."""
    mesh: object
    dp_axes: tuple = ("data",)         # axes sharding the batch
    tp_axis: str = "model"             # axis sharding heads/ffn/experts
    seq_shard: bool = True             # shard seq over tp_axis inside MoE
    expert_parallel: bool = False      # expert-parallel MoE (summed)
    attn_sharding: str = "none"        # "auto": sequence-parallel attention
    fsdp_axes: tuple = ()              # axes the weights are fsdp-sharded on


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


def _route(x2d, router, top_k: int):
    """Router probabilities [T, E] f32 and each token's top-k experts
    with their renormalized gates ([T, k] each)."""
    probs = torch.softmax(x2d.float() @ router, dim=-1)        # [T, E]
    gate_vals, expert_idx = torch.topk(probs, top_k, dim=-1)   # [T, k]
    return probs, gate_vals / gate_vals.sum(dim=-1, keepdim=True), \
        expert_idx


def _experts(x2d, sort_key, n_groups: int, w_gate, w_up, w_down,
             top_k: int, keep=None):
    """The (token, choice) pairs sorted stably by ``sort_key`` ([T*k];
    pairs keyed ``n_groups`` or more sort last and belong to no group)
    through the three grouped products.  Returns [T*k, d] in pair
    order; the rows of pairs where ``keep`` ([T*k] bool) is False are
    zero.

    The grouped product on the card leaves the rows past its last group
    unwritten, in its output and in its input's gradient, so with
    ``keep`` those rows of each product's input are selected to zero
    (the gradients that come back through them are then dropped) and
    the output rows selected away."""
    order = torch.argsort(sort_key, stable=True)
    xs = x2d[order // top_k]                                   # [T*k, d]
    group_sizes = (sort_key[:, None] == torch.arange(
        n_groups, device=x2d.device)).sum(0, dtype=torch.int32)
    if keep is not None:
        # the sorted rows in a group: the first as many as keep holds
        grouped = (torch.arange(xs.shape[0], device=xs.device)
                   < keep.sum())[:, None]
        xs = torch.where(grouped, xs, torch.zeros_like(xs))
    g = ops.ragged_dot(xs, w_gate, group_sizes)
    u = ops.ragged_dot(xs, w_up, group_sizes)
    h = F.silu(g) * u
    if keep is not None:
        h = torch.where(grouped, h, torch.zeros_like(h))
    y = ops.ragged_dot(h, w_down, group_sizes)                # [T*k, d]
    # row r of y is pair order[r]: back to (token, choice) order (each
    # row written once, so no order of writes matters)
    pairs = torch.empty_like(y)
    pairs[order] = y
    if keep is not None:
        # rows past the last group are not computed by the grouped
        # product on the card: select, never multiply, them away
        pairs = torch.where(keep[:, None], pairs, torch.zeros_like(pairs))
    return pairs


def _combine(pairs, gate_vals, t: int, top_k: int, dtype):
    """Each token's k outputs weighted by its gates, summed over k in a
    fixed order (no atomics)."""
    d = pairs.shape[-1]
    out = (pairs.reshape(t, top_k, d)
           * gate_vals.to(pairs.dtype)[..., None]).sum(dim=1)
    return out.to(dtype)


def _local_moe(x2d, router, w_gate, w_up, w_down, top_k: int):
    """Token-choice top-k MoE over a slab of tokens.  x2d: [T, d].
    Returns ([T, d] in x2d's dtype, router probabilities [T, E] f32)."""
    t = x2d.shape[0]
    probs, gate_vals, expert_idx = _route(x2d, router, top_k)
    pairs = _experts(x2d, expert_idx.reshape(-1), router.shape[1], w_gate,
                     w_up, w_down, top_k)
    return _combine(pairs, gate_vals, t, top_k, x2d.dtype), probs


def _local_moe_ep(x2d, router, w_gate, w_up, w_down, top_k: int, ctx):
    """Expert-parallel MoE on one rank: every token routed against the
    whole router, only the pairs owned by this rank's ``E_local =
    w_gate.shape[0]`` experts run (the rest sort past the last group
    and come out zero, where the reference absorbs them into a zero
    dummy expert), and the ranks' outputs are summed over the tp group.
    The tokens and the gates enter the rank's experts through
    ``tp_enter``.  Returns ([T, d], router probabilities [T, E] f32)."""
    t = x2d.shape[0]
    e_local = w_gate.shape[0]
    probs, gate_vals, expert_idx = _route(x2d, router, top_k)
    sort_key, in_range = _local_pairs(expert_idx, tp_rank(ctx) * e_local,
                                      e_local)
    pairs = _experts(tp_enter(x2d, ctx), sort_key, e_local, w_gate, w_up,
                     w_down, top_k, keep=in_range)
    out = _combine(pairs, tp_enter(gate_vals, ctx), t, top_k, x2d.dtype)
    return tp_all_reduce(out, ctx), probs


def _local_pairs(expert_idx, lo: int, e_local: int):
    """The sort key of each (token, choice) pair over experts ``lo`` to
    ``lo + e_local`` (the others keyed past the last group) and which
    pairs those experts own."""
    local_id = expert_idx.reshape(-1) - lo                     # [T*k]
    in_range = (local_id >= 0) & (local_id < e_local)
    return torch.where(in_range, local_id,
                       torch.full_like(local_id, e_local)), in_range


def _local_moe_2d(x2d, router, w_gate, w_up, w_down, top_k: int, ctx):
    """The 2-D expert-parallel MoE on one rank of a (data, tp) mesh: the
    experts as stored, ``E/tp`` of them x ``F/data`` columns of each.
    Each data rank routes its rows; the rows and their router
    probabilities are gathered over the data axis, every token's pairs
    over this rank's experts run on its columns, and the outputs are
    summed over every rank, of which the data rank keeps its rows.  The
    load-balance loss is taken over every token, as the reference takes
    it on its gathered tokens.

    Backward: the gathered tokens' and gates' gradients are this rank's
    part (its experts, its columns) and are summed over every rank; the
    output's is each data rank's rows, summed over the data axis.
    Returns ([T, d], the load-balance loss)."""
    t = x2d.shape[0]
    data, pair = ctx.mesh.group(dp_axis(ctx)), \
        ctx.mesh.group((dp_axis(ctx), ctx.tp_axis))
    gather = dict(dim=0, group=data, index=dp_rank(ctx), parts=dp_size(ctx),
                  kind="moe_2d")
    probs = torch.softmax(x2d.float() @ router, dim=-1)        # [t, E]
    p_all = all_gather(probs, **gather)                        # [T, E]
    x_all = all_gather(x2d, **gather, bwd_group=pair)          # [T, d]
    gate_vals, expert_idx = torch.topk(p_all, top_k, dim=-1)
    gate_vals = enter(gate_vals / gate_vals.sum(dim=-1, keepdim=True), pair,
                      "moe_2d")
    e_local = w_gate.shape[0]
    sort_key, in_range = _local_pairs(expert_idx, tp_rank(ctx) * e_local,
                                      e_local)
    pairs = _experts(x_all, sort_key, e_local, w_gate, w_up, w_down, top_k,
                     keep=in_range)
    out = _combine(pairs, gate_vals, x_all.shape[0], top_k, x2d.dtype)
    out = all_reduce(out, pair, bwd_group=data, kind="moe_2d")
    return out.narrow(0, dp_rank(ctx) * t, t), \
        load_balance_loss(p_all, None, top_k)


def load_balance_loss(probs, expert_idx_probs, top_k: int):
    """Switch-style auxiliary load-balancing loss (f·P formulation)."""
    n_experts = probs.shape[-1]
    p_mean = probs.mean(dim=0)
    # share of tokens whose argmax is each expert (a one-hot by
    # comparison: F.one_hot reads its range back on a CUDA tensor)
    hard = probs.argmax(dim=-1)[:, None] == torch.arange(
        n_experts, device=probs.device)
    return n_experts * torch.sum(hard.float().mean(dim=0) * p_mean)


def moe_ffn(params, cfg, x, ctx=None, fsdp_dims=None, rows: bool = False):
    """MoE FFN over x [B, S, D], shared experts included.  Returns (out,
    the load-balance loss as a float32 0-d tensor).  With a ``ctx``, the
    branch the reference takes (module docstring); ``x`` holds this data
    rank's rows, the whole batch ``B * data`` rows (a batch the data
    axis does not divide is whole on every data rank: the step then
    runs ``data`` copies of it, whose loss and gradients are its own).
    ``fsdp_dims``: the FSDP dims of the expert weights, which ``params``
    then holds as this rank's shards (the router and the shared experts
    come whole).
    ``rows``: ``x`` is this tp rank's rows of a sequence-parallel
    residual, and so is the output."""
    e = cfg.moe
    if rows:
        ep = ctx.expert_parallel and e.num_experts % tp_size(ctx) == 0
        if ep or not ctx.seq_shard:
            # these branches run on the whole sequence: gather the rows
            out, loss = moe_ffn(params, cfg, seq_gather(x, ctx), ctx,
                                fsdp_dims)
            return seq_rows(out, ctx), loss
    b, s, d = x.shape
    wg, wu, wd = params["w_gate"], params["w_up"], params["w_down"]
    router = params["router"]
    if ctx is None:
        out, probs = _local_moe(x.reshape(b * s, d), router, wg, wu, wd,
                                e.top_k)
        out, loss = out.reshape(b, s, d), load_balance_loss(probs, None,
                                                            e.top_k)
        return _shared(params, cfg, x, out, ctx), loss
    tp, data = tp_size(ctx), dp_size(ctx)
    dims = fsdp_dims or {}

    def whole(name, w):
        return fsdp_gather(w, dims.get(name), ctx)
    if ctx.expert_parallel and e.num_experts % tp == 0:
        tp_split(e.num_experts, wg.shape[0], ctx, "experts")
        if ctx.fsdp_axes and b * data * s <= 4096:
            out, loss = _local_moe_2d(x.reshape(b * s, d), router, wg, wu,
                                      wd, e.top_k, ctx)
        else:
            out, probs = _local_moe_ep(
                x.reshape(b * s, d), router, whole("w_gate", wg),
                whole("w_up", wu), whole("w_down", wd), e.top_k, ctx)
            loss = _data_mean(load_balance_loss(probs, None, e.top_k), ctx)
        return _shared(params, cfg, x, out.reshape(b, s, d), ctx), loss
    if wg.shape[0] != e.num_experts:
        raise ValueError("the baseline MoE branch runs every expert on "
                         f"every rank; this rank holds {wg.shape[0]} of "
                         f"{e.num_experts}")
    ws = [whole(n, w) for n, w in (("w_gate", wg), ("w_up", wu),
                                   ("w_down", wd))]
    if rows or (tp > 1 and ctx.seq_shard and s > 1 and s % tp == 0):
        # this rank's slice of the sequence (on a sequence-parallel
        # residual, its rows already, and the output stays on them): the
        # router and the experts enter it
        xs = x if rows else seq_rows(x, ctx)
        n = xs.shape[1]
        out, probs = _local_moe(xs.reshape(b * n, d), tp_enter(router, ctx),
                                *(tp_enter(w, ctx) for w in ws), e.top_k)
        out = out.reshape(b, n, d)
        if not rows:
            out = tp_all_gather(out, ctx, dim=1)
        loss = tp_all_reduce(load_balance_loss(probs, None, e.top_k),
                             ctx) / tp
    else:
        # one token a slot (decode) or a length the tp axis does not
        # divide: every rank runs every token, as the reference's
        # shard_map does with an unsharded token axis
        out, probs = _local_moe(x.reshape(b * s, d), router, *ws, e.top_k)
        out = out.reshape(b, s, d)
        loss = load_balance_loss(probs, None, e.top_k)
    return _shared(params, cfg, x, out, ctx, rows), _data_mean(loss, ctx)


def _data_mean(loss, ctx):
    """The mean of the data ranks' losses (the reference's ``pmean``
    over the batch shards)."""
    data = dp_size(ctx)
    return loss if data == 1 else data_all_reduce(loss, ctx) / data


def _shared(params, cfg, x, out, ctx, rows: bool = False):
    """``out`` plus the shared experts' MLP of ``x`` (an MLP split over
    tp like any other, ``layers.tp_mlp``; ``rows``: on a
    sequence-parallel rank's rows)."""
    e = cfg.moe
    if not e.num_shared_experts:
        return out
    sh = params["shared"]
    split = ctx is not None and tp_split(
        e.d_ff_expert * e.num_shared_experts, sh["w_down"].shape[0], ctx,
        "shared experts")
    return out + tp_mlp(x, sh, swiglu_mlp, ctx, split, rows)
