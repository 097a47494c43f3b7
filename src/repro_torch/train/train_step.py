"""Training step: causal-LM loss + AdamW update (counterpart of
``src/repro/train/train_step.py``).

Gradients come from ``torch.autograd.grad`` over the parameter leaves
(each set to require grad for the call only), where JAX takes
``value_and_grad``.  Every arch the JAX launcher trains trains here:
attention runs the differentiable flash kernels
(:mod:`repro_torch.kernels.flash_attention_bwd`), Mamba2 layers the
differentiable SSD scan (:class:`repro_torch.kernels.ssd_scan.SSDScanFn`,
whose backward is a kernel of its own), MoE layers the grouped product
under autograd, and MoE configs add the routers' load-balance loss
(``AUX_LOSS_WEIGHT``), as the JAX ``lm_loss`` does.  A batch carries
``tokens`` ([B, S], or [B, S, K] with K codebooks) or a VLM's ``embeds``
([B, S, d]), and ``labels`` shaped like the tokens.

Under a ``(data, tp)`` mesh (``ctx``, :func:`repro_torch.distributed.
sharding.make_ctx`) every rank calls these with its slice of the params
and moments (``sharding.rank_specs``; under FSDP the data axis shards
the large weights too) and its data rank's rows of the global batch
(``sharding.shard_batch``; all of them where the data axis does not
divide the batch, as the reference replicates it: the loss sums the
data ranks' copies over the count of every copy's tokens, so the loss
and, summed over the data axis, the gradients are the batch's own).
The loss is the sum of the data ranks' token losses over the global
count of valid tokens, the same value on every rank; the cross entropy
runs on the rank's vocabulary slice of the logits (a masked pick of the
target and ``[B, S]`` sums over tp, as the reference's ``lm_loss`` lets
GSPMD do); gradients of leaves whole over
the data axis are summed over it, and those of FSDP leaves arrive
summed from ``layers.fsdp_gather``'s backward.  Under
``attn_sharding="auto"`` (sequence-parallel attention) each tp rank
runs its rows of the sequence, and the gradients of the weights whole
on every tp rank that the rows use (the GQA projections, norm scales,
an unsplit MLP) arrive summed over tp from ``layers.tp_enter``'s
backward; the loss runs on the whole sequence, as without it.
"""
from __future__ import annotations

from functools import partial

import torch

from repro_torch.device import upcast
from repro_torch.distributed import sharding
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (data_all_reduce, dp_axis, dp_size,
                                       tally, tp_all_reduce, tp_max,
                                       tp_rank, tp_split)
from repro_torch.models.model import forward_full
from repro_torch.train import optimizer as opt

AUX_LOSS_WEIGHT = 0.01


def lm_loss(params, cfg: ModelConfig, tokens, labels, mask=None,
            embeds=None, ctx=None, remat: bool = True):
    """Mean next-token cross entropy (+ MoE aux) over positions whose
    label is not -100 (and whose ``mask`` is > 0).  labels: [B,S] (or
    [B,S,K] for K codebooks: the mean over every codebook's positions);
    ``embeds`` [B,S,d] stands in for ``tokens``.  ``ctx``: one rank of a
    mesh, on its data rank's rows (module docstring)."""
    logits, _, aux = forward_full(params, cfg, tokens=tokens, embeds=embeds,
                                  remat=remat, ctx=ctx, gather_logits=False)
    valid = labels >= 0
    safe = torch.clamp(labels, min=0).long()
    lg = upcast(logits)
    if ctx is not None and tp_split(cfg.vocab_size, lg.shape[-1], ctx,
                                    "vocabulary"):
        nll = _vocab_parallel_nll(lg, safe, ctx)
    else:
        target = torch.gather(lg, -1, safe[..., None])[..., 0]
        # the shift is for range only: the exact derivative through m is 0
        m = torch.amax(lg, dim=-1).detach()
        lse = m + torch.log(torch.sum(torch.exp(lg - m[..., None]), dim=-1))
        nll = lse - target
    if mask is not None:
        valid = valid & (mask > 0)
    total = torch.sum(torch.where(valid, nll, 0.0))
    count = valid.sum()
    if dp_size(ctx) > 1:
        total = data_all_reduce(total, ctx)
        count = data_all_reduce(count.float(), ctx)
    loss = total / torch.clamp(count, min=1)
    aux = torch.as_tensor(aux, dtype=torch.float32, device=loss.device)
    return loss + AUX_LOSS_WEIGHT * aux, {"lm_loss": loss.detach(),
                                          "aux_loss": aux.detach()}


def _vocab_parallel_nll(lg, safe, ctx):
    """Each position's -log p(target) from this rank's vocabulary slice
    of the float32 logits ``lg``: the target's logit picked where it
    falls in the slice, and the max (no gradient) and the sum of exps,
    each summed or reduced over tp (``[B, S]`` tensors; the logits stay
    on their ranks)."""
    n = lg.shape[-1]
    local = safe - tp_rank(ctx) * n
    mine = (local >= 0) & (local < n)
    picked = torch.gather(lg, -1, local.clamp(0, n - 1)[..., None])[..., 0]
    target = tp_all_reduce(torch.where(mine, picked, 0.0), ctx, "vocab")
    m = tp_max(torch.amax(lg, dim=-1).detach(), ctx, "vocab")
    se = tp_all_reduce(torch.sum(torch.exp(lg - m[..., None]), dim=-1), ctx,
                       "vocab")
    return m + torch.log(se) - target


def loss_and_grads(cfg: ModelConfig, params, batch, remat: bool = True,
                   ctx=None):
    """(loss, metrics, grads): grads a tree shaped like ``params``.
    ``ctx``: one rank of a mesh; the gradients are then this rank's
    slices of the whole batch's gradients."""
    flat = list(opt.leaves(params))
    for t in flat:
        t.requires_grad_(True)
    try:
        loss, metrics = lm_loss(params, cfg, batch.get("tokens"),
                                batch["labels"], mask=batch.get("mask"),
                                embeds=batch.get("embeds"), ctx=ctx,
                                remat=remat)
        # a leaf the loss does not reach (a VLM's token table under an
        # embeds batch) gets zeros, as jax.value_and_grad gives it
        grads = [torch.zeros_like(t) if g is None else g
                 for g, t in zip(torch.autograd.grad(
                     loss, flat, allow_unused=True), flat)]
    finally:
        for t in flat:
            t.requires_grad_(False)
    if dp_size(ctx) > 1:
        _sum_over_data(grads, params, cfg, ctx)
    grads = iter(grads)
    return loss.detach(), metrics, opt.tree_map(lambda _: next(grads),
                                                params)


# elements an all_reduce of the data-axis gradient sum takes at most: the
# small leaves (norm scales) go together, a large one (an embedding) alone
SUM_BUCKET = 1 << 26


@torch.no_grad()
def _sum_over_data(grads, params, cfg, ctx):
    """Sum over the data axis, in the list ``grads``, the gradients of
    the leaves whole over it, in float32, a bucket of leaves at a time
    (the others, FSDP shards, arrive summed)."""
    import torch.distributed as dist
    dims = sharding.fsdp_dims(_specs(cfg, ctx), sharding.parallelism_of(ctx))
    # the dims in the order of the params' leaves (paired by key)
    dims = opt.leaves(opt.tree_map(lambda _, d: d, params, dims))
    buckets, size = [], SUM_BUCKET
    for i, d in enumerate(dims):
        if d is not None:
            continue
        n = grads[i].numel()
        if size + n > SUM_BUCKET:
            buckets.append([])
            size = 0
        buckets[-1].append(i)
        size += n
    group = ctx.mesh.group(dp_axis(ctx))
    for bucket in buckets:
        flat = torch.cat([grads[i].float().reshape(-1) for i in bucket])
        tally("data_grad_sum", flat)
        dist.all_reduce(flat, group=group)
        for i, part in zip(bucket, flat.split([grads[i].numel()
                                               for i in bucket])):
            grads[i] = part.view(grads[i].shape).to(grads[i].dtype)


def _specs(cfg, ctx):
    return sharding.rank_specs(cfg, ctx.mesh, sharding.parallelism_of(ctx))


def train_step(cfg: ModelConfig, opt_cfg: opt.AdamWConfig, params,
               opt_state, batch, remat: bool = True, ctx=None):
    """batch: {"tokens": [B,S] (or [B,S,K]), "labels": shaped like the
    tokens} or {"embeds": [B,S,d], "labels": [B,S]} (optional "mask").

    Updates ``params`` and ``opt_state`` in place and returns them with
    the metrics (``loss``, ``lm_loss``, ``aux_loss``, ``grad_norm``,
    ``lr``, 0-d tensors on the params' device).  ``ctx``: one rank of a
    mesh (module docstring): params, moments and batch are this rank's,
    and the metrics are the whole step's, alike on every rank."""
    loss, metrics, grads = loss_and_grads(cfg, params, batch, remat=remat,
                                          ctx=ctx)
    mesh = None if ctx is None else ctx.mesh
    params, opt_state, om = opt.apply(
        opt_cfg, params, grads, opt_state, mesh=mesh,
        specs=None if ctx is None else _specs(cfg, ctx))
    return params, opt_state, dict(metrics, loss=loss, **om)


def make_train_step(cfg, opt_cfg, remat=True, ctx=None):
    return partial(train_step, cfg, opt_cfg, remat=remat, ctx=ctx)
