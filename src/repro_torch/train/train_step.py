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
"""
from __future__ import annotations

from functools import partial

import torch

from repro_torch.device import upcast
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import forward_full
from repro_torch.train import optimizer as opt

AUX_LOSS_WEIGHT = 0.01


def lm_loss(params, cfg: ModelConfig, tokens, labels, mask=None,
            embeds=None, remat: bool = True):
    """Mean next-token cross entropy (+ MoE aux) over positions whose
    label is not -100 (and whose ``mask`` is > 0).  labels: [B,S] (or
    [B,S,K] for K codebooks: the mean over every codebook's positions);
    ``embeds`` [B,S,d] stands in for ``tokens``."""
    logits, _, aux = forward_full(params, cfg, tokens=tokens, embeds=embeds,
                                  remat=remat)
    valid = labels >= 0
    safe = torch.clamp(labels, min=0).long()
    lg = upcast(logits)
    target = torch.gather(lg, -1, safe[..., None])[..., 0]
    # the shift is for range only: the exact derivative through m is 0
    m = torch.amax(lg, dim=-1).detach()
    lse = m + torch.log(torch.sum(torch.exp(lg - m[..., None]), dim=-1))
    nll = lse - target
    if mask is not None:
        valid = valid & (mask > 0)
    denom = torch.clamp(valid.sum(), min=1)
    loss = torch.sum(torch.where(valid, nll, 0.0)) / denom
    aux = torch.as_tensor(aux, dtype=torch.float32, device=loss.device)
    return loss + AUX_LOSS_WEIGHT * aux, {"lm_loss": loss.detach(),
                                          "aux_loss": aux.detach()}


def loss_and_grads(cfg: ModelConfig, params, batch, remat: bool = True):
    """(loss, metrics, grads): grads a tree shaped like ``params``."""
    flat = list(opt.leaves(params))
    for t in flat:
        t.requires_grad_(True)
    try:
        loss, metrics = lm_loss(params, cfg, batch.get("tokens"),
                                batch["labels"], mask=batch.get("mask"),
                                embeds=batch.get("embeds"), remat=remat)
        # a leaf the loss does not reach (a VLM's token table under an
        # embeds batch) gets zeros, as jax.value_and_grad gives it
        grads = iter([torch.zeros_like(t) if g is None else g
                      for g, t in zip(torch.autograd.grad(
                          loss, flat, allow_unused=True), flat)])
    finally:
        for t in flat:
            t.requires_grad_(False)
    return loss.detach(), metrics, opt.tree_map(lambda _: next(grads),
                                                params)


def train_step(cfg: ModelConfig, opt_cfg: opt.AdamWConfig, params,
               opt_state, batch, remat: bool = True):
    """batch: {"tokens": [B,S] (or [B,S,K]), "labels": shaped like the
    tokens} or {"embeds": [B,S,d], "labels": [B,S]} (optional "mask").

    Updates ``params`` and ``opt_state`` in place and returns them with
    the metrics (``loss``, ``lm_loss``, ``aux_loss``, ``grad_norm``,
    ``lr``, 0-d tensors on the params' device)."""
    loss, metrics, grads = loss_and_grads(cfg, params, batch, remat=remat)
    params, opt_state, om = opt.apply(opt_cfg, params, grads, opt_state)
    return params, opt_state, dict(metrics, loss=loss, **om)


def make_train_step(cfg, opt_cfg, remat=True):
    return partial(train_step, cfg, opt_cfg, remat=remat)
