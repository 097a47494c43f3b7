"""AdamW over a parameter tree (counterpart of
``src/repro/train/optimizer.py``).

Same defaults, global-norm clipping, linear warm-up, bias correction and
decoupled weight decay on tensors with ``ndim >= 2`` only; moments in
float32 on the parameters' device; each update computed in float32 and
cast back to the parameter's dtype.  Where the JAX version returns new
trees, :func:`apply` updates the parameters and the state's tensors in
place under ``torch.no_grad()`` (a 2-B-parameter model cannot hold two
copies of its weights and moments on one card) and returns the same
objects.

A tree is a dict or list of tensors nested as the model's parameters
are; :func:`leaves` and :func:`tree_map` walk it in one fixed order.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterator, NamedTuple

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100


class AdamWState(NamedTuple):
    step: torch.Tensor      # 0-d int32
    mu: Any
    nu: Any


def leaves(tree) -> Iterator[torch.Tensor]:
    if isinstance(tree, dict):
        for v in tree.values():
            yield from leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from leaves(v)
    else:
        yield tree


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the same-shaped ``rest``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def init(params) -> AdamWState:
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
    dev = next(leaves(params)).device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      mu=tree_map(zeros, params), nu=tree_map(zeros, params))


def _schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    return cfg.lr * warm


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(g.float() ** 2) for g in leaves(tree)))


@torch.no_grad()
def apply(cfg: AdamWConfig, params, grads, state: AdamWState):
    """One AdamW step, in place.  Returns (params, state, metrics) — the
    same param and state objects, updated."""
    state.step.add_(1)
    step = state.step.float()
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    bc1 = 1 - cfg.b1 ** step
    bc2 = 1 - cfg.b2 ** step
    lr = _schedule(cfg, step)
    for p, g, m, v in zip(leaves(params), leaves(grads), leaves(state.mu),
                          leaves(state.nu)):
        g = g.float() * scale
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
        p32 = p.float()
        delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        if p.dim() >= 2:        # decoupled weight decay on matrices only
            delta = delta + cfg.weight_decay * p32
        p.copy_(p32 - lr * delta)
    return params, state, {"grad_norm": gnorm, "lr": lr}
