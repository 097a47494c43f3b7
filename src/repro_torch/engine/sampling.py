"""Token sampling (counterpart of ``src/repro/engine/sampling.py``).

On a tensor-parallel mesh every rank calls :func:`sample` on the same
whole logits (put back together on every rank) with a generator of its
own, seeded alike and drawn from in the same order, so every rank draws
the same ids at any temperature and the next round's inputs never cross
the host."""
from __future__ import annotations

from typing import Optional

import torch


def sample(logits: torch.Tensor, generator: Optional[torch.Generator] = None,
           temperature: float = 0.0, top_k: int = 0) -> torch.Tensor:
    """logits: [B, V] -> token ids [B] int32.  Greedy at temperature 0
    (first maximal index, as ``jnp.argmax``); otherwise a categorical
    draw from ``generator``, which must live on the logits' device."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    logits = logits.float() / temperature
    if top_k > 0:
        kth = torch.topk(logits, top_k, dim=-1).values[:, -1:]
        logits = logits.masked_fill(logits < kth, -1e30)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(
        torch.int32)
