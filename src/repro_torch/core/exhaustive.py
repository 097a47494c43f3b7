"""Strawman exhaustive search (paper §4.3): every permutation × every batch
composition.  O(N! · 2^N) — only usable for tiny N; exists as the oracle the
annealer is validated against (paper reports ≤1.0% degradation vs this).
"""
from __future__ import annotations

import itertools
from typing import Tuple

import numpy as np

from repro_torch.core.objective import evaluate


def _compositions(n: int, max_batch: int):
    """All ordered compositions of n with parts <= max_batch."""
    if n == 0:
        yield ()
        return
    for first in range(1, min(max_batch, n) + 1):
        for rest in _compositions(n - first, max_batch):
            yield (first,) + rest


def exhaustive_search(arrays: dict, model, max_batch: int
                      ) -> Tuple[np.ndarray, np.ndarray, float, int]:
    """Returns (perm, batch_id, G, evaluations)."""
    n = len(arrays["input_len"])
    best = (None, None, -1.0)
    evals = 0
    comps = list(_compositions(n, max_batch))
    for perm in itertools.permutations(range(n)):
        perm = np.array(perm, np.int64)
        for comp in comps:
            batch_id = np.repeat(np.arange(len(comp)), comp)
            g = evaluate(arrays, model, perm, batch_id).G
            evals += 1
            if g > best[2]:
                best = (perm.copy(), batch_id.copy(), g)
    return best[0], best[1], best[2], evals
