"""Algorithm 1 — simulated-annealing priority mapping (Python reference).

The working representation is ``batches: list[list[request_index]]`` —
contiguous priority order with explicit batch boundaries.  Three move
types (paper §4.3):

  0. squeezeLastIter — move a request into the *previous* batch iteration
     (valid when it is not in the first iteration and the previous batch has
     space).
  1. delayNextIter — move a request into the *next* batch iteration (valid
     when the next batch has space; delaying from the final batch opens a
     new iteration).
  2. randSwapping — exchange the positions of two requests.

Moves are *descriptors* (``("squeeze", k, j)`` etc.) scored by
``objective.IncrementalEvaluator`` in O(touched batch + n_batches) —
squeeze/delay/swap only perturb one or two batches, so the hot loop never
re-evaluates all N requests (``SAParams.incremental=False`` restores the
full-``evaluate``-per-proposal oracle path, kept for cross-checking and
benchmarking).  This is what keeps re-annealing cheap enough to run at
every admission event (paper Table 1's sub-millisecond overhead).

The JAX package also has a jitted, batched port of the same
incremental-Δ data structures; its PyTorch counterpart is still to
come.  This annealer builds its per-batch slack segments from
``objective.linear_request_coefs`` and is cross-checked against the
``objective.evaluate`` oracle; see docs/annealer.md.

Acceptance: the paper's pseudocode line 32 (`exp(-(f_new-f)/T) < rand`)
as literally printed never accepts a worse solution (the exponent is
positive, so exp(·) > 1 > rand).  That degenerates to greedy descent and
contradicts the paper's own discussion of escaping local optima, so we
implement standard Metropolis acceptance on the *relative* objective delta,

    P(accept worse) = exp( (f_new - f) / (f_ref · T / T0) ),

which at T = T0 accepts a −10% move with p ≈ 0.9 and at T = T_thres
(20/500) with p ≈ 0.08 — matching the qualitative behaviour in Fig. 8.
``acceptance="greedy"`` reproduces the literal pseudocode.

Early exits (paper line 7, symmetric on both starts and mid-anneal): the
annealer returns as soon as the e2e-sorted start or the FCFS start meets
*all* SLOs, and mid-anneal as soon as an accepted candidate meets all
SLOs *and* is the best-G solution seen so far (the G guard preserves the
invariant that the result never scores below either starting solution —
an all-met schedule with pathologically long total latency is still a
worse G, the paper's actual objective).
"""
from __future__ import annotations

import dataclasses
import math
import random
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.core.latency_model import LinearLatencyModel
from repro_torch.core.objective import (IncrementalEvaluator, evaluate,
                                  fcfs_schedule, sorted_by_e2e_schedule)


@dataclasses.dataclass
class SAParams:
    T0: float = 500.0
    T_thres: float = 20.0
    iters: int = 100          # iteration budget (see budget_mode)
    tau: float = 0.95         # decay rate
    acceptance: str = "metropolis"   # or "greedy" (paper pseudocode literal)
    # "global": Algorithm 1 as printed — k is initialized once (line 5) and
    # never reset, so ``iters`` bounds the TOTAL inner iterations across all
    # temperature levels (one extra eval per level after exhaustion, as the
    # repeat/until runs at least once).  This matches Table 1's near-constant
    # sub-millisecond overhead.  "per_level": k resets each level —
    # iters × n_levels evaluations (richer search, used for Fig. 8 sweeps).
    budget_mode: str = "global"
    # enabled move types (ablation studies): 0=squeeze, 1=delay, 2=swap
    moves: tuple = (0, 1, 2)
    seed: int = 0
    # score proposals with the incremental-Δ evaluator (False: full
    # ``evaluate`` per proposal — the O(N) oracle path)
    incremental: bool = True


@dataclasses.dataclass
class SAResult:
    perm: np.ndarray
    batch_id: np.ndarray
    G: float
    evaluations: int
    early_exit: bool
    history: Optional[list] = None


def _to_batches(perm, batch_id) -> List[List[int]]:
    nb = int(batch_id[-1]) + 1 if len(perm) else 0
    out = [[] for _ in range(nb)]
    for p, b in zip(perm, batch_id):
        out[b].append(int(p))
    return out


def _to_arrays(batches) -> Tuple[np.ndarray, np.ndarray]:
    perm, bid = [], []
    b_eff = 0
    for batch in batches:
        if not batch:
            continue
        perm.extend(batch)
        bid.extend([b_eff] * len(batch))
        b_eff += 1
    return np.array(perm, np.int64), np.array(bid, np.int64)


def _locate(batches: List[List[int]], flat: int) -> Tuple[int, int]:
    for bi, b in enumerate(batches):
        if flat < len(b):
            return bi, flat
        flat -= len(b)
    raise IndexError(flat)


def propose_move(batches: List[List[int]], max_batch: int,
                 rng: random.Random,
                 moves: tuple = (0, 1, 2),
                 n: Optional[int] = None) -> Optional[tuple]:
    """Sample a move descriptor; None if the sampled move is invalid
    (a no-op round, as in the paper's rejection of infeasible moves).
    ``n`` (total request count) may be passed to skip recounting."""
    nb = len(batches)
    if nb == 0:
        return None
    op = rng.choice(moves)
    if op == 0:        # squeezeLastIter: batch k -> k-1
        k = rng.randrange(nb)
        if k == 0 or len(batches[k - 1]) >= max_batch:
            return None
        return ("squeeze", k, rng.randrange(len(batches[k])))
    if op == 1:        # delayNextIter: batch k -> k+1 (maybe new)
        k = rng.randrange(nb)
        if len(batches[k]) == 1 and k == nb - 1:
            return None
        if k < nb - 1 and len(batches[k + 1]) >= max_batch:
            return None
        return ("delay", k, rng.randrange(len(batches[k])))
    # randSwapping: two distinct flat positions
    if n is None:
        n = sum(len(b) for b in batches)
    if n < 2:
        return None
    i1 = rng.randrange(n)
    i2 = rng.randrange(n - 1)
    if i2 >= i1:
        i2 += 1
    if nb == n:        # every batch is a singleton (e.g. max_batch == 1)
        return ("swap", i1, 0, i2, 0)
    b1, p1 = _locate(batches, i1)
    b2, p2 = _locate(batches, i2)
    return ("swap", b1, p1, b2, p2)


def apply_move(batches: List[List[int]], move: tuple) -> List[List[int]]:
    """Pure structural application of a move descriptor (new lists; the
    input is never mutated).  Mirror of ``IncrementalEvaluator.preview`` —
    used by the oracle path and the agreement tests."""
    new = list(batches)
    op = move[0]
    if op == "squeeze":
        k, j = move[1], move[2]
        src = new[k]
        new[k - 1] = new[k - 1] + [src[j]]
        rem = src[:j] + src[j + 1:]
        if rem:
            new[k] = rem
        else:
            del new[k]
    elif op == "delay":
        k, j = move[1], move[2]
        src = new[k]
        item = src[j]
        rem = src[:j] + src[j + 1:]
        if k == len(new) - 1:
            if rem:
                new[k] = rem
                new.append([item])
            else:      # singleton last batch: structurally a no-op
                new[k] = [item]
        else:
            new[k + 1] = [item] + new[k + 1]
            if rem:
                new[k] = rem
            else:
                del new[k]
    elif op == "swap":
        b1, i1, b2, i2 = move[1], move[2], move[3], move[4]
        if b1 == b2:
            nl = list(new[b1])
            nl[i1], nl[i2] = nl[i2], nl[i1]
            new[b1] = nl
        else:
            l1, l2 = list(new[b1]), list(new[b2])
            l1[i1], l2[i2] = l2[i2], l1[i1]
            new[b1], new[b2] = l1, l2
    else:
        raise ValueError(f"unknown move {move!r}")
    return new


def priority_mapping(arrays: dict, model: LinearLatencyModel,
                     max_batch: int, params: Optional[SAParams] = None,
                     record_history: bool = False) -> SAResult:
    """Algorithm 1.  arrays: columnar requests (slo.as_arrays)."""
    if params is None:       # None sentinel: a fresh SAParams per call
        params = SAParams()
    n = len(arrays["input_len"])
    rng = random.Random(params.seed)
    evals = 0

    # two starting solutions (lines 3, 12-15), each with the line-7 exit
    perm_s, bid_s = sorted_by_e2e_schedule(arrays, model, max_batch)
    ev_s = evaluate(arrays, model, perm_s, bid_s)
    evals += 1
    if ev_s.n_met == n:
        return SAResult(perm_s, bid_s, ev_s.G, evals, True,
                        [] if record_history else None)
    perm_0, bid_0 = fcfs_schedule(n, max_batch)
    ev_0 = evaluate(arrays, model, perm_0, bid_0)
    evals += 1
    if ev_0.n_met == n:
        return SAResult(perm_0, bid_0, ev_0.G, evals, True,
                        [] if record_history else None)
    if ev_s.G >= ev_0.G:
        batches = _to_batches(perm_s, bid_s)
    else:
        batches = _to_batches(perm_0, bid_0)

    inc = IncrementalEvaluator(arrays, model, batches) \
        if params.incremental else None
    f = inc.G if inc is not None else max(ev_s.G, ev_0.G)
    best_batches, best_f = batches, f
    f_ref = max(f, 1e-12)
    T = params.T0
    history = [] if record_history else None
    early = False
    k = 0                                    # line 5 — NOT reset per level
    while T >= params.T_thres:
        if params.budget_mode == "per_level":
            k = 0
        level_iters = max(params.iters - k, 1)   # repeat..until runs >= once
        for _ in range(level_iters):
            k += 1
            move = propose_move(batches, max_batch, rng, params.moves, n)
            if move is None:
                continue
            if inc is not None:
                f_new, n_met_new, staged = inc.preview(move)
            else:
                staged = apply_move(batches, move)
                perm_c, bid_c = _to_arrays(staged)
                ev_c = evaluate(arrays, model, perm_c, bid_c)
                f_new, n_met_new = ev_c.G, ev_c.n_met
            evals += 1
            accept = f_new > f
            if not accept and params.acceptance == "metropolis":
                p = math.exp((f_new - f) / (f_ref * T / params.T0))
                accept = rng.random() < p
            if accept:
                if inc is not None:
                    inc.commit(staged)
                    batches = inc.batches
                else:
                    batches = staged
                f = f_new
                if f > best_f:
                    best_batches, best_f = batches, f
                if n_met_new == n and f >= best_f:
                    # mid-anneal line-7 exit: all SLOs met — stop searching
                    best_batches, best_f = batches, f
                    early = True
                    break
        if early:
            break
        if history is not None:
            history.append((T, f, best_f))
        T *= params.tau
    perm_b, bid_b = _to_arrays(best_batches)
    # report G on the oracle scale (exact ``evaluate`` agreement)
    g_final = evaluate(arrays, model, perm_b, bid_b).G
    return SAResult(perm_b, bid_b, g_final, evals, early, history)
