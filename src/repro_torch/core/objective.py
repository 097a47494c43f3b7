"""Schedule objective G (paper §3.1, Eqs. 1–13).

A *schedule* for N requests is
  * ``perm``      — permutation of request indices (priority order), and
  * ``batch_id``  — monotone non-decreasing batch index per *position*
                    (positions are contiguous within a batch).

Execution semantics (paper Eq. 10–12): batches run sequentially; every
request in batch j starts once batches 0..j-1 finished; batch j's duration
is the max exec time of its members, each evaluated at batch size b_j.

``evaluate`` is fully vectorized (numpy) — O(N) per schedule — and is the
oracle both annealers are validated against.  The Python annealer's hot
loop no longer calls it per proposal: :class:`IncrementalEvaluator` keeps
per-batch aggregates and scores a move in O(touched batch + n_batches).
"""
from __future__ import annotations

import dataclasses
from bisect import bisect_left
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.latency_model import LinearLatencyModel


@dataclasses.dataclass
class ScheduleEval:
    G: float
    n_met: int
    total_latency: float          # t = Σ t_e2e  (Eq. 3)
    avg_latency: float
    attainment: float
    e2e: np.ndarray               # per original request index
    ttft: np.ndarray
    tpot: np.ndarray
    met: np.ndarray


def batch_sizes_from_id(batch_id: np.ndarray) -> np.ndarray:
    m = int(batch_id[-1]) + 1 if len(batch_id) else 0
    return np.bincount(batch_id, minlength=m)


def evaluate(arrays: dict, model: LinearLatencyModel, perm: np.ndarray,
             batch_id: np.ndarray) -> ScheduleEval:
    """arrays: columnar request view (slo.as_arrays)."""
    li = arrays["input_len"][perm]
    lo = arrays["output_len"][perm]
    h = arrays["h"][perm]
    slo_e2e = arrays["slo_e2e"][perm]
    slo_ttft = arrays["slo_ttft"][perm]
    slo_tpot = arrays["slo_tpot"][perm]
    cp = _cached_col(arrays)
    cp = cp[perm] if cp is not None else 0.0

    n = len(perm)
    nb = int(batch_id[-1]) + 1 if n else 0
    bsz = np.bincount(batch_id, minlength=nb).astype(np.float64)
    b_of = bsz[batch_id]                                  # batch size per pos

    # shared-prefix reuse: prefill is priced at the unique new tokens
    # (l_i - cached_prefix); decode keeps the full context l_i
    t_exec = model.exec_time(b_of, li, lo, cached=cp)     # Eq. 17
    t_pref = model.prefill_time(b_of, li, cached=cp)      # Eq. 18
    t_tpot = model.tpot(b_of, li, lo)                     # Eq. 19

    # batch duration = max member exec; wait = cumsum of previous batches
    bdur = np.zeros(nb)
    np.maximum.at(bdur, batch_id, t_exec)
    wait_of_batch = np.concatenate([[0.0], np.cumsum(bdur)[:-1]])
    t_wait = wait_of_batch[batch_id]                      # Eq. 11

    e2e = t_exec + t_wait                                 # Eq. 4
    ttft = t_pref + t_wait                                # Eq. 8

    met = np.where(h == 1,
                   e2e <= slo_e2e,
                   (ttft <= slo_ttft) & (t_tpot <= slo_tpot))  # Eq. 7
    n_met = int(met.sum())
    total = float(e2e.sum())
    G = n_met / total if total > 0 else 0.0               # Eq. 2

    # scatter back to original request order
    inv = np.empty(n, np.int64)
    inv[perm] = np.arange(n)
    return ScheduleEval(
        G=G, n_met=n_met, total_latency=total,
        avg_latency=total / max(n, 1),
        attainment=n_met / max(n, 1),
        e2e=e2e[inv], ttft=ttft[inv], tpot=t_tpot[inv], met=met[inv],
    )


def calculate_g(arrays, model, perm, batch_id) -> float:
    return evaluate(arrays, model, np.asarray(perm), np.asarray(batch_id)).G


def fcfs_schedule(n: int, max_batch: int):
    """Arrival order, maximal batches — the paper's 'initial sequence'."""
    perm = np.arange(n)
    batch_id = np.arange(n) // max_batch
    return perm, batch_id


def sorted_by_e2e_schedule(arrays, model, max_batch: int):
    """Priority aligned with predicted e2e latency (Algorithm 1 line 3)."""
    li, lo = arrays["input_len"], arrays["output_len"]
    t = model.exec_time(np.minimum(max_batch, len(li)), li, lo)
    perm = np.argsort(t, kind="stable")
    batch_id = np.arange(len(li)) // max_batch
    return perm, batch_id


def _cached_col(arrays: dict):
    """Per-request cached-prefix column (``slo.as_arrays``), clipped to
    [0, l_i - 1]; None when the workload carries no prefix metadata."""
    cp = arrays.get("cached_prefix")
    if cp is None:
        return None
    li = np.asarray(arrays["input_len"], np.float64)
    return np.clip(np.asarray(cp, np.float64), 0.0, np.maximum(li - 1, 0.0))


# ------------------------------------------------------------ incremental
def linear_request_coefs(arrays: dict, model) -> dict:
    """Per-request coefficients of the latency model, linear in batch size.

    ``LinearLatencyModel`` (Eqs. 14-16) is linear in the batch size ``b``,
    so every per-request quantity a schedule evaluator needs collapses to
    a pair ``A·b + C`` precomputed once per request:

      exec_time(b)    = eA·b + eC        (Eq. 17)
      prefill_time(b) = pA·b + pC        (Eq. 18)
      tpot(b)         = tA·b + tC        (Eq. 19, output length clamped
                                          to >= 1 exactly as model.tpot)

    This is the contract of the incremental annealer:
    :class:`IncrementalEvaluator` builds its per-batch slack segments
    from these arrays and is cross-checked against the full
    :func:`evaluate` oracle (see docs/annealer.md).

    Returns a dict of float64 arrays: eA, eC, pA, pC, tA, tC.
    """
    li = np.asarray(arrays["input_len"], np.float64)
    lo = np.asarray(arrays["output_len"], np.float64)
    lo_c = np.maximum(lo, 1.0)
    # shared-prefix reuse: prefill coefficients are built from the
    # *unique* prompt span l_i - cached_prefix (exec = that prefill plus
    # the full-context decode; TPOT is decode-only, so untouched) — this
    # single discount is what makes BOTH annealer backends rank
    # cached-prefix requests by their true (shorter) prefill
    cp = _cached_col(arrays)
    lp = li - cp if cp is not None else li
    tri = li * lo + lo * (lo + 1) / 2.0              # Eq. 16 closed form
    # model.tpot clamps l_o to 1 *before* recomputing the decode time,
    # so the TPOT coefficients must be built from the clamped length
    tri_c = li * lo_c + lo_c * (lo_c + 1) / 2.0
    m = model
    return {
        "eA": m.alpha_p * lp + m.beta_p + m.alpha_d * tri + m.beta_d * lo,
        "eC": m.gamma_p * lp + m.delta_p + m.gamma_d * tri + m.delta_d * lo,
        "pA": m.alpha_p * lp + m.beta_p,
        "pC": m.gamma_p * lp + m.delta_p,
        "tA": (m.alpha_d * tri_c + m.beta_d * lo_c) / lo_c,
        "tC": (m.gamma_d * tri_c + m.delta_d * lo_c) / lo_c,
    }


class _BatchStat:
    """Aggregates for one batch at its current size."""
    __slots__ = ("size", "sum_exec", "bdur", "slacks")

    def __init__(self, size: int, sum_exec: float, bdur: float,
                 slacks: List[float]):
        self.size = size
        self.sum_exec = sum_exec
        self.bdur = bdur                 # batch duration = max member exec
        self.slacks = slacks             # sorted wait thresholds (see below)


class IncrementalEvaluator:
    """Incremental ΔG evaluation for Algorithm 1's move set.

    The key observation: given a batch's size, every member contributes a
    *wait threshold* ("slack") — the largest batch wait under which it
    still meets its SLO:

      h = 1:  met  ⇔  wait ≤ slo_e2e − t_exec
      h = 0:  met  ⇔  wait ≤ slo_ttft − t_prefill   (and TPOT ok,
                                                     wait-independent)

    so ``n_met`` of a batch with wait w is a binary search over its sorted
    slacks, and Σe2e of a batch is ``sum_exec + size·w``.  A squeeze /
    delay / swap move perturbs one or two batches; downstream batches keep
    their member stats and only see a shifted wait.  Scoring a proposal is
    therefore O(touched-batch rebuild + n_batches·log b) instead of the
    O(N) full :func:`evaluate` — cheap enough to re-anneal at every
    admission event (paper Table 1).

    Relies on the latency model being *linear in batch size b* (true of
    ``LinearLatencyModel``, Eqs. 14–16): every per-request quantity is
    precomputed once as ``A·b + C``.

    ``evaluate`` remains the oracle; tests cross-check agreement to 1e-9.
    """

    def __init__(self, arrays: dict, model, batches: Sequence[Sequence[int]]):
        # exec_time(b) = eA·b + eC ; prefill(b) = pA·b + pC ; tpot(b) = tA·b+tC
        coefs = linear_request_coefs(arrays, model)
        self._eA = coefs["eA"].tolist()
        self._eC = coefs["eC"].tolist()
        self._pA = coefs["pA"].tolist()
        self._pC = coefs["pC"].tolist()
        self._tA = coefs["tA"].tolist()
        self._tC = coefs["tC"].tolist()
        self._h = [int(x) for x in arrays["h"]]
        self._se = [float(x) for x in arrays["slo_e2e"]]
        self._st = [float(x) for x in arrays["slo_ttft"]]
        self._sp = [float(x) for x in arrays["slo_tpot"]]
        self.batches: List[List[int]] = [list(b) for b in batches if len(b)]
        self.stats: List[_BatchStat] = [self._stat(b) for b in self.batches]
        self._recache()

    # ------------------------------------------------------------ internals
    def _stat(self, members: Sequence[int]) -> _BatchStat:
        b = float(len(members))
        eA, eC, h = self._eA, self._eC, self._h
        sum_exec = 0.0
        bdur = float("-inf")
        slacks = []
        for i in members:
            ex = eA[i] * b + eC[i]
            sum_exec += ex
            if ex > bdur:
                bdur = ex
            if h[i]:
                s = self._se[i] - ex
            elif self._tA[i] * b + self._tC[i] <= self._sp[i]:
                s = self._st[i] - (self._pA[i] * b + self._pC[i])
            else:
                s = float("-inf")
            slacks.append(s)
        slacks.sort()
        return _BatchStat(len(members), sum_exec, bdur, slacks)

    def _recache(self, k0: int = 0):
        """Prefix aggregates of the committed schedule: cum_met[j] /
        cum_total[j] over batches < j, and wait[j] of batch j.  Batches
        below ``k0`` are unchanged, so their prefixes are reused."""
        k0 = min(k0, len(self.stats))
        cm = self._cum_met[:k0 + 1] if k0 else [0]
        ct = self._cum_total[:k0 + 1] if k0 else [0.0]
        cw = self._cum_wait[:k0 + 1] if k0 else [0.0]
        n_met, total, w = cm[-1], ct[-1], cw[-1]
        # NOTE: this accumulation body must stay in sync with _aggregate
        # (kept as two tight loops on purpose — _aggregate is the anneal's
        # per-proposal hot path and the 1e-9 oracle-agreement tests pin
        # both against evaluate())
        for st in self.stats[k0:]:
            sz = st.size
            if sz == 1:                      # common at small max_batch
                n_met += st.slacks[0] >= w
                total += st.sum_exec + w
            else:
                n_met += sz - bisect_left(st.slacks, w)
                total += st.sum_exec + sz * w
            w += st.bdur
            cm.append(n_met)
            ct.append(total)
            cw.append(w)
        self._cum_met, self._cum_total, self._cum_wait = cm, ct, cw
        self.n_met = n_met
        self.total = total
        self.G = n_met / total if total > 0 else 0.0

    def _aggregate(self, stats: List[_BatchStat], k0: int
                   ) -> Tuple[float, int]:
        """Score a candidate whose batches < k0 are unchanged."""
        n_met = self._cum_met[k0]
        total = self._cum_total[k0]
        w = self._cum_wait[k0]
        # NOTE: keep in sync with _recache's accumulation body (see there)
        for st in stats[k0:]:
            sz = st.size
            if sz == 1:                      # common at small max_batch
                n_met += st.slacks[0] >= w
                total += st.sum_exec + w
            else:
                n_met += sz - bisect_left(st.slacks, w)
                total += st.sum_exec + sz * w
            w += st.bdur
        return (n_met / total if total > 0 else 0.0), n_met

    # ------------------------------------------------------------ moves
    def preview(self, move) -> Tuple[float, int, tuple]:
        """Score ``move`` (an annealing move descriptor) without mutating
        state.  Returns ``(G, n_met, staged)``; pass ``staged`` to
        :meth:`commit` to adopt the candidate.  Inner batch lists are
        never mutated in place, so committed ``batches`` may be aliased by
        callers safely."""
        batches = list(self.batches)
        stats = list(self.stats)
        op = move[0]
        if op == "squeeze":                    # batch k -> k-1
            k, j = move[1], move[2]
            src = batches[k]
            item = src[j]
            rem = src[:j] + src[j + 1:]
            dst = batches[k - 1] + [item]
            batches[k - 1] = dst
            stats[k - 1] = self._stat(dst)
            if rem:
                batches[k] = rem
                stats[k] = self._stat(rem)
            else:
                del batches[k]
                del stats[k]
            k0 = k - 1
        elif op == "delay":                    # batch k -> k+1 (maybe new)
            k, j = move[1], move[2]
            src = batches[k]
            item = src[j]
            rem = src[:j] + src[j + 1:]
            if k == len(batches) - 1:          # open a new final iteration
                if rem:
                    batches[k] = rem
                    stats[k] = self._stat(rem)
                    batches.append([item])
                    stats.append(self._stat([item]))
                else:
                    # delaying a singleton last batch is structurally a
                    # no-op; never keep an empty batch (bdur would be -inf)
                    batches[k] = [item]
                    stats[k] = self._stat([item])
            else:
                dst = [item] + batches[k + 1]
                batches[k + 1] = dst
                stats[k + 1] = self._stat(dst)
                if rem:
                    batches[k] = rem
                    stats[k] = self._stat(rem)
                else:
                    del batches[k]
                    del stats[k]
            k0 = k
        elif op == "swap":
            b1, i1, b2, i2 = move[1], move[2], move[3], move[4]
            if b1 == b2:                       # same batch: G is invariant
                nl = list(batches[b1])
                nl[i1], nl[i2] = nl[i2], nl[i1]
                batches[b1] = nl
                k0 = len(stats)                # reuse full committed prefix
            else:
                l1, l2 = list(batches[b1]), list(batches[b2])
                l1[i1], l2[i2] = l2[i2], l1[i1]
                batches[b1], batches[b2] = l1, l2
                stats[b1] = self._stat(l1)
                stats[b2] = self._stat(l2)
                k0 = min(b1, b2)
        else:
            raise ValueError(f"unknown move {move!r}")
        g, n_met = self._aggregate(stats, k0)
        return g, n_met, (batches, stats, k0)

    def commit(self, staged: tuple):
        self.batches, self.stats, k0 = staged
        self._recache(k0)
