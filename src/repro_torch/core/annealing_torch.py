"""Batched simulated-annealing priority mapper (Algorithm 1) on tensors.

Counterpart of the JAX package's ``repro/core/annealing_jax.py``: the
same schedule representation, the same two scoring paths and the same
helpers under the same names, with the ``vmap`` over tempering chains
(and, for Algorithm 2, over instances) written out as leading batch
dimensions.  The anneal itself (the reference's jitted
``_run_chains`` / ``_run_chains_multi``) is one launch of the
hand-written kernel ``kernels/csrc/anneal.cu`` on a CUDA tensor, or its
plain PyTorch version ``kernels/anneal.py::anneal_chains_plain`` on a
CPU tensor (``kernels.ops.anneal_chains`` picks by device).

Schedule representation (fixed N, with ``n_valid <= N`` real requests —
positions ``>= n_valid`` hold padding pinned as tail singletons that never
mix with real batches and are masked out of the objective):

  perm [..., N] int64  — request index per priority position
  bnd  [..., N] bool   — batch boundary *before* each position

Randomness is an input: the front ends draw every uniform a run can use
up front, ``draws [I, C, P, 4]`` from a ``torch.Generator`` seeded from
``seed`` (instance ``i`` of a multi-instance call from ``(seed, i)``),
and proposal ``k`` of a chain reads row ``k``.  ``_sample_move`` maps a
row onto ``(op, i, j, u_acc)`` in the draws' dtype exactly as the
reference maps its ``jax.random.uniform`` draw, so a caller that hands
in the reference's own stream follows its trajectory.

``reqc`` is packed in float64 and cast to the working dtype (float32 by
default, as JAX without x64); float64 is the CPU oracle path, the kernel
takes float32.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.objective import linear_request_coefs
from repro_torch.device import resolve_device

# Column layout of the per-request coefficient matrix ``reqc`` [N, 11]:
# linear-in-batch-size latency terms (objective.linear_request_coefs),
# the SLO class h, the three SLO budgets, and the padding mask.
_EA, _EC, _PA, _PC, _TA, _TC, _H, _SE, _ST, _SP, _VALID = range(11)
_NCOLS = 11


@dataclasses.dataclass(frozen=True)
class TorchSAConfig:
    """Anneal hyper-parameters, validated as the reference's
    ``JaxSAConfig``: an invalid value fails loudly instead of turning
    every proposal into a silent no-op."""
    T0: float = 500.0
    T_thres: float = 20.0
    iters: int = 100
    tau: float = 0.95
    num_chains: int = 8

    def __post_init__(self):
        if self.num_chains < 1:
            raise ValueError(
                f"num_chains must be >= 1, got {self.num_chains}")
        if self.iters < 1:
            raise ValueError(f"iters must be >= 1, got {self.iters}")
        if self.T0 <= 0 or self.T_thres <= 0:
            raise ValueError(
                f"temperatures must be positive, got T0={self.T0}, "
                f"T_thres={self.T_thres}")
        if self.T_thres > self.T0:
            raise ValueError(
                f"T_thres must be <= T0 (the anneal would run zero "
                f"proposals), got T0={self.T0}, T_thres={self.T_thres}")
        if not 0.0 < self.tau < 1.0:
            raise ValueError(f"tau must be in (0, 1), got {self.tau}")

    @property
    def n_levels(self) -> int:
        """Temperature levels under the schedule (>= 1 by validation)."""
        levels, T = 0, self.T0
        while T >= self.T_thres:
            levels += 1
            T *= self.tau
        return levels


def config_from_sa_params(params, num_chains: int = 8) -> TorchSAConfig:
    """Map a Python-annealer ``SAParams`` onto the batched annealer.

    The batched loop runs ``iters`` proposals per temperature level (the
    Python ``budget_mode="per_level"``); under the default
    ``budget_mode="global"`` ``iters`` is the TOTAL budget, so it is
    spread across the levels rather than inflated by their count.  The
    ``moves`` and ``acceptance`` ablation knobs have no batched
    counterpart and are rejected rather than silently dropped."""
    if tuple(params.moves) != (0, 1, 2) or params.acceptance != "metropolis":
        raise ValueError(
            "the batched annealer supports only moves=(0, 1, 2) with "
            f"acceptance='metropolis'; got moves={params.moves!r}, "
            f"acceptance={params.acceptance!r} — use the Python backend "
            "for ablation configs")
    cfg = TorchSAConfig(T0=params.T0, T_thres=params.T_thres, iters=1,
                        tau=params.tau, num_chains=num_chains)
    if params.budget_mode == "global":
        iters = max(1, -(-params.iters // cfg.n_levels))      # ceil div
    else:
        iters = params.iters
    return dataclasses.replace(cfg, iters=iters)


def temperature_levels(T0: float, T_thres: float, tau: float,
                       dtype=torch.float32) -> int:
    """Levels of the anneal loop's own temperature recursion: ``T *=
    tau`` in ``dtype`` from ``T0``, while ``T >= T_thres`` (the float64
    count of :attr:`TorchSAConfig.n_levels` may differ at the edge)."""
    npdt = np.float64 if dtype == torch.float64 else np.float32
    T, thres, tau = npdt(T0), npdt(T_thres), npdt(tau)
    levels = 0
    while T >= thres:
        levels += 1
        T = npdt(T * tau)
    return levels


def n_proposals(cfg: TorchSAConfig, dtype=torch.float32) -> int:
    """Proposals a chain can make: ``iters`` per level of
    :func:`temperature_levels`, the rows of ``draws`` a run needs."""
    return temperature_levels(cfg.T0, cfg.T_thres, cfg.tau, dtype) \
        * cfg.iters


# --------------------------------------------------------------- packing
def _pad_len(n: int) -> int:
    """Bucket N to the next power of two (>= 8), as the reference does."""
    return max(8, 1 << max(int(n) - 1, 0).bit_length())


def _pack(arrays_np: dict, model, pad_to: int, dtype=torch.float32,
          device="cpu") -> torch.Tensor:
    """The padded per-request coefficient matrix [pad_to, 11], built in
    float64 and cast to ``dtype``.  Padding rows are all-zero with
    VALID = 0: zero exec/prefill coefficients keep them out of batch
    durations and the latency sum, and the mask out of the met count."""
    n = len(arrays_np["input_len"])
    coefs = linear_request_coefs(arrays_np, model)
    cols = np.zeros((pad_to, _NCOLS), np.float64)
    for c, k in ((_EA, "eA"), (_EC, "eC"), (_PA, "pA"), (_PC, "pC"),
                 (_TA, "tA"), (_TC, "tC")):
        cols[:n, c] = coefs[k]
    cols[:n, _H] = np.asarray(arrays_np["h"], np.float64)
    cols[:n, _SE] = np.asarray(arrays_np["slo_e2e"], np.float64)
    cols[:n, _ST] = np.asarray(arrays_np["slo_ttft"], np.float64)
    cols[:n, _SP] = np.asarray(arrays_np["slo_tpot"], np.float64)
    cols[:n, _VALID] = 1.0
    return torch.from_numpy(cols).to(dtype=dtype, device=device)


# --------------------------------------------------------------- helpers
# Every helper takes tensors with one leading batch shape ``*B`` (empty
# for a single chain): reqc [*B, N, 11], perm / bnd [*B, N], scalars
# (op, i, j, n_valid, starts, sizes) [*B] or [*B, k].
def _rows_of(reqc, idx):
    """reqc rows at request indices ``idx`` [*B, *K] -> [*B, *K, 11]."""
    nb = reqc.dim() - 2
    flat = idx.reshape(*idx.shape[:nb], -1)
    r = torch.gather(reqc, -2, flat.unsqueeze(-1).expand(
        *flat.shape, _NCOLS))
    return r.reshape(*idx.shape, _NCOLS)


def _at(x, idx):
    """``x[..., idx]`` per batch element: x [*B, N], idx [*B, *K]."""
    nb = x.dim() - 1
    flat = idx.reshape(*idx.shape[:nb], -1)
    return torch.gather(x, -1, flat).reshape(idx.shape)


def _fma(a, b, c):
    """``a * b + c`` rounded once, as the reference's compiled program
    contracts it (and the kernel computes it)."""
    return torch.addcmul(c, a, b)


# The N-long sums and prefix sums accumulate in float64 and round once to
# the working dtype.  For float32 latencies that span less than ~16
# binary orders of magnitude every partial sum is exact in float64, so
# the result does not depend on the order of the additions: the kernel's
# block-wide trees and scans give these values bit for bit, and ties
# between schedules (a swap inside one batch leaves G equal) break alike
# on the card and here.  In float64 they run left to right (``cumsum``
# on the CPU), as the reference's compiled CPU program sums up to 32
# terms.
def _sum(x):
    """Sum over the last dim (see above)."""
    return torch.cumsum(x.to(torch.float64), -1)[..., -1].to(x.dtype)


def _wait_prefix(bdur):
    """Exclusive prefix sums of batch durations — batch waits (Eq. 11)."""
    acc = torch.cumsum(bdur.to(torch.float64), -1).to(bdur.dtype)
    return torch.cat([torch.zeros_like(bdur[..., :1]), acc[..., :-1]], -1)


def _eval_g(reqc, perm, bnd):
    """Full Eq. 2 objective over all N positions — the oracle the
    incremental path is checked against.  Returns ``(G, n_met)``;
    padding (VALID = 0) is excluded from both the met count and the
    latency denominator."""
    r = _rows_of(reqc, perm)
    dt = r.dtype
    batch_id = torch.cumsum(bnd.to(torch.int64), -1) - 1
    bsz = torch.zeros_like(r[..., 0]).scatter_add_(
        -1, batch_id, torch.ones_like(r[..., 0]))
    b_of = torch.gather(bsz, -1, batch_id)
    t_exec = _fma(r[..., _EA], b_of, r[..., _EC])
    t_pref = _fma(r[..., _PA], b_of, r[..., _PC])
    t_tpot = _fma(r[..., _TA], b_of, r[..., _TC])
    bdur = torch.full_like(t_exec, -torch.inf).scatter_reduce_(
        -1, batch_id, t_exec, "amax")
    bdur = torch.where(bsz > 0, bdur, torch.zeros((), dtype=dt,
                                                  device=bdur.device))
    t_wait = torch.gather(_wait_prefix(bdur), -1, batch_id)
    e2e = t_exec + t_wait
    ttft = t_pref + t_wait
    met = torch.where(r[..., _H] == 1, e2e <= r[..., _SE],
                      (ttft <= r[..., _ST]) & (t_tpot <= r[..., _SP]))
    valid = r[..., _VALID] > 0
    n_met = (met & valid).to(dt).sum(-1)
    total = _sum(torch.where(valid, e2e, torch.zeros_like(e2e)))
    return n_met / total.clamp_min(1e-12), n_met


# ``stats`` is a 5-tuple, row p describing the batch *starting at
# position p* (neutral everywhere else):
#   slacks [*B, N, mb] — member SLO slacks sorted ascending, +inf padding
#   bsz    [*B, N]     — structural batch size (incl. padding members)
#   cnt    [*B, N]     — valid-member count (met/latency accounting)
#   sume   [*B, N]     — sum of member exec times
#   bdur   [*B, N]     — batch duration (max member exec)
def _row(reqc, perm_pad, start, size, mb: int):
    """Segment aggregates for a batch of ``size`` members at positions
    ``start .. start+size-1`` (``start``/``size`` [*B, *K]).
    ``perm_pad`` is perm padded with mb sentinels so the fixed-size
    window never clamps.  A member's *slack* is the largest batch wait
    under which it still meets its SLO:

      h = 1:  slack = slo_e2e  - exec(size)
      h = 0:  slack = slo_ttft - prefill(size)   if TPOT ok at this size,
              else -inf (can never be met)

    Non-members and padding get +inf (sorted last, never counted met).
    ``size == 0`` yields the neutral row.  The member sum is taken left
    to right over the window, as the kernel takes it."""
    ar = torch.arange(mb, device=perm_pad.device)
    idx = _at(perm_pad, start.unsqueeze(-1) + ar)               # [*, mb]
    r = _rows_of(reqc, idx)                                     # [*, mb, 11]
    dt = r.dtype
    memb = ar < size.unsqueeze(-1)
    b = size.to(dt)
    bb = b.unsqueeze(-1)
    zero = torch.zeros((), dtype=dt, device=r.device)
    inf = torch.full((), torch.inf, dtype=dt, device=r.device)
    ex = torch.where(memb, _fma(r[..., _EA], bb, r[..., _EC]), zero)
    sum_exec = ex[..., 0]
    for k in range(1, mb):
        sum_exec = sum_exec + ex[..., k]
    bdur = torch.where(size > 0, torch.where(memb, ex, -inf).amax(-1), zero)
    pref = _fma(r[..., _PA], bb, r[..., _PC])
    tpot_ok = _fma(r[..., _TA], bb, r[..., _TC]) <= r[..., _SP]
    slack = torch.where(r[..., _H] == 1, r[..., _SE] - ex,
                        torch.where(tpot_ok, r[..., _ST] - pref, -inf))
    live = memb & (r[..., _VALID] > 0)
    slack = torch.where(live, slack, inf)
    cnt = live.to(dt).sum(-1)
    return torch.sort(slack, -1).values, b, cnt, sum_exec, bdur


def _pad_perm(perm, mb: int):
    return torch.cat([perm, torch.zeros_like(perm[..., :1]).expand(
        *perm.shape[:-1], mb)], -1)


def _build_stats(reqc, perm, bnd, mb: int):
    """O(N·mb) stats build for a whole schedule (used once per start;
    the anneal hot loop only rebuilds touched rows)."""
    n = perm.shape[-1]
    pos = torch.arange(n, device=perm.device).expand(perm.shape)
    batch_id = torch.cumsum(bnd.to(torch.int64), -1) - 1
    counts = torch.zeros_like(batch_id).scatter_add_(
        -1, batch_id, torch.ones_like(batch_id))
    sizes = torch.gather(counts, -1, batch_id)
    slacks, bsz, cnt, sume, bdur = _row(reqc, _pad_perm(perm, mb), pos,
                                        sizes, mb)
    z = torch.zeros((), dtype=reqc.dtype, device=reqc.device)
    return (torch.where(bnd.unsqueeze(-1), slacks, torch.inf),
            torch.where(bnd, bsz, z), torch.where(bnd, cnt, z),
            torch.where(bnd, sume, z), torch.where(bnd, bdur, z))


def _count_below(slack_rows, w):
    """Per-row count of slacks strictly below the row's wait — the rank
    of ``w`` in the sorted slack row."""
    return (slack_rows < w.unsqueeze(-1)).sum(-1)


def _agg(stats, mb: int):
    """Score a schedule from its batch-stat rows alone."""
    slacks, bsz, cnt, sume, bdur = stats
    w = _wait_prefix(bdur)
    below = _count_below(slacks, w)
    n_met = (cnt - below.to(cnt.dtype)).sum(-1)
    total = _sum(sume) + _sum(cnt * w)
    return n_met / total.clamp_min(1e-12), n_met


def _agg_delta(stats, sidx, rows, mb: int):
    """Score a candidate whose only changes vs the committed ``stats``
    are the 3 rebuilt rows ``rows`` at ``sidx`` [*B, 3] — without
    materializing the candidate.  Duplicate indices carry identical
    rows, so scatter order is immaterial."""
    slacks, bsz, cnt, sume, bdur = stats
    r_sl, r_b, r_cnt, r_se, r_bd = rows
    bdur_c = bdur.scatter(-1, sidx, r_bd)
    cnt_c = cnt.scatter(-1, sidx, r_cnt)
    sume_c = sume.scatter(-1, sidx, r_se)
    w = _wait_prefix(bdur_c)
    below = _count_below(slacks, w).scatter(
        -1, sidx, _count_below(r_sl, _at(w, sidx)))
    n_met = (cnt_c - below.to(cnt_c.dtype)).sum(-1)
    total = _sum(sume_c) + _sum(cnt_c * w)
    return n_met / total.clamp_min(1e-12), n_met


# ----------------------------------------------------------------- moves
def _sample_move(u, n_valid):
    """One (op, i, j) proposal plus the acceptance uniform from a draw
    row ``u [*B, 4]``, in ``u``'s dtype as the reference maps its
    ``jax.random.uniform`` draw."""
    dt = u.dtype
    nv = n_valid.to(torch.int64)
    op = torch.clamp_max((u[..., 0] * 3).to(torch.int64), 2)
    hi = torch.clamp_min(nv, 2)
    i = torch.minimum(1 + (u[..., 1] * (hi - 1).to(dt)).to(torch.int64),
                      hi - 1)
    lo_n = torch.clamp_min(nv, 1)
    j = torch.minimum((u[..., 2] * lo_n.to(dt)).to(torch.int64), lo_n - 1)
    return op, i, j, u[..., 3]


def _start_of(bnd, i):
    """Start position of the batch containing position ``i`` [*B]
    (bnd[0] is invariantly True, so the result is always >= 0)."""
    pos = torch.arange(bnd.shape[-1], device=bnd.device)
    return torch.where(bnd & (pos <= i.unsqueeze(-1)), pos, -1).amax(-1)


def _pick(cond, a, b):
    return torch.where(cond.unsqueeze(-1), a, b)


def _move_descriptors(perm, bnd, op, i, j, n_valid, mb: int):
    """Branch-free squeeze/delay/swap descriptor arithmetic shared by
    BOTH scoring paths: the validity flag, the <= 2 perm entries a swap
    touches, and the <= 2 boundary bits a squeeze/delay touches (no-op
    writes of position 0 / the invariant bnd[0]=True otherwise).
    Returns ``(ok, a_im1, i2, pidx, pval, bidx, bval)``."""
    n = perm.shape[-1]
    is_sq = op == 0
    is_dl = op == 1
    is_sw = op == 2
    a_im1 = _start_of(bnd, i - 1)          # start of batch holding i-1
    i2 = torch.clamp_max(i + 1, n - 1)
    bnd_i = _at(bnd, i)
    ok = (i < n_valid) & torch.where(
        is_sq, bnd_i & (i - a_im1 < mb),
        torch.where(is_dl, ~bnd_i, j < n_valid))
    z = torch.zeros_like(i)
    pi, pj, p0 = _at(perm, i), _at(perm, j), perm[..., 0]
    pidx = _pick(is_sw, torch.stack([i, j], -1), torch.stack([z, z], -1))
    pval = _pick(is_sw, torch.stack([pj, pi], -1),
                 torch.stack([p0, p0], -1))
    t_ = torch.ones_like(bnd_i)
    bidx = _pick(is_sq, torch.stack([i, i2], -1),
                 _pick(is_dl, torch.stack([i, i], -1),
                       torch.stack([z, z], -1)))
    bval = _pick(is_sq, torch.stack([~t_, i + 1 < n], -1),
                 torch.stack([t_, t_], -1))
    return ok, a_im1, i2, pidx, pval, bidx, bval


def _candidate(reqc, perm, bnd, stats, op, i, j, n_valid, mb: int):
    """Move ``(op, i, j)`` as a branch-free sparse update: rebuild <= 3
    batch rows + <= 2 boundary bits + <= 2 perm entries.  Returns
    ``(ok, perm_c, upd)`` with ``upd = (pidx, pval, bidx, bval, sidx,
    rows)``; ``ok=False`` candidates carry garbage rows and must not be
    committed."""
    _, bsz, _, _, _ = stats
    is_sq = op == 0
    is_dl = op == 1
    ok, a_im1, i2, pidx, pval, bidx, bval = _move_descriptors(
        perm, bnd, op, i, j, n_valid, mb)
    a_i = torch.where(_at(bnd, i), i, a_im1)   # start of batch holding i
    a_j = _start_of(bnd, j)
    size = lambda p: _at(bsz, p).to(torch.int64)   # noqa: E731
    s_prev, s_cur, s_old, s_j = size(a_im1), size(i), size(a_i), size(a_j)
    left = i - a_i
    # squeeze: the batch starting at i loses its first member to the
    # previous batch; survivors re-start at i+1 (a no-op rebuild when i
    # was a singleton followed by another batch, the neutral row when i
    # was the last position)
    sq3 = torch.where(s_cur > 1, s_cur - 1,
                      torch.where(i2 == i, torch.zeros_like(i), size(i2)))
    starts = _pick(is_sq, torch.stack([a_im1, i, i2], -1),
                   _pick(is_dl, torch.stack([a_i, i, i], -1),
                         torch.stack([a_i, a_j, a_j], -1)))
    sizes = _pick(is_sq, torch.stack([s_prev + 1, torch.zeros_like(i),
                                      sq3], -1),
                  _pick(is_dl, torch.stack([left, s_old - left,
                                            s_old - left], -1),
                        torch.stack([s_old, s_j, s_j], -1)))
    perm_c = perm.scatter(-1, pidx, pval)
    nb = reqc.dim() - 2
    rows = _row(reqc.unsqueeze(nb).expand(*reqc.shape[:nb], 3,
                                          *reqc.shape[nb:]),
                _pad_perm(perm_c, mb).unsqueeze(-2).expand(
                    *perm_c.shape[:-1], 3, perm_c.shape[-1] + mb),
                starts, sizes, mb)
    return ok, perm_c, (pidx, pval, bidx, bval, starts, rows)


def _apply(perm, bnd, stats, upd, accept):
    """Commit (``accept=True``) or discard a candidate's sparse updates —
    scatters only.  Duplicate indices in an update always carry
    identical values, so scatter order is immaterial."""
    pidx, pval, bidx, bval, sidx, rows = upd
    slacks, bsz, cnt, sume, bdur = stats
    r_sl, r_b, r_cnt, r_se, r_bd = rows
    acc = accept.unsqueeze(-1)

    def put(x, idx, new):
        return x.scatter(-1, idx, torch.where(acc, new, _at(x, idx)))

    mb = slacks.shape[-1]
    sidx_sl = sidx.unsqueeze(-1).expand(*sidx.shape, mb)
    cur_sl = torch.gather(slacks, -2, sidx_sl)
    slacks = slacks.scatter(-2, sidx_sl,
                            torch.where(acc.unsqueeze(-1), r_sl, cur_sl))
    return (put(perm, pidx, pval), put(bnd, bidx, bval),
            (slacks, put(bsz, sidx, r_b), put(cnt, sidx, r_cnt),
             put(sume, sidx, r_se), put(bdur, sidx, r_bd)))


def _structural(perm, bnd, op, i, j, n_valid, mb: int):
    """Move application for the full-evaluate path (no stats carried):
    the same :func:`_move_descriptors` arithmetic, applied densely."""
    ok, _, _, pidx, pval, bidx, bval = _move_descriptors(
        perm, bnd, op, i, j, n_valid, mb)
    return ok, perm.scatter(-1, pidx, pval), bnd.scatter(-1, bidx, bval)


# ----------------------------------------------------------------- chains
def _starts(reqc, n_valid, mb: int):
    """The two Algorithm 1 starting solutions under padding: predicted-e2e
    order and arrival order, maximal batches over the real prefix, padding
    pinned as tail singletons."""
    n = reqc.shape[-2]
    pos = torch.arange(n, device=reqc.device)
    t0 = _fma(reqc[..., _EA], torch.full((), mb, dtype=reqc.dtype,
                                         device=reqc.device), reqc[..., _EC])
    t0 = torch.where(reqc[..., _VALID] > 0, t0, torch.inf)
    perm_s = torch.argsort(t0, dim=-1, stable=True)
    perm_a = pos.expand(perm_s.shape)
    bnd0 = ((pos % mb) == 0) | (pos >= n_valid.unsqueeze(-1))
    return perm_s, perm_a, bnd0


def _run_chains(draws, reqc, n_valid: int, max_batch: int,
                cfg: TorchSAConfig, incremental: bool):
    """``C`` chains over one padded instance: ``draws [C, P, 4]``, ``reqc
    [N, 11]``.  -> (perm [C, N], bnd [C, N], G [C])."""
    perms, bnds, fs = _run_chains_multi(
        draws[None], reqc[None],
        torch.tensor([n_valid], dtype=torch.int32, device=reqc.device),
        max_batch, cfg, incremental)
    return perms[0], bnds[0], fs[0]


def _run_chains_multi(draws, reqcs, n_valids, max_batch: int,
                      cfg: TorchSAConfig, incremental: bool):
    """instances × chains in one call (one kernel launch on the card):
    ``draws [I, C, P, 4]``, ``reqcs [I, N, 11]``, ``n_valids [I]``."""
    from repro_torch.kernels import ops
    return ops.anneal_chains(reqcs, n_valids, draws, max_batch, cfg.T0,
                             cfg.T_thres, cfg.tau, cfg.iters, incremental)


# -------------------------------------------------------------- frontends
def _validate(max_batch: int, cfg: TorchSAConfig):
    if max_batch < 1:
        raise ValueError(f"max_batch must be >= 1, got {max_batch}")
    if not isinstance(cfg, TorchSAConfig):
        raise TypeError(f"cfg must be a TorchSAConfig, got {type(cfg)}")


def instance_seed(seed: int, i: int) -> int:
    """The generator seed of instance ``i`` of a multi-instance call, the
    counterpart of ``fold_in(PRNGKey(seed), i)``."""
    return int(np.random.SeedSequence((seed, i)).generate_state(1)[0])


def make_draws(seeds: Sequence[int], cfg: TorchSAConfig,
               dtype=torch.float32) -> torch.Tensor:
    """Every uniform the anneal can use, [len(seeds), C, P, 4], drawn on
    the CPU from one ``torch.Generator`` per instance (so a run on the
    card and one on the CPU consume the same numbers)."""
    p = n_proposals(cfg, dtype)
    out = torch.empty((len(seeds), cfg.num_chains, p, 4), dtype=dtype)
    for k, s in enumerate(seeds):
        gen = torch.Generator().manual_seed(int(s))
        out[k] = torch.rand((cfg.num_chains, p, 4), generator=gen,
                            dtype=dtype)
    return out


def _extract(perm_pad, bnd_pad, n: int):
    perm = np.asarray(perm_pad)[:n]
    bnd = np.asarray(bnd_pad)[:n]
    batch_id = np.cumsum(bnd.astype(np.int64)) - 1
    return perm.astype(np.int64), batch_id


def priority_mapping_torch(arrays_np: dict, model, max_batch: int,
                           cfg: Optional[TorchSAConfig] = None,
                           seed: int = 0, incremental: bool = True,
                           device=None):
    """Parallel-tempering front end: ``cfg.num_chains`` chains in one
    launch.  Returns ``(perm, batch_id, G)`` for the best chain.

    ``incremental=True`` (default) scores proposals with the
    incremental-Δ evaluator; ``incremental=False`` re-evaluates the full
    objective per proposal (the oracle path).  ``device=None`` means
    ``cuda``; without a card pass ``device="cpu"``."""
    cfg = TorchSAConfig() if cfg is None else cfg
    _validate(max_batch, cfg)
    n = len(arrays_np["input_len"])
    if n == 0:
        return (np.zeros(0, np.int64), np.zeros(0, np.int64), 0.0)
    dev = resolve_device(device)
    reqc = _pack(arrays_np, model, _pad_len(n), device=dev)
    draws = make_draws([seed], cfg)[0].to(dev)
    perms, bnds, fs = _run_chains(draws, reqc, n, max_batch, cfg,
                                  incremental)
    perms, bnds, fs = perms.cpu(), bnds.cpu(), fs.cpu()
    best = int(torch.argmax(fs))
    perm, batch_id = _extract(perms[best], bnds[best], n)
    return perm, batch_id, float(fs[best])


def priority_mapping_multi_torch(arrays_list: Sequence[dict], model,
                                 max_batch: int,
                                 cfg: Optional[TorchSAConfig] = None,
                                 seed: int = 0, incremental: bool = True,
                                 device=None
                                 ) -> List[Tuple[np.ndarray, np.ndarray,
                                                 float]]:
    """Algorithm 2's per-instance priority mapping in ONE launch:
    instances × chains, ragged instance loads padded to a common
    power-of-two length and masked out of the objective.  Returns a
    ``(perm, batch_id, G)`` triple per instance, trimmed back to its real
    length.  Instance ``i`` draws from a generator seeded with
    :func:`instance_seed` ``(seed, i)``."""
    cfg = TorchSAConfig() if cfg is None else cfg
    _validate(max_batch, cfg)
    sizes = [len(a["input_len"]) for a in arrays_list]
    if not sizes:
        return []
    dev = resolve_device(device)
    pad = _pad_len(max(max(sizes), 1))
    reqcs = torch.stack([_pack(a, model, pad, device=dev)
                         for a in arrays_list])
    n_valids = torch.tensor(sizes, dtype=torch.int32, device=dev)
    draws = make_draws([instance_seed(seed, i) for i in range(len(sizes))],
                       cfg).to(dev)
    perms, bnds, fs = _run_chains_multi(draws, reqcs, n_valids, max_batch,
                                        cfg, incremental)
    perms, bnds, fs = perms.cpu(), bnds.cpu(), fs.cpu()
    out = []
    for i, n in enumerate(sizes):
        if n == 0:
            out.append((np.zeros(0, np.int64), np.zeros(0, np.int64), 0.0))
            continue
        best = int(torch.argmax(fs[i]))
        perm, batch_id = _extract(perms[i, best], bnds[i, best], n)
        out.append((perm, batch_id, float(fs[i, best])))
    return out
