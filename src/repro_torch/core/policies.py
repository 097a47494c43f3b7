"""Scheduling API v2 — composable policies and execution disciplines.

The v1 API (``AdmissionPolicy.select(pending, now, free, active_count)``)
could only *pick from the pending queue*: policies saw nothing about the
requests already running, could not evict them, and the execution mode
(whether prefill stalls running decodes or interleaves with them) was
hard-wired into each executor.  Multi-SLO serving needs all three knobs
(SLOs-Serve, arXiv 2504.08784; Sarathi-style chunking), so v2 splits the
contract into two composable abstractions shared verbatim by the
discrete-event core (:func:`repro_torch.core.events.simulate`) and the real
serving engine (``repro_torch.engine.engine.Engine.run_policy``):

``SchedulingPolicy``
    receives a :class:`SchedulerView` — the pending queue, the *active*
    set (with generated/remaining token counts and predicted slack under
    the latency model), the instance id, clock, and free slots — and
    returns a :class:`Decision` with ``admit`` indices into the pending
    queue and ``preempt`` indices into the active set.  Preempted
    requests return to pending with their KV cache discarded; on
    re-admission the context (prompt + tokens generated so far) is
    re-prefilled, and both executors charge that recompute honestly.

``ExecutionDiscipline``
    governs how admitted prefills interleave with running decode rounds:
    :class:`StallingPrefill` (whole-prompt prefill, running decodes
    stall) vs :class:`ChunkedPrefill` (the prompt is processed in
    ``chunk_size`` chunks, one chunk per tick — Sarathi-style).  Each
    scheduling tick the discipline emits a :class:`StepPlan` — a mixed
    batch of :class:`PlanItem` work units (``prefill-chunk(slot,
    span)`` / ``full-prefill(slot)`` / ``decode(slot)``) — through
    :meth:`ExecutionDiscipline.plan_step`, and every executor (the
    event core, ``Engine.run_policy``, the streaming ``ServeLoop``)
    runs exactly one plan per tick, so a prefill chunk rides in the
    same tick as the running decodes instead of stalling them.

Policies and disciplines are constructible by string key through the
registry (:func:`make`), e.g. ``make("slo-preempt", model=m)``,
``make("chunked:64")``, or ``make("slo-reanneal:jax", model=m,
max_batch=8)`` (online re-annealing on the jitted annealer backend), so
launchers and benchmarks can select them from the command line.

The v1 ``AdmissionPolicy`` name survives for one release as a thin
deprecation shim: subclasses implementing ``select`` are adapted into
``decide`` automatically (admit-only, no preemption).
"""
from __future__ import annotations

import dataclasses
import functools
import math
import warnings
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

from repro_torch.core.annealing import SAParams, priority_mapping
from repro_torch.core.latency_model import LinearLatencyModel
from repro_torch.core.slo import Request, as_arrays

# ----------------------------------------------------------------- views
@dataclasses.dataclass(frozen=True)
class ActiveView:
    """One running request as a scheduling policy sees it."""
    request: Request
    generated: int          # tokens generated so far
    remaining: int          # tokens still to generate
    context_len: int        # l_i + generated (current KV length)
    ttft: Optional[float]   # absolute clock of the first token (None: n/a)
    now: float              # clock the view was built at
    e2e_base: float         # clock origin of the request's e2e budget
    batch: int              # batch size used for the slack projection
    model: Optional[LinearLatencyModel]
    # KV blocks ONLY this request holds in the paged pool — pages shared
    # with other requests or pinned by the prefix index are excluded,
    # because evicting this request would not free them (0: unpaged)
    blocks_held: int = 0

    @functools.cached_property
    def slack(self) -> float:
        """Predicted deadline slack (s); +inf if no applicable SLO.
        Computed lazily — non-preemptive policies never pay for it."""
        return compute_slack(self.request, generated=self.generated,
                             remaining=self.remaining,
                             context_len=self.context_len, now=self.now,
                             ttft=self.ttft, e2e_base=self.e2e_base,
                             batch=self.batch, model=self.model)


@dataclasses.dataclass(frozen=True)
class SchedulerView:
    """Everything a :class:`SchedulingPolicy` may look at for one decision."""
    pending: Tuple[Request, ...]
    active: Tuple[ActiveView, ...]
    now: float              # the deciding instance's clock
    free: int               # free slots before any preemption
    max_batch: int
    instance_id: int = 0
    # tokens already generated per pending entry (non-zero only for
    # re-queued preempted requests, whose re-prefill covers them too)
    pending_generated: Tuple[int, ...] = ()
    # the ExecutionDiscipline the executor will run admissions under —
    # lets policies price prefill honestly (chunked prefill interleaves
    # decode rounds, so it lands later than a stalling prefill would)
    discipline: Optional["ExecutionDiscipline"] = None
    # block-pool occupancy (paged-KV executors only; None/0 elsewhere):
    # policies that see these can make admission/eviction memory-aware
    free_blocks: Optional[int] = None
    total_blocks: Optional[int] = None
    block_size: int = 0
    # pages covering one slot's ring — a request can never hold more
    # (windowed slots wrap), so block-need estimates are capped by it
    pages_per_slot: int = 0
    # cached-prefix tokens per pending entry (shared-prefix KV reuse):
    # the executor's prefix index already holds that span's pages, so
    # admission prices only the unique new tokens/blocks.  Empty when
    # the executor has no prefix cache; falls back to
    # ``Request.cached_prefix`` (workload/simulator metadata).
    pending_cached: Tuple[int, ...] = ()

    def pending_context_len(self, i: int) -> int:
        """Context length if ``pending[i]`` were admitted now (prompt +
        carried generated tokens; decode attends all of it)."""
        gen = self.pending_generated[i] \
            if i < len(self.pending_generated) else 0
        return self.pending[i].input_len + gen

    def pending_cached_len(self, i: int) -> int:
        """Cached-prefix tokens of ``pending[i]`` — KV the executor can
        alias, skipping that span of prefill.  Clipped below the context
        length so at least one token is always priced as computed."""
        if i < len(self.pending_cached):
            cp = self.pending_cached[i]
        else:
            cp = int(getattr(self.pending[i], "cached_prefix", 0) or 0)
        return min(max(cp, 0), self.pending_context_len(i) - 1)

    def pending_prefill_len(self, i: int) -> int:
        """Tokens the prefill of ``pending[i]`` would actually compute:
        context minus the cached prefix."""
        return self.pending_context_len(i) - self.pending_cached_len(i)

    def blocks_for(self, tokens: int) -> int:
        """KV blocks covering ``tokens`` (0 on unpaged executors),
        capped at one slot's ring — matching the executor's own
        reservation (``Engine._blocks_needed``)."""
        if self.block_size <= 0:
            return 0
        n = -(-int(tokens) // self.block_size)
        return min(n, self.pages_per_slot) if self.pages_per_slot else n

    def pending_blocks(self, i: int) -> int:
        """*Unique new* blocks ``pending[i]`` needs if admitted now: its
        prefill context plus its (predicted) output budget, minus the
        blocks its cached prefix already aliases — shared pages cost the
        pool nothing, so memory admission must not charge for them."""
        r = self.pending[i]
        try:
            out = int(r.planning_output_len())
        except (AttributeError, ValueError):
            out = 0
        gen = self.pending_generated[i] \
            if i < len(self.pending_generated) else 0
        need = self.blocks_for(r.input_len + max(out, gen + 1))
        if self.block_size > 0:
            need -= self.pending_cached_len(i) // self.block_size
        return max(need, 0)


@dataclasses.dataclass
class Decision:
    """``admit``: indices into ``view.pending`` in admission order (the
    executor truncates to the slots available after preemption).
    ``preempt``: indices into ``view.active`` to evict first (KV
    discarded; the request returns to pending and is re-prefilled)."""
    admit: List[int] = dataclasses.field(default_factory=list)
    preempt: List[int] = dataclasses.field(default_factory=list)


# ------------------------------------------------------------ step plans
@dataclasses.dataclass(frozen=True)
class PlanItem:
    """One unit of work inside a :class:`StepPlan`.

    ``kind`` is ``"prefill"`` (compute ``length`` context tokens of
    ``ref``'s staged prefill, starting at position ``start``) or
    ``"decode"`` (one decode token for ``ref``).  ``ref`` is whatever
    the executor uses to name in-flight work — a slot id for the
    engine/serving loop, an index into the prefilling list for the
    event core.  ``last`` marks the chunk that completes a prefill:
    the request activates this tick and joins the same tick's decode
    round (its first token samples from this chunk's logits)."""
    kind: str
    ref: int
    start: int = 0
    length: int = 0
    last: bool = False


@dataclasses.dataclass(frozen=True)
class StepPlan:
    """One tick's mixed batch of work items, as emitted by
    :meth:`ExecutionDiscipline.plan_step`.  Executors run the prefill
    items first (each is one timed jit call / one priced model term),
    then a single decode round over every running request — including
    any whose ``last`` chunk just completed."""
    items: Tuple[PlanItem, ...] = ()

    @property
    def prefills(self) -> Tuple[PlanItem, ...]:
        return tuple(it for it in self.items if it.kind == "prefill")

    @property
    def decodes(self) -> Tuple[PlanItem, ...]:
        return tuple(it for it in self.items if it.kind == "decode")

    @property
    def prefill_tokens(self) -> int:
        return sum(it.length for it in self.items if it.kind == "prefill")

    @property
    def mixed(self) -> bool:
        """True when prefill work and running decodes share this tick —
        the stall-free batch shape chunked disciplines exist for."""
        return bool(self.prefills) and bool(self.decodes)

    def __bool__(self):
        return bool(self.items)


def compute_slack(request: Request, *, generated: int, remaining: int,
                  context_len: int, now: float, ttft: Optional[float],
                  e2e_base: float, batch: int,
                  model: Optional[LinearLatencyModel]) -> float:
    """Predicted deadline slack of a *running* request.

    Slack = earliest applicable deadline − predicted finish time, where
    the finish time is ``now`` plus the modelled decode time of the
    remaining tokens at the current batch size.  A TTFT-only request that
    already emitted its first token has infinite slack (it cannot miss
    anymore); without a latency model the remaining work is treated as
    free (slack degrades to remaining budget).
    """
    if model is None or remaining <= 0:
        finish = now
    else:
        finish = now + model.decode_time(max(batch, 1), context_len,
                                         remaining)
    deadlines = []
    if request.slo.e2e is not None:
        deadlines.append(e2e_base + request.slo.e2e)
    if request.slo.tpot is not None and ttft is not None:
        total = max(generated + remaining, 1)
        deadlines.append(ttft + request.slo.tpot * total)
    if not deadlines:
        return math.inf
    return min(deadlines) - finish


def make_active_view(request: Request, generated: int, remaining: int,
                     context_len: int, now: float, ttft: Optional[float],
                     e2e_base: float, batch: int,
                     model: Optional[LinearLatencyModel],
                     blocks_held: int = 0) -> ActiveView:
    """Build one :class:`ActiveView` — shared by the event core and the
    engine so both expose identical state to policies."""
    return ActiveView(request=request, generated=generated,
                      remaining=remaining, context_len=context_len,
                      ttft=ttft, now=now, e2e_base=e2e_base, batch=batch,
                      model=model, blocks_held=blocks_held)


def submit_base(r: Request) -> float:
    """The clock origin for a request's waited time / SLO budgets.

    ``submit_time`` is stamped by whichever executor runs the request (on
    *its* clock); ``arrival_time`` is the workload-relative fallback.
    Mixing the two was the v1 clock-mismatch bug: a warm engine clock
    minus a workload-relative arrival looked like hours of waiting.
    """
    return r.submit_time if r.submit_time is not None else r.arrival_time


def with_remaining_slo(r: Request, now: float) -> Request:
    """Shift e2e/TTFT budgets by the time already waited (one clock)."""
    waited = max(0.0, now - submit_base(r))
    slo = r.slo
    new = dataclasses.replace(
        slo,
        e2e=(slo.e2e - waited) if slo.e2e is not None else None,
        ttft=(slo.ttft - waited) if slo.ttft is not None else None)
    return dataclasses.replace(r, slo=new)


# ------------------------------------------------- pending-request pricing
def discipline_prefill_cost(view: SchedulerView,
                            model: LinearLatencyModel, ctx: int,
                            cached: int = 0) -> float:
    """Time from admission to first token for a ``ctx``-token prefill
    under the view's discipline: whole-prompt prefill, or — chunked —
    the chunk sum plus the decode rounds for the running batch between
    chunks.  ``cached`` tokens (an aliased prefix) are skipped entirely.
    Shared by every pricing policy so they all charge admission the way
    the executor will actually run it."""
    ctx = ctx - min(max(cached, 0), ctx - 1)
    C = getattr(view.discipline, "chunk_size", 0)
    if C <= 0:
        return model.prefill_time(1, ctx)
    chunks = [min(C, ctx - i) for i in range(0, ctx, C)]
    cost = sum(model.prefill_time(1, c) for c in chunks)
    if view.active and len(chunks) > 1:
        b = len(view.active)
        cost += (len(chunks) - 1) * max(
            model.per_token_decode_time(b, v.context_len)
            for v in view.active)
    return cost


def pending_budget(view: SchedulerView, i: int) -> float:
    """Remaining time until ``pending[i]``'s tightest *live* deadline
    (+inf with no applicable SLO).  A re-queued preempted request
    already emitted its first token, so its TTFT constraint is settled
    — only its e2e deadline stays live."""
    r = view.pending[i]
    waited = max(0.0, view.now - submit_base(r))
    cands = []
    if r.slo.ttft is not None and view.pending_context_len(i) == \
            r.input_len:
        cands.append(r.slo.ttft - waited)
    if r.slo.e2e is not None:
        cands.append(r.slo.e2e - waited)
    return min(cands) if cands else math.inf


def pending_service(view: SchedulerView, i: int,
                    model: LinearLatencyModel) -> float:
    """Modelled solo service time of ``pending[i]`` if admitted now:
    prefill under the view's discipline (cached prefix skipped) plus the
    decode of its remaining output tokens.  Requests without an output
    estimate price decode as free (prefill-only)."""
    r = view.pending[i]
    ctx = view.pending_context_len(i)
    prefill = discipline_prefill_cost(view, model, ctx,
                                      view.pending_cached_len(i))
    try:
        gen = ctx - r.input_len
        # prefill emits one token; the rest are decode rounds
        rem = max(int(r.planning_output_len()) - gen - 1, 0)
        decode = model.decode_time(1, ctx, rem)
    except ValueError:                       # no output-length estimate
        decode = 0.0
    return prefill + decode


# -------------------------------------------------------------- policies
class SchedulingPolicy:
    """v2 contract: ``decide(view) -> Decision``.

    ``preemptive`` tells executors whether to consult the policy even
    when no slot is free (preemption is the only useful decision then).
    ``reset()`` is called by both executors at the start of every run so
    stateful policies (e.g. :class:`PlannedPolicy`) are reusable.
    """

    preemptive = False

    def decide(self, view: SchedulerView) -> Decision:
        raise NotImplementedError

    def reset(self) -> None:
        pass


class FCFSPolicy(SchedulingPolicy):
    """vLLM-like continuous batching: admit in arrival (list) order.

    Also serves the planned-*priority* path: the scheduler's priority
    order is applied upstream by flattening the planned batches."""

    def decide(self, view):
        return Decision(admit=list(range(min(view.free, len(view.pending)))))


class PlannedPolicy(SchedulingPolicy):
    """Execute planned batches sequentially with a barrier (the paper's
    dispatch discipline): the next batch is admitted only once the
    instance drained completely.  ``reset()`` rewinds the batch cursor,
    so one policy object can drive several runs."""

    def __init__(self, batches: Sequence[Sequence]):
        self._batches = [[getattr(r, "req_id", r) for r in b]
                         for b in batches if len(b)]
        self._next = 0

    def reset(self):
        self._next = 0

    def decide(self, view):
        if len(view.active) > 0 or self._next >= len(self._batches):
            return Decision()
        batch = self._batches[self._next]
        pos = {r.req_id: i for i, r in enumerate(view.pending)}
        if any(rid not in pos for rid in batch):
            return Decision()               # members not yet arrived
        if len(batch) > view.free:
            raise RuntimeError("slot pool smaller than planned batch")
        self._next += 1
        return Decision(admit=[pos[rid] for rid in batch])


class SLOReannealPolicy(SchedulingPolicy):
    """Re-anneal the waiting queue with Algorithm 1 at every admission
    event, with SLO budgets shrunk by the time each request already
    waited (on the executor's clock, via ``submit_time``).  The
    incremental-Δ annealer keeps this cheap enough to run on the
    admission hot path (paper Table 1).

    ``backend`` picks the annealer: ``"python"`` (default — the
    ``objective.IncrementalEvaluator`` hot loop) or ``"jax"`` (the jitted
    incremental annealer, ``annealing_torch.priority_mapping_torch`` — queue
    depths are bucketed to powers of two so shifting queues reuse a few
    compilations; see docs/annealer.md for when each backend wins)."""

    def __init__(self, model: LinearLatencyModel, max_batch: int,
                 sa_params: Optional[SAParams] = None, min_queue: int = 2,
                 backend: str = "python", device=None):
        if backend not in ("python", "jax"):
            raise ValueError(
                f"backend must be 'python' or 'jax', got {backend!r}")
        self.model = model
        self.max_batch = max_batch
        self.sa_params = sa_params if sa_params is not None \
            else SAParams(seed=0)
        self.min_queue = min_queue
        self.backend = backend
        self.device = device
        self._jax_cfg = None
        if backend == "jax":
            # validate the SAParams mapping up front — a jit-unsupported
            # ablation config should fail at construction, not mid-run
            # on the first admission event that reaches min_queue
            from repro_torch.core.annealing_torch import config_from_sa_params
            self._jax_cfg = config_from_sa_params(self.sa_params)

    def _anneal_perm(self, arrays) -> List[int]:
        if self.backend == "jax":
            from repro_torch.core.annealing_torch import priority_mapping_torch
            p = self.sa_params
            perm, _, _ = priority_mapping_torch(
                arrays, self.model, self.max_batch, self._jax_cfg,
                seed=p.seed, incremental=p.incremental, device=self.device)
            return [int(i) for i in perm]
        sa = priority_mapping(arrays, self.model, self.max_batch,
                              self.sa_params)
        return [int(i) for i in sa.perm]

    def decide(self, view):
        pending = view.pending
        if len(pending) < self.min_queue:
            return Decision(admit=list(range(min(view.free, len(pending)))))
        shifted = [with_remaining_slo(r, view.now) for r in pending]
        return Decision(admit=self._anneal_perm(as_arrays(shifted)))


class SLOPreemptPolicy(SchedulingPolicy):
    """Multi-SLO preemption (SLOs-Serve style): when a tight-SLO arrival
    would miss its first-token deadline waiting for a natural slot, evict
    the active request with the largest positive slack — provided that
    victim can still absorb its own re-prefill (KV recompute) cost.

    Admission order is urgency-first (smallest remaining TTFT/e2e
    budget).  Requests without a first-token-sensitive SLO never trigger
    an eviction.

    On a paged-KV executor (``view.free_blocks`` is set) the policy is
    memory-aware: admissions are filtered to what the free blocks cover,
    a tight arrival short on *blocks* (not just slots) may trigger
    eviction, victims are ranked by **freed blocks per unit of slack**
    (most memory recovered at least deadline risk; no-SLO victims rank
    first), and several victims may be evicted for one large arrival.
    """

    preemptive = True

    def __init__(self, model: LinearLatencyModel, margin: float = 0.0):
        self.model = model
        self.margin = margin

    def _budget(self, view: SchedulerView, i: int) -> float:
        """Remaining time until ``pending[i]``'s tightest live deadline
        (see :func:`pending_budget`)."""
        return pending_budget(view, i)

    def _prefill_cost(self, view: SchedulerView, ctx: int,
                      cached: int = 0) -> float:
        """Discipline-aware time-to-first-token (see
        :func:`discipline_prefill_cost`)."""
        return discipline_prefill_cost(view, self.model, ctx, cached)

    def _constraints(self, view: SchedulerView, i: int):
        """(remaining budget, modelled service time) per applicable live
        SLO of ``pending[i]`` if admitted now.  TTFT needs the prefill;
        e2e needs prefill + the decode of its remaining output tokens."""
        r = view.pending[i]
        waited = max(0.0, view.now - submit_base(r))
        ctx = view.pending_context_len(i)
        prefill = self._prefill_cost(view, ctx, view.pending_cached_len(i))
        out = []
        if r.slo.ttft is not None and ctx == r.input_len:
            out.append((r.slo.ttft - waited, prefill))
        if r.slo.e2e is not None:
            try:
                gen = ctx - r.input_len
                # prefill emits one token; the rest are decode rounds
                rem = max(int(r.planning_output_len()) - gen - 1, 0)
                decode = self.model.decode_time(1, ctx, rem)
            except ValueError:              # no output-length estimate
                decode = 0.0
            out.append((r.slo.e2e - waited, prefill + decode))
        return out, prefill

    def _victim_order(self, view: SchedulerView) -> List[int]:
        if view.free_blocks is None:
            return sorted(range(len(view.active)),
                          key=lambda j: view.active[j].slack, reverse=True)

        # memory-aware ranking: blocks freed per unit of slack consumed.
        # No-SLO victims (infinite slack) are free memory — rank first,
        # largest holdings first; non-positive slack ranks last (the
        # absorb guard rejects those anyway).
        def vkey(j):
            v = view.active[j]
            if v.slack == math.inf:
                return (2, v.blocks_held)
            if v.slack > 0:
                return (1, v.blocks_held / v.slack)
            return (0, v.slack)
        return sorted(range(len(view.active)), key=vkey, reverse=True)

    def decide(self, view):
        if not view.pending:
            return Decision()
        budgets = [self._budget(view, i) for i in range(len(view.pending))]
        order = sorted(range(len(view.pending)), key=budgets.__getitem__)
        avail = view.free_blocks            # None on unpaged executors
        admit: List[int] = []
        overflow: List[int] = []
        for i in order:
            need = view.pending_blocks(i) if avail is not None else 0
            if len(admit) < view.free and (avail is None or need <= avail):
                admit.append(i)
                if avail is not None:
                    avail -= need
            else:
                overflow.append(i)          # short a slot or short blocks
        preempt: List[int] = []
        victims = self._victim_order(view)
        vi = 0
        # modelled completion time of each running request: the k-th
        # arrival left waiting gets (at best) the k-th slot to free up
        b = max(len(view.active), 1)
        comps = {j: self.model.decode_time(b, v.context_len,
                                           max(v.remaining, 0))
                 for j, v in enumerate(view.active)}
        cons_cache = {i: self._constraints(view, i)
                      for i in range(len(view.pending))
                      if budgets[i] != math.inf}
        # a re-queued victim re-enters with the loosest budget, so every
        # deadline-bearing pending request runs before it: its slack must
        # absorb all of their service, not just the triggering arrival's
        urgent_service = sum(max((s for _, s in cons), default=0.0)
                             for cons, _ in cons_cache.values())
        queued = 0                          # arrivals left to wait so far
        for i in overflow:
            if budgets[i] == math.inf:
                break                       # sorted: the rest are ∞ too
            cons, _ = cons_cache[i]
            if any(bud < s + self.margin for bud, s in cons):
                queued += 1                 # doomed, but it still claims
                continue                    # a freeing slot later
            need = view.pending_blocks(i) if avail is not None else 0
            remaining = sorted(c for j, c in comps.items()
                               if j not in preempt)
            # when waiters outnumber running requests the true wait is
            # longer than any single completion; clamping to the last
            # one is optimistic but empirically stable — an unbounded
            # estimate here makes every overflow arrival demand an
            # eviction and the queue thrashes (att 1.0 -> 0.89 on the
            # contended benchmark)
            wait = remaining[min(queued, len(remaining) - 1)] \
                if remaining else 0.0
            # blocks, like slots, free naturally when runners finish — an
            # arrival that can afford the wait never triggers an eviction
            if all(bud >= wait + s + self.margin for bud, s in cons):
                queued += 1                 # makes it without eviction
                continue
            # evict from vi onward until the blocks are covered (one
            # victim always suffices on unpaged executors); every victim
            # in the chain must absorb its own recompute
            picked: List[int] = []
            freed = 0
            vj = vi
            ok = False
            while vj < len(victims):
                j = victims[vj]
                v = view.active[j]
                # a victim's cached prefix survives its eviction (the
                # index owns those pages), so its re-prefill skips it too
                recompute = self._prefill_cost(
                    view, v.request.input_len + v.generated,
                    int(getattr(v.request, "cached_prefix", 0) or 0))
                if not (v.slack > recompute + urgent_service + self.margin):
                    break                   # victims can't absorb THIS
                picked.append(j)            # arrival; try the next one
                freed += v.blocks_held
                vj += 1
                if avail is None or need <= avail + freed:
                    ok = True
                    break
            if not ok:
                queued += 1
                continue
            preempt.extend(picked)
            vi = vj
            if avail is not None:
                avail += freed - need
            admit.append(i)
        return Decision(admit=admit, preempt=preempt)


class IndexPolicy(SchedulingPolicy):
    """Theory-grounded priority-index admission ("Optimal Scheduling
    Algorithms for LLM Inference", arXiv 2508.01002): each pending
    request gets a closed-form index — no anneal — and the highest
    indices take the free slots.  Three members of the family share the
    machinery:

    ``w`` (default — the W-index)
        ``1 / (slack · service)`` where slack is the remaining deadline
        budget minus the modelled service time and service is the
        discipline-aware prefill plus remaining decode.  Urgent *and*
        short requests dominate; the index diverges as slack → 0, so a
        request is pulled forward exactly while pulling it forward can
        still save it.
    ``sjf``
        ``1 / service`` — shortest-remaining-service first (optimal for
        mean latency when nothing has a deadline).
    ``edf``
        ``-budget`` — earliest live deadline first.

    Under ``w`` requests are tiered: savable deadline-bearing requests
    (slack > 0) outrank no-deadline ones, which outrank the doomed
    (slack ≤ 0 — serving them cannot meet anything, so they yield to
    requests that can still be saved; within the doomed tier shortest
    first, to shed them cheapest).  Ties break on ``req_id`` so the
    admitted *set and order* are invariant to any permutation of the
    pending queue.

    On a paged executor the admission walk is block-aware: a request
    whose unique new blocks exceed the remaining free blocks is skipped
    — not a barrier — so smaller lower-index requests can still fill
    the pool.
    """

    def __init__(self, model: LinearLatencyModel, mode: str = "w",
                 eps: float = 1e-6):
        if mode not in ("w", "sjf", "edf"):
            raise ValueError(
                f"mode must be 'w', 'sjf' or 'edf', got {mode!r}")
        self.model = model
        self.mode = mode
        self.eps = eps

    def _index(self, view: SchedulerView, i: int) -> Tuple[int, float]:
        """(tier, index) of ``pending[i]`` — higher admits first."""
        service = max(pending_service(view, i, self.model), self.eps)
        if self.mode == "sjf":
            return (0, 1.0 / service)
        budget = pending_budget(view, i)
        if self.mode == "edf":
            return (0, -budget)
        if budget == math.inf:
            return (1, 1.0 / service)
        slack = budget - service
        if slack <= 0.0:
            return (0, 1.0 / service)
        return (2, 1.0 / (max(slack, self.eps) * service))

    def decide(self, view):
        def key(i):
            tier, idx = self._index(view, i)
            return (tier, idx, -getattr(view.pending[i], "req_id", i))
        order = sorted(range(len(view.pending)), key=key, reverse=True)
        avail = view.free_blocks            # None on unpaged executors
        admit: List[int] = []
        for i in order:
            if len(admit) >= view.free:
                break
            need = view.pending_blocks(i) if avail is not None else 0
            if avail is not None and need > avail:
                continue
            admit.append(i)
            if avail is not None:
                avail -= need
        return Decision(admit=admit)


# ------------------------------------------------------ v1 compatibility
class AdmissionPolicy(SchedulingPolicy):
    """Deprecated v1 base class (admit-only, no view of the active set).

    Subclasses implementing ``select(pending, now, free, active_count)``
    keep working — ``decide`` adapts the call — but should migrate to
    :class:`SchedulingPolicy`.  This shim is kept for one release.
    """

    def __init_subclass__(cls, **kw):
        super().__init_subclass__(**kw)
        warnings.warn(
            f"{cls.__name__} subclasses the deprecated AdmissionPolicy; "
            "subclass SchedulingPolicy and implement decide(view) instead",
            DeprecationWarning, stacklevel=2)

    def select(self, pending: Sequence[Request], now: float, free: int,
               active_count: int) -> List[int]:
        raise NotImplementedError

    def decide(self, view):
        return Decision(admit=list(self.select(
            list(view.pending), view.now, view.free, len(view.active))))


class _LegacySelectAdapter(SchedulingPolicy):
    """Wraps a duck-typed v1 object (has ``select``, no ``decide``)."""

    def __init__(self, obj):
        self._obj = obj

    def reset(self):
        reset = getattr(self._obj, "reset", None)
        if reset is not None:
            reset()

    def decide(self, view):
        return Decision(admit=list(self._obj.select(
            list(view.pending), view.now, view.free, len(view.active))))


def resolve_policy(policy, **ctx) -> Tuple[SchedulingPolicy, bool]:
    """One policy-resolution protocol for every executor: coerce a
    registry key (built with the ``ctx`` kwargs) or a v1/v2 policy
    object into the v2 protocol, reset it for a fresh run, and report
    whether it can preempt.  Returns ``(policy, preemptive)``."""
    if isinstance(policy, str):
        policy = make(policy, **ctx)
    pol = as_scheduling_policy(policy)
    if hasattr(pol, "reset"):
        pol.reset()
    return pol, bool(getattr(pol, "preemptive", False))


def normalize_decision(dec: Decision, view: SchedulerView
                       ) -> Tuple[List[int], List[int]]:
    """Validate a policy's :class:`Decision` for an executor — one
    protocol for the event core and the engine.

    Returns ``(admit, preempt)``: both deduplicated and bounds-checked
    against the view; ``admit`` preserves the policy's order (the caller
    truncates to the slots available after preemption), ``preempt`` is
    reverse-sorted so victims can be popped from the active list without
    invalidating the remaining indices.
    """
    admit = [j for j in dict.fromkeys(dec.admit)
             if 0 <= j < len(view.pending)]
    preempt = sorted({j for j in dec.preempt if 0 <= j < len(view.active)},
                     reverse=True)
    return admit, preempt


def as_scheduling_policy(obj) -> SchedulingPolicy:
    """Coerce v1/v2 policy objects into the v2 protocol."""
    if isinstance(obj, SchedulingPolicy):
        return obj
    if hasattr(obj, "decide"):
        return obj
    if hasattr(obj, "select"):
        warnings.warn(
            f"{type(obj).__name__} only implements the deprecated "
            "select() protocol; implement decide(view) instead",
            DeprecationWarning, stacklevel=2)
        return _LegacySelectAdapter(obj)
    raise TypeError(f"{obj!r} is not a SchedulingPolicy (no decide/select)")


# ------------------------------------------------------------ disciplines
class ExecutionDiscipline:
    """How admitted prefills interleave with running decode rounds.

    ``chunk_size == 0`` means whole-prompt prefill (running decodes
    stall for the full span); ``chunk_size > 0`` means Sarathi-style
    chunking: each in-flight prefill advances one ``chunk_size`` chunk
    per tick, sharing the tick with the running batch's decode round.
    The same objects configure the event core, ``Engine.run_policy``
    and the streaming ``ServeLoop`` — all three drive the one
    plan/execute cycle through :meth:`plan_step`."""

    chunk_size: int = 0

    def plan_step(self, prefills: Sequence[Tuple[int, int, int]],
                  decodes: Sequence[int] = ()) -> StepPlan:
        """Emit one tick's :class:`StepPlan`.

        ``prefills`` is the in-flight prefill state as ``(ref, done,
        total)`` triples — ``done`` context tokens already computed of
        ``total`` (an aliased cached prefix counts as done).
        ``decodes`` is the refs of the running requests.  A stalling
        discipline emits the whole remaining span per prefill; a
        chunked one emits at most ``chunk_size`` tokens per prefill per
        tick (``chunk_size`` is re-read every call, so an adaptive
        discipline retuned mid-run takes effect on the next tick).
        Decode items always ride in the same plan: the executor runs
        one decode round after the prefill items, which is what makes
        the batch stall-free."""
        C = self.chunk_size
        items = []
        for ref, done, total in prefills:
            rem = int(total) - int(done)
            if rem <= 0:
                continue
            span = rem if C <= 0 else min(int(C), rem)
            items.append(PlanItem("prefill", int(ref), int(done), span,
                                  last=span >= rem))
        for ref in decodes:
            items.append(PlanItem("decode", int(ref), 0, 1))
        return StepPlan(tuple(items))

    def __repr__(self):
        return f"{type(self).__name__}()"


class StallingPrefill(ExecutionDiscipline):
    """Whole-prompt prefill; running decodes stall for its duration."""


class ChunkedPrefill(ExecutionDiscipline):
    """Chunked prefill: running decodes advance between chunks."""

    def __init__(self, chunk_size: int = 64):
        if chunk_size <= 0:
            raise ValueError("chunk_size must be positive")
        self.chunk_size = int(chunk_size)

    def __repr__(self):
        return f"ChunkedPrefill({self.chunk_size})"


class AdaptiveChunkedPrefill(ChunkedPrefill):
    """A :class:`ChunkedPrefill` whose ``chunk_size`` is rewritten per
    admission decision by :class:`DynamicChunkPolicy`.  Both executors
    re-read ``chunk_size`` at every admission, so a mutation takes
    effect on the very next prefill."""

    def __repr__(self):
        return f"AdaptiveChunkedPrefill({self.chunk_size})"


# ----------------------------------------------------- dynamic chunk size
class DynamicChunkPolicy(SchedulingPolicy):
    """SLOs-Serve-style per-admission dynamic chunk sizing (arXiv
    2504.08784): before delegating admission to a base policy, solve for
    the largest prefill chunk the running batch's TPOT headroom permits
    and write it into the (shared, mutable) chunked discipline.

    A chunk stalls every running decode for ``prefill_time(1, C)``, so
    the tightest running TPOT budget bounds the chunk:

        prefill_time(1, C) ≤ min_j (tpot_j − τ_d(b, ctx_j))
        ⇒  C = (head − β_p − δ_p) / (α_p + γ_p)

    clamped to ``[min_chunk, max_chunk]``.  With no TPOT-bearing request
    running, the chunk opens to ``max_chunk`` (prefill throughput);
    under decode pressure it shrinks toward ``min_chunk`` (tail TBT).

    The policy carries its own :class:`AdaptiveChunkedPrefill` in
    ``.discipline`` — hand that to the executor — and also rewrites any
    *other* chunked ``view.discipline`` it is handed, so admission
    pricing within the same decision sees the new size.  Admission is
    delegated to ``base`` (default: the W-index policy), which prices
    prefill under the freshly-set chunk.
    """

    def __init__(self, model: LinearLatencyModel,
                 base: Optional[SchedulingPolicy] = None,
                 min_chunk: int = 16, max_chunk: int = 512):
        if not 0 < int(min_chunk) <= int(max_chunk):
            raise ValueError("need 0 < min_chunk <= max_chunk")
        self.model = model
        self.base = base if base is not None else IndexPolicy(model)
        self.min_chunk = int(min_chunk)
        self.max_chunk = int(max_chunk)
        self.discipline = AdaptiveChunkedPrefill(self.max_chunk)

    @property
    def preemptive(self):
        return bool(getattr(self.base, "preemptive", False))

    def reset(self):
        self.discipline.chunk_size = self.max_chunk
        self.base.reset()

    def chunk_for(self, view: SchedulerView) -> int:
        """Largest chunk the running batch's TPOT headroom permits."""
        m = self.model
        b = max(len(view.active), 1)
        heads = [v.request.slo.tpot - m.per_token_decode_time(
                     b, v.context_len)
                 for v in view.active if v.request.slo.tpot is not None]
        if not heads:
            return self.max_chunk
        head = min(heads) - m.beta_p - m.delta_p
        denom = m.alpha_p + m.gamma_p
        if denom <= 0.0:                    # flat prefill cost in length
            return self.max_chunk if head > 0 else self.min_chunk
        return int(min(max(head / denom, self.min_chunk), self.max_chunk))

    def retune(self, view: SchedulerView) -> int:
        """Re-solve the chunk size for the *current* running batch and
        write it into the adaptive discipline(s).  Executors call this
        every tick where no admission decision runs (``decide`` retunes
        on its own), so the chunk tracks the batch's TPOT headroom
        tick-by-tick — opening up as tight requests drain, shrinking
        as they pile in — not just at admission instants."""
        C = self.chunk_for(view)
        self.discipline.chunk_size = C
        disc = view.discipline
        if disc is not None and disc is not self.discipline \
                and getattr(disc, "chunk_size", 0) > 0:
            disc.chunk_size = C
        return C

    def decide(self, view):
        self.retune(view)
        return self.base.decide(view)


# ------------------------------------------------------- instance mapping
@dataclasses.dataclass(frozen=True)
class InstanceState:
    """One serving instance as an :class:`InstanceMapper` sees it — a
    load snapshot the fleet (or the multi-instance scheduler) builds
    per routing decision.  Simulator callers that only need instance
    identities can leave the load fields at their defaults."""
    instance_id: int
    queue_depth: int = 0      # submitted but not yet running
    active: int = 0           # occupied engine slots
    free_slots: int = 0
    free_blocks: int = 0      # KV pool headroom (paged engines)
    active_tokens: int = 0    # live context tokens across running slots


class InstanceMapper:
    """Maps arriving requests onto serving instances (paper §4.4).

    One code path for both consumers: the real-serving ``EngineFleet``
    routes arrivals through :meth:`map_one` / :meth:`plan`, and the
    multi-instance scheduler's ``assign_instances`` (feeding
    ``run_multi_instance`` in the simulator) delegates to
    :meth:`map_batch` — so a mapper validated in simulation serves
    unchanged.

    ``map_batch`` returns one instance id per request, order-preserving
    over the input.  ``plan`` returns per-instance *submission orders*
    (lists of request indices): the default groups ``map_batch``'s
    assignment preserving arrival order, while planning mappers
    (:class:`AnnealedMapper`) reorder within each instance — the fleet
    submits in exactly this order, so a priority plan becomes the
    engines' FCFS admission order.
    """

    def map_batch(self, requests: Sequence[Request],
                  states: Sequence[InstanceState]) -> List[int]:
        raise NotImplementedError

    def map_one(self, request: Request,
                states: Sequence[InstanceState]) -> int:
        return self.map_batch([request], states)[0]

    def plan(self, requests: Sequence[Request],
             states: Sequence[InstanceState]) -> List[List[int]]:
        assign = self.map_batch(requests, states)
        by_inst: Dict[int, List[int]] = {s.instance_id: [] for s in states}
        for i, inst in enumerate(assign):
            by_inst[inst].append(i)
        return [by_inst[s.instance_id] for s in states]


class RoundRobinMapper(InstanceMapper):
    """Stateful round-robin — the trivial baseline."""

    def __init__(self):
        self._next = 0

    def map_batch(self, requests, states):
        out = []
        for _ in requests:
            out.append(states[self._next % len(states)].instance_id)
            self._next += 1
        return out


class LeastLoadedMapper(InstanceMapper):
    """Route to the instance with the fewest queued + running requests,
    counting assignments made earlier in the same batch; ties go to the
    lowest instance id."""

    def map_batch(self, requests, states):
        load = {s.instance_id: s.queue_depth + s.active for s in states}
        order = sorted(load)
        out = []
        for _ in requests:
            tgt = min(order, key=lambda i: (load[i], i))
            load[tgt] += 1
            out.append(tgt)
        return out


class SLOAffinityMapper(InstanceMapper):
    """Pin each SLO class (``task_type``) to a home instance — the
    SLOs-Serve-style per-class replica split (arXiv 2504.08784): a
    class's requests share prefixes and latency profiles, so keeping
    them together maximizes KV reuse and keeps the per-instance
    workload unimodal.  Classes are assigned round-robin on first
    sight; unseen-class spill goes least-loaded."""

    def __init__(self):
        self._home: Dict[str, int] = {}

    def map_batch(self, requests, states):
        ids = [s.instance_id for s in states]
        out = []
        for r in requests:
            cls = r.task_type
            if cls not in self._home:
                self._home[cls] = ids[len(self._home) % len(ids)]
            out.append(self._home[cls])
        return out


class MemoryGreedyMapper(InstanceMapper):
    """The paper's Algorithm-2 assignment step (Eq. 20): round-robin to
    the instance with the largest remaining memory, resetting the
    accounting when the fullest instance cannot take the next request
    (a maximal wave has been assigned)."""

    def __init__(self, memory=None):
        if memory is None:
            from repro_torch.core.profiler import MemoryModel
            memory = MemoryModel(total_memory=float("inf"), mu=0.9,
                                 sigma_per_token=1.0)
        self.memory = memory

    def map_batch(self, requests, states):
        ids = [s.instance_id for s in states]
        remaining = {i: self.memory.total for i in ids}
        out = []
        for req in requests:
            need = self.memory.tokens_to_memory(
                req.input_len + req.planning_output_len())
            tgt = max(ids, key=lambda i: (remaining[i], -i))
            if remaining[tgt] < need:
                remaining = {i: self.memory.total for i in ids}
                tgt = max(ids, key=lambda i: (remaining[i], -i))
            remaining[tgt] -= need
            out.append(tgt)
        return out


class AnnealedMapper(InstanceMapper):
    """Full Algorithm 2: memory-greedy assignment then a per-instance
    Algorithm-1 priority anneal (``priority_mapping_multi_torch`` when
    ``use_jax`` — all instances × chains in one vmapped jit).  ``plan``
    returns each instance's annealed batch order, which the fleet
    replays as its submission order; ``map_batch`` exposes just the
    assignment for callers that ignore ordering."""

    def __init__(self, model, max_batch: int = 8, sa_params=None,
                 memory=None, use_jax: bool = True, device=None):
        self.model = model
        self.max_batch = max_batch
        self.sa_params = sa_params
        self.memory = memory
        self.use_jax = use_jax
        self.device = device

    def _scheduler(self, n_instances: int):
        from repro_torch.core.scheduler import SLOAwareScheduler
        return SLOAwareScheduler(self.model, num_instances=n_instances,
                                 max_batch=self.max_batch,
                                 memory=self.memory,
                                 sa_params=self.sa_params,
                                 use_jax=self.use_jax, device=self.device)

    def map_batch(self, requests, states):
        sched = self._scheduler(len(states))
        assignment = sched.schedule(list(requests)).assignment
        ids = [s.instance_id for s in states]
        return [ids[assignment[r.req_id]] for r in requests]

    def plan(self, requests, states):
        sched = self._scheduler(len(states))
        outcome = sched.schedule(list(requests))
        index_of = {id(r): i for i, r in enumerate(requests)}
        return [[index_of[id(r)] for b in q.batches for r in b]
                for q in outcome.queues]


def make_mapper(obj: "Union[str, InstanceMapper]", **kwargs
                ) -> InstanceMapper:
    """Coerce a registry key (``"least-loaded"``, ``"route:annealed"``)
    or mapper instance into an :class:`InstanceMapper`."""
    if isinstance(obj, InstanceMapper):
        return obj
    name = obj if obj.startswith("route:") else f"route:{obj}"
    out = make(name, **kwargs)
    if not isinstance(out, InstanceMapper):
        raise TypeError(f"{obj!r} is not an InstanceMapper")
    return out


# --------------------------------------------------------------- registry
_REGISTRY: Dict[str, Callable] = {}


def register(name: str):
    """Register a policy/discipline factory under a string key."""
    def deco(fn):
        _REGISTRY[name] = fn
        return fn
    return deco


def make(name: Union[str, SchedulingPolicy, ExecutionDiscipline], **kwargs):
    """String-keyed factory for policies and disciplines.

    ``make("fcfs")``, ``make("slo-reanneal", model=m, max_batch=8)``,
    ``make("slo-preempt", model=m)``, ``make("planned", batches=...)``,
    ``make("stall")``, ``make("chunked", chunk_size=32)`` or the compact
    ``make("chunked:32")``.  Policy/discipline objects pass through
    unchanged, so every call site can accept either form.  Factories
    ignore context kwargs they don't need, letting callers pass one
    blanket context (model, max_batch, …).
    """
    if not isinstance(name, str):
        return name
    key, _, suffix = name.partition(":")
    try:
        factory = _REGISTRY[key]
    except KeyError:
        raise ValueError(
            f"unknown policy/discipline {name!r}; registered keys: "
            f"{sorted(_REGISTRY)}") from None
    if suffix:
        import inspect
        if "arg" not in inspect.signature(factory).parameters:
            raise ValueError(
                f"{key!r} takes no ':<arg>' suffix (got {name!r})")
        kwargs.setdefault("arg", suffix)
    return factory(**kwargs)


def make_discipline(obj: Union[str, ExecutionDiscipline, None]
                    ) -> ExecutionDiscipline:
    """Coerce strings/None into an :class:`ExecutionDiscipline`."""
    if obj is None:
        return StallingPrefill()
    out = make(obj)
    if not isinstance(out, ExecutionDiscipline):
        raise TypeError(f"{obj!r} is not an ExecutionDiscipline")
    return out


def _require(kwargs_value, what, key):
    if kwargs_value is None:
        raise ValueError(f"policy {key!r} needs {what}")
    return kwargs_value


@register("fcfs")
@register("priority")
def _make_fcfs(**_):
    return FCFSPolicy()


@register("planned")
def _make_planned(batches=None, **_):
    return PlannedPolicy(_require(batches, "batches=...", "planned"))


@register("slo-reanneal")
def _make_reanneal(model=None, max_batch=None, sa_params=None,
                   min_queue=2, backend=None, arg=None, device=None, **_):
    # "slo-reanneal:jax" selects the jitted annealer backend
    if backend is None:
        backend = arg if arg is not None else "python"
    return SLOReannealPolicy(_require(model, "model=...", "slo-reanneal"),
                             _require(max_batch, "max_batch=...",
                                      "slo-reanneal"),
                             sa_params, min_queue, backend=backend,
                             device=device)


@register("slo-preempt")
def _make_preempt(model=None, margin=0.0, **_):
    return SLOPreemptPolicy(_require(model, "model=...", "slo-preempt"),
                            margin=margin)


@register("index")
@register("w-index")
def _make_index(model=None, mode=None, eps=1e-6, arg=None, **_):
    # "index:w" / "index:sjf" / "index:edf" select the family member;
    # "w-index" is shorthand for the default W-index
    if mode is None:
        mode = arg if arg is not None else "w"
    return IndexPolicy(_require(model, "model=...", "index"),
                       mode=mode, eps=eps)


@register("dynamic-chunk")
def _make_dynamic_chunk(model=None, base=None, min_chunk=16,
                        max_chunk=None, arg=None, **_):
    # "dynamic-chunk:128" caps the chunk at 128 tokens
    if max_chunk is None:
        max_chunk = int(arg) if arg is not None else 512
    return DynamicChunkPolicy(_require(model, "model=...", "dynamic-chunk"),
                              base=base, min_chunk=min_chunk,
                              max_chunk=max_chunk)


@register("stall")
def _make_stall(**_):
    return StallingPrefill()


@register("chunked")
def _make_chunked(arg=None, chunk_size=None, **_):
    if arg is not None:
        size = int(arg)
    else:
        size = chunk_size if chunk_size is not None else 64
    return ChunkedPrefill(size)


@register("route")
def _make_route(arg=None, model=None, max_batch=8, sa_params=None,
                memory=None, use_jax=True, device=None, **_):
    """Instance mappers: ``route:least-loaded`` (default),
    ``route:round-robin``, ``route:slo-affinity``,
    ``route:memory-greedy``, ``route:annealed`` (Algorithm 2; needs
    ``model=``)."""
    kind = arg or "least-loaded"
    if kind == "round-robin":
        return RoundRobinMapper()
    if kind == "least-loaded":
        return LeastLoadedMapper()
    if kind == "slo-affinity":
        return SLOAffinityMapper()
    if kind == "memory-greedy":
        return MemoryGreedyMapper(memory)
    if kind == "annealed":
        return AnnealedMapper(_require(model, "model=...", "route:annealed"),
                              max_batch=max_batch, sa_params=sa_params,
                              memory=memory, use_jax=use_jax, device=device)
    raise ValueError(f"unknown instance mapper 'route:{kind}'")
