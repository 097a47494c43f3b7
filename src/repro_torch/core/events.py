"""Unified discrete-event serving core (scheduling API v2).

Historically this repo carried *three* hand-rolled continuous-batching
loops — ``online.simulate_online``, ``simulator.run_fcfs_continuous`` (and
friends), and the slot pool inside ``engine.Engine`` — whose token
accounting had silently diverged: the real engine samples the first token
from the prefill logits (TTFT *is* the first generated token, so a request
needs ``l_o - 1`` decode rounds), while both simulators required ``l_o``
decode rounds after TTFT and computed TPOT over a different token count.

This module is the single execution loop.  ``simulate`` is a
token-granularity discrete-event simulator driven by the two v2
scheduling abstractions from :mod:`repro_torch.core.policies`:

  * :class:`~repro_torch.core.policies.SchedulingPolicy` — at every scheduling
    event the policy receives a :class:`~repro_torch.core.policies.SchedulerView`
    (pending queue, active set with generated/remaining/slack, instance
    id, clock, free slots) and returns a
    :class:`~repro_torch.core.policies.Decision` with ``admit`` *and*
    ``preempt`` lists.  Preempted requests return to pending with KV
    discarded; re-admission re-prefills prompt + generated tokens
    (recompute cost charged).  Built-ins: ``FCFSPolicy``,
    ``PlannedPolicy``, ``SLOReannealPolicy``, ``SLOPreemptPolicy``.  The
    *same* policy objects drive the real engine (``Engine.run_policy``),
    so simulated and measured runs share one scheduling brain.
  * :class:`~repro_torch.core.policies.ExecutionDiscipline` — emits each
    tick's :class:`~repro_torch.core.policies.StepPlan`: one prefill span per
    staged (mid-prefill) request plus one decode item per active
    request.  ``StallingPrefill`` completes each prefill in one batched
    tick (running decodes stall behind it); ``ChunkedPrefill(n)``
    advances every staged prefill one chunk per tick, sharing the tick
    with the running decode round — the same plan/execute cycle
    ``Engine.execute_step`` runs, so simulated and real chunk timelines
    line up tick for tick.

The v1 ``AdmissionPolicy.select`` protocol still works through a
deprecation shim (see :mod:`repro_torch.core.policies`); new code should
implement ``decide(view)``.

Execution semantics (engine-faithful — the fix for the historical drift):

  * prefill of an admitted set under ``StallingPrefill`` is batched: it
    completes at ``clock + max(member prefill times)``; that instant is
    TTFT *and* the first generated token (``gen = 1``); under
    ``ChunkedPrefill`` every staged request advances one chunk per tick
    (chunks priced back-to-back within the tick) and activates on its
    final chunk *before* that tick's decode round, so its first decode
    token rides the same tick; mid-prefill requests hold a slot but are
    excluded from decode rounds and the policies' active view;
  * each decode round generates one token for every active request and
    costs the max per-token decode time over the active set; a request
    finishes once ``gen == l_o`` — i.e. ``l_o - 1`` decode rounds after
    prefill (a request with ``l_o == 1`` finishes at prefill);
  * TPOT = (e2e − TTFT) / l_o, matching ``RuntimeRequest.metrics``;
  * a preempted request keeps its generated tokens and its original
    TTFT; on re-admission the prefill length is ``l_i + generated``
    (vLLM-style recompute) and the prefill emits the next token.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Union

import numpy as np

from repro_torch.core.annealing import SAParams
from repro_torch.core.latency_model import LinearLatencyModel
# AdmissionPolicy/FCFSPolicy/PlannedPolicy/SLOReannealPolicy are
# re-exported here for v1 import compatibility (simulator.py, online.py)
from repro_torch.core.policies import (AdmissionPolicy, ExecutionDiscipline,  # noqa: F401
                                 FCFSPolicy, PlannedPolicy,  # noqa: F401
                                 SchedulerView, SchedulingPolicy,
                                 SLOReannealPolicy,  # noqa: F401
                                 make_active_view, make_discipline,
                                 normalize_decision, resolve_policy)
from repro_torch.core.slo import Request, meets_slo


@dataclasses.dataclass
class SimResult:
    e2e: Dict[int, float]
    ttft: Dict[int, float]
    tpot: Dict[int, float]
    met: Dict[int, bool]
    preemptions: Dict[int, int] = dataclasses.field(default_factory=dict)

    @property
    def n(self):
        return len(self.e2e)

    @property
    def attainment(self) -> float:
        return sum(self.met.values()) / max(self.n, 1)

    @property
    def total_latency(self) -> float:
        return sum(self.e2e.values())

    @property
    def avg_latency(self) -> float:
        return self.total_latency / max(self.n, 1)

    @property
    def n_preempted(self) -> int:
        return sum(self.preemptions.values())

    @property
    def G(self) -> float:
        t = self.total_latency
        return sum(self.met.values()) / t if t > 0 else 0.0

    def merged_with(self, other: "SimResult") -> "SimResult":
        return SimResult(e2e={**self.e2e, **other.e2e},
                         ttft={**self.ttft, **other.ttft},
                         tpot={**self.tpot, **other.tpot},
                         met={**self.met, **other.met},
                         preemptions={**self.preemptions,
                                      **other.preemptions})


def _noise(rng: Optional[np.random.Generator], sigma: float) -> float:
    if rng is None or sigma <= 0:
        return 1.0
    return float(np.exp(rng.normal(0.0, sigma)))


# ------------------------------------------------------------------- core
class _Instance:
    __slots__ = ("clock", "active", "prefilling", "dispatched")

    def __init__(self, clock: float = 0.0):
        self.clock = clock
        self.active: List[dict] = []
        # staged prefills advancing tick-by-tick under the step plan:
        # {"req", "done", "total", "gen0", "ttft0"} — the sim analog of
        # the engine's PREFILLING slots (they hold capacity but are
        # invisible to decode rounds and the policies' active view)
        self.prefilling: List[dict] = []
        self.dispatched = False


def simulate(requests: Sequence[Request], model: LinearLatencyModel,
             max_batch: int,
             policy: Union[str, SchedulingPolicy] = "fcfs", *,
             num_instances: int = 1,
             discipline: Union[str, ExecutionDiscipline, None] = None,
             noise_sigma: float = 0.0,
             rng: Optional[np.random.Generator] = None,
             respect_arrivals: bool = True,
             inter_batch_gap: float = 0.0,
             sa_params: Optional[SAParams] = None,
             reanneal_min_queue: int = 2) -> SimResult:
    """Run the unified discrete-event serving loop.

    Parameters
    ----------
    policy : a :class:`SchedulingPolicy` (shared across instances), a v1
        ``select``-style object (deprecated, adapted automatically), or a
        registry key — ``"fcfs"`` / ``"priority"`` / ``"slo-reanneal"``
        / ``"slo-preempt"``.
    discipline : an :class:`ExecutionDiscipline` or registry key
        (``"stall"``, ``"chunked"``, ``"chunked:32"``).  Default:
        :class:`StallingPrefill`.
    num_instances : parallel servers draining the shared pending queue.
    respect_arrivals : when False, every request is available at t=0 and
        metrics are absolute (the classic offline-pool convention of the
        ``run_*`` wrappers); when True, arrivals follow
        ``Request.arrival_time`` and metrics are arrival-relative.
    inter_batch_gap : idle gap inserted before each non-first admission
        into a fully drained instance (planned-dispatch convention).
    """
    pol, preemptive = resolve_policy(policy, model=model,
                                     max_batch=max_batch,
                                     sa_params=sa_params,
                                     min_queue=reanneal_min_queue)
    if discipline is None:
        # a policy that carries its own discipline (dynamic-chunk's
        # AdaptiveChunkedPrefill) executes under it — same convention
        # as Engine.run_policy, and object identity is preserved so
        # the policy's per-tick retuning reaches the planner
        discipline = getattr(pol, "discipline", None)
    disc = make_discipline(discipline)
    res = SimResult({}, {}, {}, {})

    def arr_of(r: Request) -> float:
        return r.arrival_time if respect_arrivals else 0.0

    def cp_of(r: Request) -> int:
        """Cached-prefix tokens (shared-prefix KV reuse): that span of
        the prompt is aliased, not computed, so prefill is charged for
        the unique suffix only.  Clipped below the prompt length — at
        least one token is always computed.  Survives preemption: the
        prefix index owns the pages, so a re-prefill skips them again."""
        cp = int(getattr(r, "cached_prefix", 0) or 0)
        return min(max(cp, 0), r.input_len - 1)

    future = sorted(requests, key=arr_of)          # stable for ties
    fi = 0
    pending: List[Request] = []
    # preempted-request carry state: req_id -> {"gen", "ttft"}
    carry: Dict[int, dict] = {}
    insts = [_Instance() for _ in range(num_instances)]

    def finish(a: dict, clock: float):
        r = a["req"]
        base = arr_of(r)
        e2e = clock - base
        ttft = a["ttft"] - base
        tpot = (clock - a["ttft"]) / max(a["gen"], 1)
        res.e2e[r.req_id] = e2e
        res.ttft[r.req_id] = ttft
        res.tpot[r.req_id] = tpot
        res.met[r.req_id] = meets_slo(r, e2e, ttft, tpot)

    def decode_round(inst: _Instance):
        """One decode iteration over the instance's active set."""
        if not inst.active:
            return
        b = len(inst.active)
        step = max(model.per_token_decode_time(b, a["accum"])
                   for a in inst.active) * _noise(rng, noise_sigma)
        inst.clock += step
        still = []
        for a in inst.active:
            a["gen"] += 1
            a["accum"] += 1
            a["remaining"] -= 1
            if a["remaining"] <= 0:
                finish(a, inst.clock)
            else:
                still.append(a)
        inst.active = still

    def activate(inst: _Instance, r: Request, gen0: int,
                 ttft0: Optional[float]):
        """Register a freshly (re-)prefilled request as active."""
        lo = r.output_len if r.output_len is not None \
            else r.planning_output_len()
        gen = gen0 + 1                       # prefill emits the next token
        a = {"req": r, "accum": r.input_len + gen, "gen": gen,
             "remaining": max(int(lo), 1) - gen,
             "ttft": ttft0 if ttft0 is not None else inst.clock}
        if a["remaining"] <= 0:              # that token was the last
            finish(a, inst.clock)
        else:
            inst.active.append(a)

    def stage_prefill(inst: _Instance, admitted: List[Request]):
        """Stage the admitted set: each request joins the instance's
        prefilling list (claiming its capacity); the per-tick step plan
        below advances and eventually activates it.  The compute span
        is the unique suffix only (cached prefix aliased), plus any
        preemption-carried tokens (vLLM-style KV recompute)."""
        for r in admitted:
            st = carry.pop(r.req_id, None)
            gen0 = st["gen"] if st else 0
            inst.prefilling.append({
                "req": r, "done": 0,
                "total": r.input_len - cp_of(r) + gen0,
                "gen0": gen0, "ttft0": st["ttft"] if st else None})

    def run_plan(inst: _Instance):
        """Execute one tick's :class:`StepPlan` — the sim twin of
        ``Engine.execute_step``: advance every planned prefill span,
        activate completed prefills, then one decode round over the
        active set (freshly activated requests ride the same tick)."""
        plan = disc.plan_step(
            [(k, p["done"], p["total"])
             for k, p in enumerate(inst.prefilling)],
            range(len(inst.active)))
        pre = plan.prefills
        if pre:
            if disc.chunk_size <= 0:
                # batched whole-prompt prefill: one tick, priced at the
                # max member time; running decodes stall behind it
                inst.clock += max(
                    model.prefill_time(len(pre), it.length)
                    * _noise(rng, noise_sigma) for it in pre)
            else:
                # chunks execute back-to-back within the tick, exactly
                # as the engine's execute_step runs its prefill items
                inst.clock += sum(
                    model.prefill_time(1, it.length)
                    * _noise(rng, noise_sigma) for it in pre)
            done_items = []
            for it in pre:
                p = inst.prefilling[it.ref]
                p["done"] += it.length
                if it.last:
                    done_items.append(p)
            for p in done_items:
                inst.prefilling.remove(p)
                activate(inst, p["req"], p["gen0"], p["ttft0"])
        decode_round(inst)
        return bool(pre)

    def make_view(inst: _Instance, idx: int,
                  pend: Sequence[Request]) -> SchedulerView:
        b = max(len(inst.active), 1)
        return SchedulerView(
            pending=tuple(pend),
            active=tuple(make_active_view(
                a["req"], a["gen"], a["remaining"], a["accum"],
                inst.clock, a["ttft"], arr_of(a["req"]), b, model)
                for a in inst.active),
            now=inst.clock,
            # slots mid-prefill hold capacity: they are neither free
            # nor active (exactly the engine's PREFILLING accounting)
            free=max_batch - len(inst.active) - len(inst.prefilling),
            max_batch=max_batch, instance_id=idx,
            pending_generated=tuple(
                carry.get(r.req_id, {}).get("gen", 0) for r in pend),
            discipline=disc,
            pending_cached=tuple(cp_of(r) for r in pend))

    while True:
        work_left = pending or fi < len(future)
        runnable = [i for i in insts
                    if i.active or i.prefilling or work_left]
        if not runnable:
            break
        inst = min(runnable, key=lambda i: i.clock)
        idx = insts.index(inst)
        # release arrivals up to this (globally earliest) clock
        while fi < len(future) and arr_of(future[fi]) <= inst.clock:
            r = future[fi]
            r.submit_time = arr_of(r)        # executor clock == sim clock
            pending.append(r)
            fi += 1
        progressed = False
        decided = False
        free = max_batch - len(inst.active) - len(inst.prefilling)
        # scheduling event: the policy sees pending AND active state;
        # consulted with no free slot only if it can preempt
        if pending and (free > 0 or (preemptive and inst.active)):
            view = make_view(inst, idx, pending)
            admit, preempt = normalize_decision(pol.decide(view), view)
            decided = True
            # preemption: evict, discard KV, requeue (indices into
            # view.pending stay valid — preempted go to the tail)
            for j in preempt:
                a = inst.active.pop(j)
                rid = a["req"].req_id
                carry[rid] = {"gen": a["gen"], "ttft": a["ttft"]}
                res.preemptions[rid] = res.preemptions.get(rid, 0) + 1
                pending.append(a["req"])
                progressed = True
            free = max_batch - len(inst.active) - len(inst.prefilling)
            sel = admit[:free]
            if sel:
                admitted = [pending[j] for j in sel]
                for j in sorted(sel, reverse=True):
                    pending.pop(j)
                if inter_batch_gap and inst.dispatched \
                        and not inst.active and not inst.prefilling:
                    inst.clock += inter_batch_gap
                stage_prefill(inst, admitted)
                inst.dispatched = True
                progressed = True
        retune = getattr(pol, "retune", None)
        if not decided and retune is not None \
                and (inst.active or inst.prefilling):
            # decide() didn't run this tick (empty queue): let an
            # adaptive policy keep resizing its chunk against the
            # current active set, as the engine loop does
            retune(make_view(inst, idx, ()))
        # one plan tick: prefill spans + a decode round (chunk-as-tick)
        if inst.active or inst.prefilling:
            run_plan(inst)
            progressed = True
        if not progressed:
            if fi < len(future):                  # idle until next arrival
                inst.clock = max(inst.clock, arr_of(future[fi]))
            else:
                raise RuntimeError(
                    "admission stalled: the policy admitted nothing while "
                    "an idle instance had pending requests")
    return res
