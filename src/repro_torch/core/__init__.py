"""The paper's primary contribution: SLO-aware scheduling for LLM inference.

Components: latency predictor (Eqs. 14-19), request profiler, simulated-
annealing priority mapper (Algorithm 1) with two backends — the Python
incremental-Δ annealer (:mod:`repro_torch.core.annealing`) and the jitted
batched annealer (:mod:`repro_torch.core.annealing_torch`, vmapped over tempering
chains and instances; imported lazily so the core stays importable
without touching the JAX runtime) — multi-instance scheduler
(Algorithm 2), objective G (Eq. 2), exhaustive-search oracle, and the
discrete-event execution simulator used by the benchmarks.  See
docs/ARCHITECTURE.md for the layer map and docs/annealer.md for the
annealer internals.

Scheduling API v2 (:mod:`repro_torch.core.policies`): runtime scheduling is
expressed as two composable abstractions shared verbatim by the
discrete-event core (:func:`repro_torch.core.events.simulate`) and the real
serving engine (``Engine.run_policy``):

  * :class:`SchedulingPolicy` — ``decide(view) -> Decision``: sees the
    pending queue *and* the active set (generated/remaining/slack under
    the latency model) and may both admit and **preempt**.  Built-ins:
    :class:`FCFSPolicy`, :class:`PlannedPolicy`,
    :class:`SLOReannealPolicy`, :class:`SLOPreemptPolicy`.
  * :class:`ExecutionDiscipline` — :class:`StallingPrefill` vs
    :class:`ChunkedPrefill` — how admitted prefills interleave with
    running decode rounds.

Both are constructible from string keys via :func:`repro_torch.core.policies.make`
(e.g. ``make("slo-preempt", model=m)``, ``make("chunked:64")``).

Deprecation path: the v1 ``AdmissionPolicy`` (admit-only
``select(pending, now, free, active_count)``) remains importable for one
release; subclasses and duck-typed ``select`` objects are adapted into
the v2 protocol automatically, with a ``DeprecationWarning``.
"""
from repro_torch.core.slo import SLO, Request, as_arrays, meets_slo
from repro_torch.core.latency_model import LinearLatencyModel, PAPER_TABLE2, fit
from repro_torch.core.objective import (IncrementalEvaluator, ScheduleEval,
                                  calculate_g, evaluate, fcfs_schedule,
                                  sorted_by_e2e_schedule)
from repro_torch.core.annealing import (SAParams, SAResult, apply_move,
                                  priority_mapping, propose_move)
from repro_torch.core.exhaustive import exhaustive_search
from repro_torch.core.profiler import (LatencyProfiler, MemoryModel,
                                 OutputLengthPredictor)
from repro_torch.core.policies import (ActiveView, AdaptiveChunkedPrefill,
                                 AdmissionPolicy, ChunkedPrefill, Decision,
                                 DynamicChunkPolicy, ExecutionDiscipline,
                                 FCFSPolicy, IndexPolicy, PlanItem,
                                 PlannedPolicy, SchedulerView,
                                 SchedulingPolicy, SLOPreemptPolicy,
                                 SLOReannealPolicy, StallingPrefill,
                                 StepPlan, as_scheduling_policy,
                                 make, make_discipline)
from repro_torch.core.scheduler import (InstanceQueue, ScheduleOutcome,
                                  SLOAwareScheduler)
from repro_torch.core.events import SimResult, simulate
from repro_torch.core.simulator import (run_fcfs_continuous, run_multi_instance,
                                  run_planned, run_priority_continuous)
from repro_torch.core.online import simulate_online

__all__ = [
    "SLO", "Request", "as_arrays", "meets_slo",
    "LinearLatencyModel", "PAPER_TABLE2", "fit",
    "ScheduleEval", "calculate_g", "evaluate", "fcfs_schedule",
    "sorted_by_e2e_schedule", "IncrementalEvaluator",
    "SAParams", "SAResult", "priority_mapping", "propose_move", "apply_move",
    "exhaustive_search",
    "LatencyProfiler", "MemoryModel", "OutputLengthPredictor",
    "InstanceQueue", "ScheduleOutcome", "SLOAwareScheduler",
    # scheduling API v2
    "SchedulingPolicy", "SchedulerView", "ActiveView", "Decision",
    "FCFSPolicy", "PlannedPolicy", "SLOReannealPolicy", "SLOPreemptPolicy",
    "IndexPolicy", "DynamicChunkPolicy",
    "ExecutionDiscipline", "StallingPrefill", "ChunkedPrefill",
    "AdaptiveChunkedPrefill", "PlanItem", "StepPlan",
    "make", "make_discipline", "as_scheduling_policy",
    # v1 deprecation shim
    "AdmissionPolicy",
    "simulate", "simulate_online",
    "SimResult", "run_fcfs_continuous", "run_multi_instance", "run_planned",
    "run_priority_continuous",
]
