"""Offline execution wrappers over the unified discrete-event core.

Benchmarks compare scheduling policies by *executing* schedules against
actual output lengths (the planner only saw predictions) using the fitted
latency model plus optional multiplicative noise — mirroring the paper's
experimental gap between predicted and measured latencies.

All execution loops live in :mod:`repro_torch.core.events` (one token-granular
simulator, engine-faithful first-token accounting); this module keeps the
historical entry points as thin wrappers:

  * ``run_planned``  — the SLO-aware lock-step path: the scheduler's
    batches run sequentially per instance (a batch is admitted together
    and the next batch waits until the previous one drained).
  * ``run_priority_continuous`` — planned priority order fed to a
    continuously-batching engine (the paper's actual dispatch, §5.1).
  * ``run_fcfs_continuous`` — the vLLM-like FCFS baseline.
  * ``run_multi_instance`` — planned batches across parallel instances.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from repro_torch.core.events import (AdmissionPolicy, FCFSPolicy,  # noqa: F401
                               PlannedPolicy, SimResult,
                               SLOReannealPolicy, simulate)
from repro_torch.core.latency_model import LinearLatencyModel
from repro_torch.core.policies import ExecutionDiscipline
from repro_torch.core.slo import Request


def run_planned(batches: Sequence[Sequence[Request]],
                model: LinearLatencyModel,
                noise_sigma: float = 0.0,
                rng: Optional[np.random.Generator] = None,
                inter_batch_gap: float = 1e-4,
                discipline: "str | ExecutionDiscipline | None" = None
                ) -> SimResult:
    """Execute planned batches sequentially on one instance."""
    batches = [list(b) for b in batches if len(b)]
    ordered = [r for b in batches for r in b]
    max_batch = max((len(b) for b in batches), default=1)
    return simulate(ordered, model, max_batch, PlannedPolicy(batches),
                    noise_sigma=noise_sigma, rng=rng,
                    respect_arrivals=False, inter_batch_gap=inter_batch_gap,
                    discipline=discipline)


def run_multi_instance(queues, model: LinearLatencyModel,
                       noise_sigma: float = 0.0,
                       seed: int = 0) -> SimResult:
    """Instances run in parallel; each executes its planned batches."""
    out = SimResult({}, {}, {}, {})
    for q in queues:
        rng = np.random.default_rng(seed + 1000 * q.instance_id)
        out = out.merged_with(
            run_planned(q.batches, model, noise_sigma, rng))
    return out


def run_priority_continuous(batches: Sequence[Sequence[Request]],
                            model: LinearLatencyModel,
                            max_batch: int,
                            noise_sigma: float = 0.0,
                            rng: Optional[np.random.Generator] = None
                            ) -> SimResult:
    """Execute an SLO-aware plan the way the paper does (§5.1): batches are
    *submitted* in priority order 0.1 ms apart, but the engine continuously
    admits from the queue as slots free up — i.e. continuous batching with
    the planned priority order as the arrival order."""
    ordered = [r for batch in batches for r in batch]
    return run_fcfs_continuous(ordered, model, max_batch,
                               noise_sigma=noise_sigma, rng=rng)


def run_fcfs_continuous(requests: Sequence[Request],
                        model: LinearLatencyModel,
                        max_batch: int,
                        noise_sigma: float = 0.0,
                        rng: Optional[np.random.Generator] = None
                        ) -> SimResult:
    """vLLM-like FCFS + continuous batching baseline on one instance."""
    return simulate(requests, model, max_batch, "fcfs",
                    noise_sigma=noise_sigma, rng=rng,
                    respect_arrivals=False)
