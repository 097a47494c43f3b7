"""Online SLO-aware scheduling (beyond-paper extension).

The paper schedules a static request pool.  Real services see arrivals
over time; whenever an instance frees a slot (or new requests arrive while
slots are free), the waiting queue is RE-ANNEALED with Algorithm 1 —
deadline slack shrinks as requests wait, so priorities must be recomputed.
The incremental-Δ annealer (``objective.IncrementalEvaluator``) makes this
cheap enough to run at every admission event.

The execution loop lives in :mod:`repro_torch.core.events` (the unified
discrete-event core): ``simulate_online`` is a thin wrapper that picks the
scheduling policy (v2 API — ``"slo"`` re-anneal, ``"slo-preempt"``
multi-SLO preemption, or ``"fcfs"``), optionally an execution discipline
(``"stall"`` / ``"chunked:N"``), and — new with the unified core — can
spread arrivals over ``num_instances`` parallel instances draining one
shared queue.
"""
from __future__ import annotations

from typing import Optional, Sequence, Union

from repro_torch.core.annealing import SAParams
from repro_torch.core.events import (FCFSPolicy, SimResult,  # noqa: F401
                               SLOReannealPolicy, simulate)
from repro_torch.core.latency_model import LinearLatencyModel
from repro_torch.core.policies import (ExecutionDiscipline, SchedulingPolicy,
                                 make)
from repro_torch.core.slo import Request

_ALIASES = {"slo": "slo-reanneal"}


def simulate_online(requests: Sequence[Request], model: LinearLatencyModel,
                    max_batch: int,
                    policy: Union[str, SchedulingPolicy] = "slo",
                    sa_params: Optional[SAParams] = None,
                    reanneal_min_queue: int = 2,
                    num_instances: int = 1,
                    discipline: Union[str, ExecutionDiscipline,
                                      None] = None) -> SimResult:
    """policy: "slo" (re-annealed priorities), "slo-preempt" (multi-SLO
    preemption), "fcfs", or any :class:`SchedulingPolicy` object.

    Requests carry ``arrival_time``; metrics are relative to arrival.
    """
    if isinstance(policy, str):
        policy = make(_ALIASES.get(policy, policy), model=model,
                      max_batch=max_batch,
                      sa_params=sa_params if sa_params is not None
                      else SAParams(seed=0),
                      min_queue=reanneal_min_queue)
    return simulate(requests, model, max_batch, policy,
                    num_instances=num_instances, respect_arrivals=True,
                    discipline=discipline)
