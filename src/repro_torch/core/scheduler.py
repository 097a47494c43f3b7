"""Algorithm 2 — SLO-aware multi-instance scheduling.

Flow (paper §4.4): predict request latencies → assign requests to instances
round-robin by largest remaining memory (Eq. 20 token accounting) →
per-instance priority mapping (Algorithm 1, embarrassingly parallel) →
enqueue → dispatch batches as instances become ready.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.annealing import SAParams, SAResult, priority_mapping
from repro_torch.core.events import SimResult, simulate
from repro_torch.core.latency_model import LinearLatencyModel
from repro_torch.core.objective import evaluate
from repro_torch.core.policies import (ExecutionDiscipline, InstanceState,
                                 MemoryGreedyMapper, PlannedPolicy)
from repro_torch.core.profiler import MemoryModel, OutputLengthPredictor
from repro_torch.core.slo import Request, as_arrays


@dataclasses.dataclass
class InstanceQueue:
    """A priority-ordered queue of planned batches for one LLM instance."""
    instance_id: int
    batches: List[List[Request]] = dataclasses.field(default_factory=list)

    def pop_next_batch(self) -> Optional[List[Request]]:
        return self.batches.pop(0) if self.batches else None

    def __len__(self):
        return sum(len(b) for b in self.batches)


@dataclasses.dataclass
class ScheduleOutcome:
    queues: List[InstanceQueue]
    predicted_G: float
    sa_results: List[SAResult]
    assignment: Dict[int, int]     # req_id -> instance


class SLOAwareScheduler:
    """The decoupled scheduler component.

    Parameters
    ----------
    model : fitted latency predictor (per instance type)
    num_instances : number of LLM serving instances
    max_batch : maximum batch size the service allows
    memory : Eq. 20 memory model (per instance)
    output_predictor : fills Request.predicted_output_len when missing
    mapper : priority-mapping implementation; defaults to the Python
             simulated annealer (Algorithm 1). ``use_jax=True`` switches to
             the jitted parallel-tempering annealer and batches ALL
             instances through one vmapped program
             (``annealing_torch.priority_mapping_multi_torch``);
             ``sa_params.incremental`` picks its incremental-Δ or
             full-evaluate scoring (see docs/annealer.md).
    """

    def __init__(self, model: LinearLatencyModel, num_instances: int = 1,
                 max_batch: int = 8,
                 memory: Optional[MemoryModel] = None,
                 output_predictor: Optional[OutputLengthPredictor] = None,
                 sa_params: Optional[SAParams] = None,
                 use_jax: bool = False, device=None):
        self.model = model
        self.num_instances = num_instances
        self.max_batch = max_batch
        self.memory = memory or MemoryModel(total_memory=float("inf"),
                                            mu=0.9, sigma_per_token=1.0)
        self.output_predictor = output_predictor
        # None sentinel: a module-level SAParams() default would be one
        # shared mutable instance across every scheduler ever constructed
        self.sa_params = sa_params if sa_params is not None else SAParams()
        self.use_jax = use_jax
        self.device = device
        self._jax_cfg = None
        if use_jax:
            # map SAParams onto the jitted annealer's config (one
            # temperature schedule AND one proposal budget for both
            # backends) up front: a jit-unsupported ablation config
            # should fail at construction, not inside schedule()
            from repro_torch.core.annealing_torch import config_from_sa_params
            self._jax_cfg = config_from_sa_params(self.sa_params)

    # ------------------------------------------------ instance assignment
    def assign_instances(self, requests: Sequence[Request]
                         ) -> List[List[Request]]:
        """Round-robin to the instance with the largest remaining memory;
        reset when the fullest instance cannot take the next request.
        Delegates to the shared :class:`~repro_torch.core.policies.
        MemoryGreedyMapper` — the same object the serving
        ``EngineFleet`` can route through — so simulation and real
        serving assign by one code path."""
        states = [InstanceState(instance_id=i)
                  for i in range(self.num_instances)]
        assign = MemoryGreedyMapper(self.memory).map_batch(requests, states)
        buckets: List[List[Request]] = [[] for _ in range(self.num_instances)]
        for req, inst in zip(requests, assign):
            buckets[inst].append(req)
        return buckets

    # ------------------------------------------------ main entry
    def schedule(self, requests: Sequence[Request]) -> ScheduleOutcome:
        requests = list(requests)
        for r in requests:
            if r.predicted_output_len is None:
                if self.output_predictor is not None:
                    r.predicted_output_len = self.output_predictor.predict(
                        r.task_type)
                elif r.output_len is not None:
                    r.predicted_output_len = r.output_len
        buckets = self.assign_instances(requests)
        arrays_of = [as_arrays(b) if b else None for b in buckets]
        jax_results = None
        if self.use_jax:
            # ONE jitted program anneals every instance: vmap over
            # (instances × chains) with ragged loads padded and masked
            from repro_torch.core.annealing_torch import priority_mapping_multi_torch
            jax_results = iter(priority_mapping_multi_torch(
                [a for a in arrays_of if a is not None], self.model,
                self.max_batch, self._jax_cfg, seed=self.sa_params.seed,
                incremental=self.sa_params.incremental, device=self.device))
        queues, sa_results = [], []
        assignment = {}
        g_num, g_den = 0.0, 0.0
        for inst, bucket in enumerate(buckets):
            q = InstanceQueue(inst)
            if bucket:
                arrays = arrays_of[inst]
                if jax_results is not None:
                    res = SAResult(*next(jax_results), -1, False)
                else:
                    res = priority_mapping(arrays, self.model,
                                           self.max_batch, self.sa_params)
                sa_results.append(res)
                ev = evaluate(arrays, self.model, res.perm, res.batch_id)
                g_num += ev.n_met
                g_den += ev.total_latency
                nb = int(res.batch_id[-1]) + 1
                for b in range(nb):
                    members = [bucket[i] for i, bi in
                               zip(res.perm, res.batch_id) if bi == b]
                    q.batches.append(members)
                for r in bucket:
                    assignment[r.req_id] = inst
            queues.append(q)
        return ScheduleOutcome(
            queues=queues,
            predicted_G=g_num / g_den if g_den else 0.0,
            sa_results=sa_results,
            assignment=assignment,
        )

    # ------------------------------------------------ plan evaluation
    def evaluate_plan(self, outcome: ScheduleOutcome,
                      discipline: "str | ExecutionDiscipline | None" = None,
                      noise_sigma: float = 0.0,
                      seed: int = 0) -> SimResult:
        """Execute a planned schedule through the discrete-event core
        under a chosen :class:`ExecutionDiscipline` — so a plan can be
        scored under stalling *and* chunked prefill before dispatching
        it to real engines.  Returns the merged multi-instance result."""
        out = SimResult({}, {}, {}, {})
        for q in outcome.queues:
            if not q.batches:
                continue
            ordered = [r for b in q.batches for r in b]
            rng = np.random.default_rng(seed + 1000 * q.instance_id)
            out = out.merged_with(simulate(
                ordered, self.model, self.max_batch,
                PlannedPolicy(q.batches), respect_arrivals=False,
                noise_sigma=noise_sigma, rng=rng, discipline=discipline))
        return out
