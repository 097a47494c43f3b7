"""Data-parallel serving: N engines behind one thread-safe front door.

:class:`EngineFleet` runs one
:class:`~repro_torch.serving.loop.ServeLoop` per engine and routes
arrivals through a registry
:class:`~repro_torch.core.policies.InstanceMapper` — the same objects
the multi-instance scheduler (``SLOAwareScheduler.assign_instances``)
and the simulator's ``run_multi_instance`` use, so Algorithm 2's
instance assignment runs unchanged against real engines.

Two submission modes:

* **Online** — :meth:`submit` routes each arrival as it comes, against a
  live :class:`~repro_torch.core.policies.InstanceState` snapshot of every
  loop (queue depth, occupied slots, KV-pool headroom).  This is the
  least-loaded / SLO-affinity regime.
* **Batch-planned** — :meth:`submit_trace` hands the whole trace to
  ``mapper.plan``: a planning mapper both *assigns* requests to
  instances and may *order* each instance's queue.  The fleet submits in
  exactly that order; each loop's arrival-stable ingestion turns the
  plan into its FCFS admission order.  ``route:annealed`` is the paper's
  Algorithm 2: memory-greedy assignment, then every instance's queue
  annealed by the batched annealer in one launch on the engines'
  device.

Every loop gets a disjoint request-id range (``id_base``), so results,
streams and the aggregated
:class:`~repro_torch.serving.metrics.ServingMetrics` share one
namespace. ``serve()`` ticks the loops in turn on the calling thread.
On the card each loop queues its device work on a CUDA stream of its
own, so its rounds run while the host ticks the other loops, and one
loop's readback and prefill never wait for another loop's rounds.  One
thread, not one per loop: an eager decode round is thousands of PyTorch
calls, each of which releases and retakes the interpreter lock, so loops
in threads hand the lock over at every call.  Either way the loops share
one host: while the decode round is bound by the host's dispatch
(``PERF.md`` §5), a fleet on one card serves no faster than one loop,
and each of its loops ticks more slowly than a loop alone.  Engines on
one card may share one params dict: the serving steps only read the
weights.

Tensor-parallel engines (``Engine(mesh=...)``) join a fleet when they
share one mesh, the reference's layout of several instances on one tp
group: rank 0 runs the fleet (the mapper, an annealed plan on rank 0's
device, every loop's ticks) while each other rank's ``Engine.follow``
replays every engine's steps, and :meth:`EngineFleet.close` stops them.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Sequence

from repro_torch.core.latency_model import LinearLatencyModel
from repro_torch.core.policies import InstanceState, make_mapper
from repro_torch.core.slo import SLO, Request
from repro_torch.engine.engine import Engine
from repro_torch.serving.loop import ServeLoop
from repro_torch.serving.metrics import ServingMetrics
from repro_torch.serving.stream import TokenStream

# disjoint per-loop request-id ranges (see ServeLoop id_base)
_ID_STRIDE = 1_000_000


class EngineFleet:
    """N serving loops behind one submission queue.

    Parameters
    ----------
    engines:
        Fresh engines, one per instance (their pools become the fleet's
        capacity).
    policy / model / discipline / overlap:
        Forwarded to every member :class:`ServeLoop`.
    mapper:
        :class:`~repro_torch.core.policies.InstanceMapper` instance or
        registry key (``"least-loaded"`` default, ``"round-robin"``,
        ``"slo-affinity"``, ``"memory-greedy"``, ``"annealed"``) —
        mapper kwargs (``model=...``) ride through ``make_mapper``; the
        annealed mapper anneals on the first engine's device unless
        ``device=`` says otherwise.
    """

    def __init__(self, engines: Sequence[Engine], policy="fcfs", *,
                 mapper="least-loaded",
                 model: Optional[LinearLatencyModel] = None,
                 discipline=None, overlap: bool = True, **mapper_kw):
        if not engines:
            raise ValueError("EngineFleet needs at least one engine")
        meshes = {id(eng.mesh) for eng in engines}
        if len(meshes) > 1 and any(eng.mesh is not None
                                   and eng.mesh.size > 1 for eng in engines):
            # the other ranks' follow() replays the engines of one mesh:
            # engines on different meshes have no counterpart in the
            # reference (its engines on a data axis run the same step)
            raise NotImplementedError("a fleet of engines on different "
                                      "meshes has no counterpart in the "
                                      "reference (ROADMAP M11b)")
        if engines[0].mesh is not None and engines[0].mesh.rank != 0:
            raise RuntimeError("rank 0 runs the fleet; the other ranks of "
                               "its mesh call Engine.follow()")
        self.loops: List[ServeLoop] = [
            ServeLoop(eng, policy, model=model, discipline=discipline,
                      overlap=overlap, id_base=i * _ID_STRIDE)
            for i, eng in enumerate(engines)]
        mapper_kw.setdefault("device", engines[0].device)
        self.mapper = make_mapper(mapper, model=model, **mapper_kw)
        self._lock = threading.Lock()

    def __len__(self):
        return len(self.loops)

    # ------------------------------------------------------------ routing
    def _states(self) -> List[InstanceState]:
        """Live load snapshot of every loop, for the mapper."""
        out = []
        for i, lp in enumerate(self.loops):
            eng = lp.eng
            with lp._lock:
                queued = len(lp._inbox)
            queued += len(lp._future) + len(lp._waiting)
            active = sum(not f for f in eng.slot_free)
            toks = sum(rt.input_len + len(rt.generated)
                       for rt in eng.slot_req if rt is not None)
            out.append(InstanceState(
                instance_id=i, queue_depth=queued, active=active,
                free_slots=len(eng.free_slots()),
                free_blocks=eng.pool.available if eng.paged else 0,
                active_tokens=toks))
        return out

    # --------------------------------------------------------- submission
    def submit(self, prompt_tokens, *, max_new_tokens: int,
               slo: Optional[SLO] = None, task_type: str = "chat",
               arrival_time: Optional[float] = None,
               request: Optional[Request] = None,
               on_token=None) -> TokenStream:
        """Route one arrival to an instance and enqueue it there
        (thread-safe; same signature as :meth:`ServeLoop.submit`)."""
        if request is None:
            request = Request(
                req_id=-1, task_type=task_type, input_len=len(prompt_tokens),
                slo=slo if slo is not None else SLO(),
                output_len=max_new_tokens,
                arrival_time=arrival_time if arrival_time is not None
                else 0.0)
        with self._lock:       # mapper state (round-robin cursor, homes)
            inst = self.mapper.map_one(request, self._states())
        return self.loops[inst].submit(
            prompt_tokens, max_new_tokens=max_new_tokens,
            arrival_time=arrival_time, request=request, on_token=on_token)

    def submit_trace(self, pairs) -> List[TokenStream]:
        """Plan a whole ``[(Request, prompt_tokens)]`` trace through the
        mapper and submit each instance's queue in plan order (see
        module docstring: a planning mapper's per-instance order becomes
        that engine's admission order).  Returns streams in the original
        trace order."""
        pairs = list(pairs)
        reqs = [r for r, _ in pairs]
        with self._lock:
            plan = self.mapper.plan(reqs, self._states())
        streams: Dict[int, TokenStream] = {}
        for inst, order in enumerate(plan):
            for i in order:
                r, toks = pairs[i]
                streams[i] = self.loops[inst].submit(
                    toks, max_new_tokens=r.planning_output_len(), request=r)
        return [streams[i] for i in range(len(pairs))]

    # ----------------------------------------------------------- serving
    def start(self, warm_lengths: Sequence[int] = ()):
        """Warm every member loop, then stamp one shared epoch — if each
        loop stamped its own at warm time, loop 0's clock would run for
        the whole of loop 1..N's compile warm-up and every early arrival
        would be charged seconds of phantom waiting."""
        fresh = [lp for lp in self.loops if lp._t0 is None]
        for lp in fresh:
            lp.start(warm_lengths)
        t0 = time.perf_counter()
        for lp in fresh:
            lp._t0 = t0
        return self

    def serve(self, poll: float = 0.0002) -> Dict[int, dict]:
        """Drive every loop to completion, ticking each unfinished loop
        in turn, and sleeping only while all of them are idle; returns
        the merged result dict (disjoint request-id ranges)."""
        self.start()
        while True:
            live = [lp for lp in self.loops if not lp._done()]
            if not live:
                return self.results()
            for lp in live:
                lp.tick()
            if all(lp._idle() for lp in live):
                wait = min(lp._idle_wait(poll) for lp in live)
                if wait > 0:
                    time.sleep(wait)

    def close(self):
        """Stop every engine on the other ranks of its mesh
        (``Engine.close``); nothing for engines without one."""
        for lp in self.loops:
            lp.eng.close()

    # ------------------------------------------------------------ output
    def results(self) -> Dict[int, dict]:
        out: Dict[int, dict] = {}
        for lp in self.loops:
            out.update(lp.results())
        return out

    def streams(self) -> Dict[int, TokenStream]:
        out: Dict[int, TokenStream] = {}
        for lp in self.loops:
            out.update(lp.streams())
        return out

    @property
    def metrics(self) -> ServingMetrics:
        """Fleet-wide aggregated metrics (union of per-loop sinks)."""
        return ServingMetrics.aggregate([lp.metrics for lp in self.loops])
