"""Async streaming serving loop: overlapped host scheduling + device
execution over the slot-pool engine.

Everything before this module was batch-oriented — ``Engine.run_policy``
consumes a fixed workload list and syncs the device every step, so
host-side scheduling (annealing, admission, block accounting) serializes
with execution and latency is charged on the engine's step-time clock.
:class:`ServeLoop` turns the same engine into a long-running service:

* **Submission + arrival-timed ingestion** — ``submit()`` enqueues a
  request (thread-safe) with an optional future ``arrival_time``; the
  loop releases it into the waiting queue once that instant passes on
  the wall clock, so Poisson traces replay in real time.
* **Token streaming** — every generated token is delivered through the
  request's :class:`~repro_torch.serving.stream.TokenStream` with a
  wall-clock timestamp: TTFT / TBT / e2e are *measured at the delivery
  boundary*, exactly what a streaming client observes.
* **Overlapped execution** (``overlap=True``) — decode round ``N+1`` is
  dispatched from device-resident token state *before* round ``N``'s
  sampled ids are read back (the engine's fused decode+sample keeps them
  on device; each round's ids are copied to pinned host memory behind it,
  and reading them back waits on that round's event alone). While the
  device computes, the host delivers round ``N-1``'s tokens, runs the
  scheduling policy, updates block accounting and the prefix index. One
  decode round of lookahead means host state lags the device by at most
  one round; a request that finishes mid-lookahead has its overshoot
  token dropped at readback (identity-guarded delivery), and requests
  whose output budget is provably exhausted are excluded from the next
  dispatch up front, so greedy decoding is token-for-token identical to
  the synchronous mode.
* **A stream of its own** (on the card) — the loop queues its decode
  rounds, prefills and readback copies on a CUDA stream it owns, so a
  ticket's event and a prefill's synchronize wait for this loop's work
  only, never for another loop's rounds on the same card
  (:class:`~repro_torch.serving.fleet.EngineFleet`).
* **Pow-2 batch buckets** (paged engines) — each round is dispatched
  over the smallest power-of-two slot prefix covering every active
  slot, so arrival jitter changes the batch shape only at bucket
  boundaries (at most ``log2(max_slots) + 1`` shapes, each warmed in
  ``start()``); a dense engine always runs its whole pool.
* **Chunk-as-tick prefill** — every tick executes the active
  :class:`~repro_torch.core.policies.ExecutionDiscipline`'s ``StepPlan``:
  staged admissions (``Engine.begin_prefill``) advance chunk-by-chunk
  under ``ChunkedPrefill(n)`` / ``dynamic-chunk`` while the running
  decode round dispatches in the same tick, so a long prompt no longer
  stalls streaming TBT for its whole prefill.  ``StallingPrefill``
  (default) completes each prefill within its admission tick.

The scheduling brain is unchanged: the same v2
:class:`~repro_torch.core.policies.SchedulingPolicy` objects drive
admission and preemption through :meth:`Engine.build_view`, with SLO budgets
shifted by true wall-clock waiting.
"""
from __future__ import annotations

import contextlib
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.latency_model import LinearLatencyModel
from repro_torch.core.policies import (ChunkedPrefill, make_discipline,
                                       normalize_decision, resolve_policy)
from repro_torch.core.slo import SLO, Request
from repro_torch.engine.engine import Engine, _bucket
from repro_torch.engine.request import Phase, RuntimeRequest
from repro_torch.serving.metrics import (RequestTimeline,
                                         ServingMetrics, StepGauge)
from repro_torch.serving.stream import TokenStream


class UnsupportedDisciplineError(NotImplementedError):
    """The requested discipline cannot run on this engine.  Since the
    step-planner refactor the streaming loop executes chunked and
    adaptive disciplines natively (prefill chunks ride the tick plan
    alongside decode dispatches), so this is raised only for the one
    genuinely unsupported combination: chunked prefill on an MLA arch,
    which has no chunked forward path.  Subclassing
    ``NotImplementedError`` keeps pre-existing callers' handlers
    working."""


class _Ticket:
    """One in-flight decode round: the host copy of its sampled ids (and
    on the card the event that marks the copy done) plus the (slot,
    request, expected-index) participants recorded at dispatch time.
    Identity-guarded consumption: a participant whose request finished,
    was preempted, or whose slot was reassigned while the round was in
    flight has its token dropped."""

    __slots__ = ("host", "done", "parts", "width", "t_dispatch")

    def __init__(self, host, done, parts, width, t_dispatch):
        self.host = host
        self.done: Optional[torch.cuda.Event] = done
        self.parts: List[Tuple[int, RuntimeRequest, int]] = parts
        self.width = width
        self.t_dispatch = t_dispatch


def _queue_readback(toks: torch.Tensor):
    """Queue the copy of one round's sampled ids to the host, returning
    ``(host tensor, event or None)``.  On the card the copy goes into
    pinned memory without blocking and the event is recorded right
    behind it on the current stream (the loop's own), so waiting on the
    event waits for this round only: a plain ``.cpu()`` issued once the
    next round is queued on the same stream would wait for that round
    too and undo the overlap.  On the CPU the ids are already computed:
    a plain copy."""
    if toks.device.type != "cuda":
        return toks.clone(), None
    host = torch.empty(toks.shape, dtype=toks.dtype, pin_memory=True)
    host.copy_(toks, non_blocking=True)
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(toks.device))
    return host, done


class ServeLoop:
    """Long-running streaming serving loop over an :class:`Engine`.

    Parameters
    ----------
    engine:
        A fresh engine (its slot pool and KV pool become the service's).
    policy:
        v2 policy object or any ``repro_torch.core.policies.make`` registry
        key (``"fcfs"``, ``"slo-reanneal"``, ``"slo-preempt"``…).
    model:
        Latency model for slack/budget projections (policies that carry
        their own are used as fallback).
    discipline:
        :class:`~repro_torch.core.policies.ExecutionDiscipline` or registry
        key (``"stall"``, ``"chunked:32"``).  Default resolution
        matches ``Engine.run_policy``: the policy's own discipline
        (``dynamic-chunk``), else the engine's ``chunked_prefill``
        setting, else stalling whole-prompt prefill.  Chunked on an MLA
        arch raises :class:`UnsupportedDisciplineError`.
    overlap:
        Dispatch round ``N+1`` before syncing round ``N`` (one-step
        lookahead).  ``False`` = synchronous reference mode: identical
        code path, but every round is read back immediately.
    id_base:
        Starting request id — fleet members get disjoint ranges so one
        aggregated metrics/result namespace never collides.
    """

    def __init__(self, engine: Engine, policy="fcfs", *,
                 model: Optional[LinearLatencyModel] = None,
                 discipline=None, overlap: bool = True,
                 metrics: Optional[ServingMetrics] = None,
                 id_base: int = 0):
        self.eng = engine
        # a policy built here anneals (slo-reanneal:jax) on the engine's
        # device
        self.pol, self.preemptive = resolve_policy(
            policy, model=model, max_batch=engine.max_slots,
            device=engine.device)
        self.model = model if model is not None \
            else getattr(self.pol, "model", None)
        if discipline is None:
            # same resolution as Engine.run_policy: a policy carrying
            # its own discipline (dynamic-chunk) wins, then the
            # engine's chunked_prefill default — object identity is
            # preserved so adaptive retuning reaches the tick planner
            discipline = getattr(self.pol, "discipline", None)
        if discipline is None and engine.chunked_prefill:
            discipline = ChunkedPrefill(engine.chunked_prefill)
        self.disc = make_discipline(discipline)
        if self.disc.chunk_size and engine.cfg.mla is not None:
            raise UnsupportedDisciplineError(
                f"{self.disc!r} is unsupported for MLA archs (no "
                "chunked forward path); use whole-prompt (stalling) "
                "prefill")
        self.overlap = overlap
        # the loop's device work goes to a stream of its own (see the
        # module docstring); on the CPU there is none
        self._stream = torch.cuda.Stream(engine.device) \
            if engine.device.type == "cuda" else None
        self.metrics = metrics if metrics is not None else ServingMetrics()

        self._lock = threading.Lock()
        self._inbox: deque = deque()         # submitted, not yet ingested
        self._future: List[RuntimeRequest] = []   # ingested, arrival ahead
        self._waiting: List[RuntimeRequest] = []
        self._streams: Dict[int, TokenStream] = {}
        self._requests: Dict[int, RuntimeRequest] = {}
        self._inflight: Optional[_Ticket] = None
        self._feed = None                    # [max_slots, 1] device ids
        self._t0: Optional[float] = None
        # id_base offsets request ids so loops sharing a fleet-wide
        # metrics/result namespace never collide
        self._next_id = id_base
        self._stall_spins = 0
        self._stopped = False

    # ------------------------------------------------------------- clock
    def now(self) -> float:
        """Wall-clock seconds since ``start()``."""
        if self._t0 is None:
            raise RuntimeError("loop not started")
        return time.perf_counter() - self._t0

    def _on_stream(self):
        """Context that makes the loop's own stream current."""
        if self._stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self._stream)

    # ------------------------------------------------------------ warmup
    def start(self, warm_lengths: Sequence[int] = ()):
        """Warm the dispatch buckets (and optionally the prefill length
        buckets a trace will hit) and stamp the epoch.  Warm-up (kernel
        builds and loads, first allocations of each shape) runs *before*
        the clock starts so it never pollutes measured TTFT/TBT."""
        if self._t0 is not None:
            return self
        if self._stream is not None:
            # the pools were filled on the stream current at engine
            # construction: this loop's stream starts behind that work
            self._stream.wait_stream(torch.cuda.current_stream(
                self.eng.device))
        with self._on_stream():
            self._warm_buckets(warm_lengths)
        self._t0 = time.perf_counter()
        return self

    def _warm_buckets(self, warm_lengths: Sequence[int]):
        eng = self.eng
        if self._feed is None:
            self._feed = torch.zeros((eng.max_slots, 1),
                                     dtype=torch.int32, device=eng.device)
        widths = {eng.max_slots}
        if eng.paged:
            w = 1
            while w <= eng.max_slots:
                widths.add(min(w, eng.max_slots))
                w *= 2
        idle = np.zeros(eng.max_slots, bool)
        for w in sorted(widths):
            eng.dispatch_decode(self._feed, idle, width=w)
        exact = bool(eng.cfg.ssm_layers)     # SSM archs prefill unpadded
        for n in sorted({int(n) if exact else _bucket(int(n))
                         for n in warm_lengths}):
            if n >= eng.max_seq_len:
                continue
            toks = torch.zeros((1, n), dtype=torch.int32,
                               device=eng.device)
            if eng.paged:
                eng._warm_up(("prefill", n), eng._prefill_step, toks, n, 0)
            else:
                eng._warm_up(("prefill", n),
                             lambda _s, t, n=n: eng._prefill_one(t, n),
                             toks)
        # chunked disciplines: pre-warm the chunk buckets a plan can hit
        # (every pow-2 bucket up to the largest chunk, so ragged final
        # chunks are covered too).  Adaptive policies may retune up to
        # their max_chunk.
        C = self.disc.chunk_size
        if C and eng.paged:
            hi = _bucket(max(C, getattr(self.pol, "max_chunk", C)))
            L = 16
            while L <= hi and L < eng.max_seq_len:
                toks = torch.zeros((1, L), dtype=torch.int32,
                                   device=eng.device)
                eng._warm_up(("chunk", L), eng._chunk_step, toks, 0, L)
                L *= 2

    # -------------------------------------------------------- submission
    def submit(self, prompt_tokens, *, max_new_tokens: int,
               slo: Optional[SLO] = None, task_type: str = "chat",
               arrival_time: Optional[float] = None,
               request: Optional[Request] = None,
               on_token=None) -> TokenStream:
        """Enqueue one request (thread-safe) and return its token stream.

        ``arrival_time`` (loop-relative seconds) schedules a future
        arrival — trace replay submits the whole workload up front and
        the loop releases each request when its instant passes on the
        wall clock.  ``None`` = arrive immediately.  ``request`` passes
        a pre-built :class:`Request` (its ``arrival_time`` is used when
        the kwarg is None)."""
        prompt = np.asarray(prompt_tokens, np.int32)
        with self._lock:
            rid = self._next_id
            self._next_id += 1
        if request is None:
            request = Request(
                req_id=rid, task_type=task_type, input_len=len(prompt),
                slo=slo if slo is not None else SLO(),
                output_len=max_new_tokens,
                arrival_time=arrival_time if arrival_time is not None
                else 0.0)
        else:
            request.req_id = rid
            if arrival_time is not None:
                request.arrival_time = arrival_time
        rt = RuntimeRequest(request=request, prompt_tokens=prompt,
                            max_new_tokens=int(max_new_tokens))
        stream = TokenStream(rid, on_token=on_token)
        with self._lock:
            self._streams[rid] = stream
            self._requests[rid] = rt
            self._inbox.append(rt)
        return stream

    def submit_trace(self, pairs) -> List[TokenStream]:
        """Submit a ``[(Request, prompt_tokens)]`` trace (the
        ``data.synthetic`` token-workload format) for wall-clock
        replay."""
        return [self.submit(toks, max_new_tokens=r.planning_output_len(),
                            request=r) for r, toks in pairs]

    # --------------------------------------------------------- ingestion
    def _reject(self, rt: RuntimeRequest, reason: str, t: float):
        stream = self._streams[rt.req_id]
        stream.submit_time = t
        stream.fail(reason, t)
        self.metrics.on_finish(rt.request, RequestTimeline(
            req_id=rt.req_id, task_type=rt.request.task_type,
            arrival=rt.request.arrival_time, submit=t, first_token=None,
            finish=None, n_tokens=0, tbt=[], rejected=True))

    def _ingest(self, t: float):
        """Move submissions into the arrival schedule, and release every
        request whose arrival instant has passed into the waiting
        queue — stamping ``submit_time`` on the loop clock so policy
        budget shifting sees true wall waiting."""
        with self._lock:
            newly = list(self._inbox)
            self._inbox.clear()
        for rt in newly:
            eng = self.eng
            if rt.input_len >= eng.max_seq_len:
                self._reject(rt, f"prompt length {rt.input_len} >= "
                                 f"max_seq_len {eng.max_seq_len}", t)
            elif eng.paged and eng._blocks_needed(rt) > eng.pool.total:
                self._reject(rt, f"needs {eng._blocks_needed(rt)} KV "
                                 f"blocks, pool holds {eng.pool.total}", t)
            else:
                self._future.append(rt)
        if newly:
            self._future.sort(key=lambda rt: rt.request.arrival_time)
        while self._future and self._future[0].request.arrival_time <= t:
            rt = self._future.pop(0)
            # queueing from the true arrival instant counts toward
            # budgets — a request that arrived mid-step waited too
            rt.submit_time = min(rt.request.arrival_time, t)
            rt.request.submit_time = rt.submit_time
            self._streams[rt.req_id].submit_time = rt.submit_time
            self._waiting.append(rt)

    # -------------------------------------------------------- scheduling
    def _retune(self):
        """Let an adaptive policy resize its chunk against the current
        active set on ticks where ``decide()`` doesn't run (empty
        queue) — same hook as the batch loop and the event core."""
        fn = getattr(self.pol, "retune", None)
        if fn is not None and not all(self.eng.slot_free):
            fn(self.eng.build_view([], self.disc, self.model))

    def _schedule(self):
        """One policy decision over the live view: preempt, then reserve
        blocks and *stage* admissions (``begin_prefill``).  The staged
        prefills advance through the tick plan in :meth:`tick` — whole-
        prompt in one tick under stall, chunk-by-chunk alongside decode
        dispatches under a chunked discipline."""
        eng = self.eng
        if not self._waiting:
            self._retune()
            return False
        free = eng.free_slots()
        if not free and not (self.preemptive and not all(eng.slot_free)):
            self._retune()
            return False
        view = eng.build_view(self._waiting, self.disc, self.model)
        admit, preempt = normalize_decision(self.pol.decide(view), view)
        active_rts = eng.active_requests()
        did = False
        for j in preempt:
            vict = active_rts[j]
            # re-prefill must fit: prompt + generated + next token
            if vict.input_len + len(vict.generated) + 1 >= eng.max_seq_len:
                continue
            eng.preempt(vict)
            self._waiting.append(vict)       # view indices stay valid
            did = True
        free = eng.free_slots()
        sel = []
        for j in admit:
            if len(sel) >= len(free):
                break
            # reserve atomically (alias cached prefix + alloc the rest)
            # so same-tick admissions never race a probe against a later
            # allocation
            if eng.paged and not eng._reserve_blocks(self._waiting[j]):
                continue                     # out of KV blocks: wait
            sel.append(j)
        chosen = [self._waiting[j] for j in sel]
        for j in sorted(sel, reverse=True):
            self._waiting.pop(j)
        for rt, slot in zip(chosen, free):
            # stage only: the prefill runs via this tick's plan below
            eng.begin_prefill(rt, slot)
            did = True
        return did

    def _after_prefill(self, rt: RuntimeRequest):
        """Deliver the token(s) a synchronous prefill produced (one, or
        the catch-up after a preemption re-prefill) and seed the device
        feed for the next decode round."""
        t = self.now()
        stream = self._streams[rt.req_id]
        for idx in range(len(stream.events), len(rt.generated)):
            stream.push(rt.generated[idx], t)
        if rt.phase is Phase.FINISHED:       # finished at prefill
            self._finish(rt, t, slot_done=True)
        else:
            self._feed[rt.slot, 0] = rt.generated[-1]

    # ---------------------------------------------------------- dispatch
    def _inflight_count(self, rt: RuntimeRequest) -> int:
        """Decode rounds in flight for ``rt`` (0 or 1): its host token
        count lags the device by this many tokens."""
        if self._inflight is None:
            return 0
        return sum(1 for s, r, i in self._inflight.parts
                   if r is rt and i == len(rt.generated))

    def _dispatch_round(self) -> Optional[_Ticket]:
        """Dispatch one fused decode+sample round over the active slots
        (minus requests whose output budget is provably exhausted after
        the in-flight round) without waiting for it."""
        eng = self.eng
        parts: List[Tuple[int, RuntimeRequest, int]] = []
        active = np.zeros(eng.max_slots, bool)
        for slot, rt in enumerate(eng.slot_req):
            if rt is None or rt.phase is not Phase.RUNNING:
                continue
            ahead = self._inflight_count(rt)
            if len(rt.generated) + ahead >= rt.max_new_tokens:
                continue                     # will finish at readback
            active[slot] = True
            parts.append((slot, rt, len(rt.generated) + ahead))
        if not parts:
            return None
        width = eng.max_slots
        if eng.paged:
            width = min(_bucket(max(s for s, _, _ in parts) + 1, lo=1),
                        eng.max_slots)
        toks = eng.dispatch_decode(
            self._feed, active, width=width,
            lookahead=1 if self._inflight is not None else 0)
        self._feed[:width, 0] = toks
        host, done = _queue_readback(toks)
        return _Ticket(host, done, parts, width, self.now())

    # ----------------------------------------------------------- consume
    def _consume(self, ticket: _Ticket):
        """Read back one round's sampled ids (waiting for that round's
        copy only) and deliver them with wall timestamps."""
        if ticket.done is not None:
            ticket.done.synchronize()
        toks = ticket.host.numpy()
        t = self.now()
        for slot, rt, idx in ticket.parts:
            # identity guard: deliver only if the request is still the
            # running occupant of this slot and no token landed since
            # dispatch (preempted/finished/reassigned -> drop overshoot)
            if (rt.phase is not Phase.RUNNING or rt.slot != slot
                    or len(rt.generated) != idx):
                continue
            self._deliver(rt, int(toks[slot]), t)

    def _deliver(self, rt: RuntimeRequest, tok: int, t: float):
        eng = self.eng
        rt.generated.append(tok)
        self._streams[rt.req_id].push(tok, t)
        if (eng.eos >= 0 and tok == eng.eos) or \
                len(rt.generated) >= rt.max_new_tokens:
            rt.phase = Phase.FINISHED
            rt.finish_time = t
            eng.finish_slot(rt)
            self._finish(rt, t, slot_done=False)

    def _finish(self, rt: RuntimeRequest, t: float, slot_done: bool):
        stream = self._streams[rt.req_id]
        stream.close(t)
        evs = stream.events
        self.metrics.on_finish(rt.request, RequestTimeline(
            req_id=rt.req_id, task_type=rt.request.task_type,
            arrival=rt.request.arrival_time, submit=rt.submit_time,
            first_token=evs[0].t if evs else None,
            finish=evs[-1].t if evs else None,
            n_tokens=len(evs), tbt=stream.tbts(),
            preemptions=rt.preemptions, cached_tokens=rt.cached_tokens))

    # -------------------------------------------------------------- tick
    def _idle(self) -> bool:
        return (self._inflight is None and all(self.eng.slot_free)
                and not self._waiting)

    def _done(self) -> bool:
        with self._lock:
            inbox = len(self._inbox)
        return inbox == 0 and not self._future and self._idle()

    def _run_prefill_plan(self) -> int:
        """Advance every staged prefill by its planned span (the
        streaming half of ``Engine.execute_step`` — decode runs through
        the overlapped dispatch path instead).  The prefill steps queue
        behind any in-flight decode round, so device order stays valid;
        a completing span delivers the first token and seeds the
        dispatch feed.  Returns prompt tokens computed this tick."""
        eng = self.eng
        plan = eng.plan_step(self.disc)
        done = 0
        for it in plan.prefills:
            rt = eng.slot_req[it.ref]
            if rt is None or rt.phase is not Phase.PREFILLING:
                continue
            eng.prefill_step(rt, it.length)
            done += it.length
            if rt.phase is not Phase.PREFILLING:     # completed
                self._after_prefill(rt)
        return done

    def tick(self):
        """One serving iteration: ingest -> schedule (stage admissions)
        -> prefill plan spans -> dispatch round N -> deliver round N-1
        (overlap) or round N (sync) -> gauges.  Under a chunked
        discipline a long prompt's chunk and the running decode round
        share every tick (chunk-as-tick)."""
        with self._on_stream():
            self._tick()

    def _tick(self):
        t = self.now()
        self._ingest(t)
        self.eng.clock = t          # engine stamps land on the wall clock
        admitted = self._schedule()
        pre_tok = self._run_prefill_plan()
        ticket = self._dispatch_round()
        prev, self._inflight = self._inflight, ticket
        if prev is not None:
            self._consume(prev)
        if not self.overlap and ticket is not None:
            self._consume(ticket)
            self._inflight = None
        self.metrics.on_gauge(StepGauge(
            t=t, queue_depth=len(self._waiting),
            active=sum(not f for f in self.eng.slot_free),
            free_blocks=self.eng.pool.available if self.eng.paged else -1,
            dispatch_width=ticket.width if ticket else 0,
            overlapped=prev is not None and ticket is not None,
            prefill_tokens=pre_tok,
            prefilling=sum(1 for rt in self.eng.slot_req
                           if rt is not None
                           and rt.phase is Phase.PREFILLING)))
        # stall detection: completely idle with a non-empty queue and a
        # policy that admits nothing (matches the batch loop's guard)
        if (ticket is None and self._inflight is None and self._waiting
                and not admitted and all(self.eng.slot_free)):
            self._stall_spins += 1
            if self._stall_spins > 4:
                rt = self._waiting[0]
                if self.eng.paged and all(
                        self.eng._unique_blocks_needed(w)
                        > self.eng._admission_blocks()
                        for w in self._waiting):
                    raise ValueError(
                        f"request {rt.req_id} needs "
                        f"{self.eng._unique_blocks_needed(rt)} KV blocks "
                        f"but only {self.eng._admission_blocks()} exist")
                raise RuntimeError(
                    "admission stalled: policy admitted nothing while "
                    "the loop was idle")
        else:
            self._stall_spins = 0

    def serve(self, poll: float = 0.0002):
        """Run until every submitted request has completed (and no
        future arrivals remain).  Between idle ticks the loop sleeps to
        the next scheduled arrival."""
        self.start()
        while not self._done():
            self.tick()
            if self._idle():
                wait = self._idle_wait(poll)
                if wait > 0:
                    time.sleep(wait)
        return self.results()

    def _idle_wait(self, poll: float) -> float:
        """Seconds an idle loop may sleep: to its next scheduled arrival
        (at most 50 ms), ``poll`` while a submission waits in the inbox,
        0 when nothing is left (``_done()`` will see it)."""
        with self._lock:
            empty_inbox = not self._inbox
        if self._future and empty_inbox:
            gap = self._future[0].request.arrival_time - self.now()
            return min(max(gap, 0.0), 0.05)
        return 0.0 if empty_inbox else poll

    def drain(self):
        """Consume any in-flight round (used when driving ``tick()``
        manually)."""
        if self._inflight is not None:
            with self._on_stream():          # delivery frees blocks
                self._consume(self._inflight)
            self._inflight = None

    # ------------------------------------------------------------ output
    def results(self) -> Dict[int, dict]:
        """Engine-style result dict over every completed request."""
        done = [rt for rt in self._requests.values()
                if rt.phase is Phase.FINISHED]
        out = self.eng._collect(done)
        for rid in out:
            out[rid]["met_wall"] = self.metrics.met(rid)
        return out

    def streams(self) -> Dict[int, TokenStream]:
        return dict(self._streams)
