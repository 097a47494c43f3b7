"""Slot-based continuous-batching serving engine.

Counterpart of ``src/repro/engine/engine.py``: a fixed pool of
``max_slots`` request slots; whole prompts padded to power-of-two length
buckets (>= 16, which is also what the flash-attention kernel takes) —
SSM archs prefill at exact length, since their recurrent state must see
no pad token; each decode round runs over the full slot pool.  KV
memory comes in two layouts:

* **paged** (the default): one shared ``[num_blocks, block_size, kv,
  hd]`` page array per layer plus per-slot block tables; prefill and
  decode write their K/V **in place** into the slot's pages (the JAX
  engine gets the same effect from buffer donation).  Blocks are
  reserved on admit, aliased from the radix prefix index where a cached
  prefix matches, copied on write when shared, and released on finish or
  preemption.
* **dense** (``paged=False``): one ``[max_slots, L, kv, hd]`` ring per
  layer.  A whole-prompt prefill fills a fresh single-slot cache that is
  then copied into the slot; chunked prefills walk a private
  single-slot cache at exact chunk lengths and are copied in when the
  last chunk completes; a decode round writes only the running slots'
  rows (the JAX engine computes every row and restores the inactive
  ones with ``where``: the same result).  Archs without attention
  layers (Mamba2) always take this layout, as in the JAX engine: their
  per-slot conv and recurrent state is O(1) in sequence length.

Scheduling is delegated to the same policy objects as the discrete-event
core (:mod:`repro_torch.core.policies`): ``run_policy`` builds a
:class:`SchedulerView` each tick, honors admit and preempt decisions,
and executes the discipline's :class:`StepPlan` (prefill spans, then one
decode round) — chunk-as-tick, as in the JAX engine.

Every prefill and decode step is timed on the host clock after a device
synchronize, and fed to the ``LatencyProfiler``, so the paper's linear
latency model is fit from this engine on this device.  Per-shape
warm-up (first use of a prompt bucket, a chunk length, the decode round;
also the first build and load of each CUDA kernel) runs off the clock on
a scratch cache, so it never changes engine state.

Not ported yet (ROADMAP M6, M11): ``dispatch_decode`` and the streaming
loop's dispatch/sync split, and the device mesh.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.latency_model import LinearLatencyModel
from repro_torch.core.policies import (ChunkedPrefill, ExecutionDiscipline,
                                       FCFSPolicy, PlannedPolicy,
                                       SchedulerView, SchedulingPolicy,
                                       StallingPrefill, StepPlan,
                                       make_active_view, make_discipline,
                                       normalize_decision, resolve_policy)
from repro_torch.core.profiler import LatencyProfiler
from repro_torch.core.slo import meets_slo
from repro_torch.device import resolve_device, synchronize
from repro_torch.engine.blocks import BlockPool
from repro_torch.engine.prefix import RadixPrefixIndex
from repro_torch.engine.request import Phase, RuntimeRequest
from repro_torch.engine.sampling import sample
from repro_torch.models.cache import (copy_page, init_cache,
                                      init_paged_cache, paged_slot_len)
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import (forward_chunk, forward_chunk_paged,
                                      forward_decode, forward_decode_paged,
                                      forward_full, forward_prefill_paged)


def _bucket(n: int, lo: int = 16) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


class Engine:
    def __init__(self, cfg: ModelConfig, params, max_slots: int = 8,
                 max_seq_len: int = 512, eos_token: int = -1,
                 temperature: float = 0.0, seed: int = 0,
                 profiler: Optional[LatencyProfiler] = None,
                 chunked_prefill: int = 0, paged: Optional[bool] = None,
                 block_size: int = 16, num_blocks: Optional[int] = None,
                 prefix_cache: bool = True, device=None):
        """``device`` (default ``cuda``) must hold ``params``.

        ``chunked_prefill > 0``: split prompts into chunks of that size,
        each riding a tick beside the running decode round (Sarathi).
        ``paged`` (default: whether the arch has attention layers;
        an attention-free arch is dense whatever is asked, as in the
        JAX engine) selects the block-paged pool:
        ``num_blocks`` pages of ``block_size`` tokens (+ the null page)
        default to ``max_slots`` full-length slots; admission refuses
        requests whose prompt + output budget exceeds the free blocks.
        ``paged=False`` keeps the dense ``max_slots x max_seq_len``
        layout.  ``prefix_cache`` (paged only) enables shared-prefix KV
        reuse (refcounted pages aliased through a radix index,
        copy-on-write on divergent writes) for full-attention archs."""
        self.cfg = cfg
        self.device = resolve_device(device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(f"params live on {params['embed'].device}, "
                             f"engine device is {self.device}")
        self.params = params
        self.max_slots = max_slots
        self.max_seq_len = max_seq_len
        self.eos = eos_token
        self.temperature = temperature
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self.profiler = profiler
        self.clock = 0.0             # engine-internal wall clock
        self.slot_free = [True] * max_slots
        self.slot_req: List[Optional[RuntimeRequest]] = [None] * max_slots
        self.paged = (paged is None or bool(paged)) \
            and bool(cfg.attn_layers)
        if self.paged:
            self.block_size = block_size
            self.slot_len = paged_slot_len(cfg, max_seq_len, block_size)
            self.pages_per_slot = self.slot_len // block_size
            if num_blocks is None:
                num_blocks = max_slots * self.pages_per_slot + 1
            self.num_blocks = num_blocks
            self.pool = BlockPool(num_blocks)
            self._slot_blocks: List[List[int]] = [[] for _ in
                                                  range(max_slots)]
            self.cache = init_paged_cache(cfg, max_slots, max_seq_len,
                                          num_blocks, block_size,
                                          device=self.device)
            # warm-up target: same slots and tables, two pages (every
            # table entry is the null page), so warming never touches
            # self.cache
            self._scratch = init_paged_cache(cfg, max_slots, max_seq_len,
                                             2, block_size,
                                             device=self.device)
            # prefix sharing needs position-faithful KV: no window rings
            self.prefix = RadixPrefixIndex(self.pool, block_size) \
                if prefix_cache and not cfg.sliding_window else None
        else:
            self.pool = None
            self.prefix = None
            self.cache = init_cache(cfg, max_slots, max_seq_len,
                                    device=self.device)
            # warm-up target for decode rounds: the same slots over a
            # 16-token ring (the decode kernel takes any ring length;
            # nothing else in a round depends on it)
            self._scratch = init_cache(cfg, max_slots, 16,
                                       device=self.device)
        # dense in-progress chunked prefills: slot -> private single-slot
        # cache, copied into the slot when the final chunk completes
        self._partial: Dict[int, dict] = {}
        self.chunked_prefill = chunked_prefill
        self._warm = set()
        self.cow_copies = 0          # copy-on-write page splits performed

    # ------------------------------------------------------------ steps
    def _decode_step(self, cache, tokens, active):
        """tokens [B,1]; active [B] bool -> (logits [B,V], cache).  Paged:
        pages of inactive slots need no freeze (freed slots' tables point
        at the null page).  Dense: only active slots' rows are written.
        Either way an inactive slot's ``pos`` keeps its old value."""
        if self.paged:
            logits, new = forward_decode_paged(self.params, self.cfg,
                                               tokens=tokens, cache=cache)
        else:
            logits, new = forward_decode(self.params, self.cfg,
                                         tokens=tokens, cache=cache,
                                         active=active)
        cache["pos"] = torch.where(active, new["pos"], cache["pos"])
        return logits[:, -1], cache

    def _prefill_one(self, tokens, length):
        """Dense whole-prompt prefill into a fresh single-slot cache.
        tokens [1, Lpad] -> (logits [V] at the last real token, cache1)."""
        cache1 = init_cache(self.cfg, 1, self.max_seq_len,
                            device=self.device)
        logits, cache1, _ = forward_full(self.params, self.cfg,
                                         tokens=tokens, cache=cache1)
        cache1["pos"].fill_(length)
        return logits[0, length - 1], cache1

    def _prefill_chunk(self, cache1, tokens):
        """One dense chunk continuation over a single-slot cache."""
        return forward_chunk(self.params, self.cfg, tokens=tokens,
                             cache=cache1)

    def _write_slot(self, slot: int, cache1):
        """Copy a single-request dense cache into slot ``slot``."""
        for pool_l, one_l in zip(self.cache["layers"], cache1["layers"]):
            for name, buf in pool_l.items():
                buf[slot].copy_(one_l[name][0])
        self.cache["pos"][slot] = cache1["pos"][0]

    def _prefill_step(self, cache, tokens, length, slot):
        return forward_prefill_paged(self.params, self.cfg, tokens=tokens,
                                     cache=cache, slot=slot, length=length)

    def _chunk_step(self, cache, tokens, slot, length):
        return forward_chunk_paged(self.params, self.cfg, tokens=tokens,
                                   cache=cache, slot=slot, length=length)

    def _warm_up(self, key, fn, *args):
        """Run ``fn`` once on the scratch pool, off the engine clock:
        first-use costs (kernel build and load, library handles, the
        allocator's first blocks for this shape) never reach the
        profiler's samples, and engine state is not touched."""
        if key in self._warm:
            return
        with torch.no_grad():
            fn(self._scratch, *args)
        self._scratch["pos"].zero_()
        synchronize(self.device)
        self._warm.add(key)

    def finish_slot(self, rt: RuntimeRequest):
        """Release a finished request's slot: publish its KV-valid span
        (prompt + all but the never-written final token) to the prefix
        index, return its blocks (paged), and free the slot."""
        self._index_span(rt, rt.input_len + len(rt.generated) - 1)
        self._release_blocks(rt.slot)
        self.slot_free[rt.slot] = True
        self.slot_req[rt.slot] = None

    # ------------------------------------------------------------ blocks
    def _blocks_needed(self, rt: RuntimeRequest) -> int:
        """Pages covering the request's lifetime token footprint (prompt
        + output budget, capped by the slot's ring length)."""
        tokens = min(rt.input_len + rt.max_new_tokens, self.slot_len)
        return -(-tokens // self.block_size)

    def _prefix_eligible(self, rt: RuntimeRequest) -> bool:
        """Prefix sharing is safe only while the slot ring never wraps:
        a wrap would overwrite aliased pages in place."""
        return (self.prefix is not None
                and rt.input_len + rt.max_new_tokens <= self.slot_len)

    def _probe_cached(self, rt: RuntimeRequest) -> int:
        """Read-only longest-cached-prefix length (tokens) for pricing."""
        if not self._prefix_eligible(rt):
            return 0
        ctx = self._context_tokens(rt)
        return self.prefix.probe(ctx, max_tokens=len(ctx) - 1)

    def _unique_blocks_needed(self, rt: RuntimeRequest) -> int:
        """Blocks the request needs *beyond* the cached prefix it would
        alias — what admission must actually find in the free list."""
        return self._blocks_needed(rt) \
            - self._probe_cached(rt) // self.block_size

    def _admission_blocks(self) -> int:
        """Blocks admission can draw on: the free list plus cached pages
        only the prefix index holds (evictable on demand)."""
        extra = self.prefix.reclaimable() if self.prefix is not None else 0
        return self.pool.available + extra

    def _reserve_blocks(self, rt: RuntimeRequest) -> bool:
        """Atomically reserve the request's block footprint: alias the
        longest cached block-aligned prefix, evict index-only pages if
        the free list is short, and allocate the rest into
        ``rt.block_ids`` / ``rt.cached_tokens``.  Returns False (no
        state change) when blocks don't cover it."""
        if rt.block_ids is not None:
            return True                      # already reserved this step
        need = self._blocks_needed(rt)
        matched: List[int] = []
        if self._prefix_eligible(rt):
            ctx = self._context_tokens(rt)
            # cap at len-1: the request always writes at least one new
            # token position, so a full-context hit must still leave the
            # final block's frontier in a page this request owns
            matched = self.prefix.match(ctx, max_tokens=len(ctx) - 1)
            self.pool.share(matched)         # pin before any eviction
        n_new = need - len(matched)
        short = n_new - self.pool.available
        if short > 0 and self.prefix is not None:
            self.prefix.evict(short)
        if n_new > self.pool.available:
            self.pool.release(matched)       # roll back the pin
            return False
        rt.block_ids = matched + self.pool.alloc(n_new)
        rt.cached_tokens = len(matched) * self.block_size
        return True

    def _assign_blocks(self, rt: RuntimeRequest, slot: int):
        # upgrade an admission-time reservation: prefills earlier in the
        # same step may have indexed this prompt's prefix since — a
        # re-reservation shares more and allocates strictly less
        if rt.block_ids is not None and self._prefix_eligible(rt):
            ctx = self._context_tokens(rt)
            if self.prefix.probe(ctx, max_tokens=len(ctx) - 1) \
                    > rt.cached_tokens:
                self.pool.release(rt.block_ids)
                rt.block_ids = None
                rt.cached_tokens = 0
        if not self._reserve_blocks(rt):
            raise RuntimeError(
                f"out of KV blocks: request {rt.req_id} needs "
                f"{self._unique_blocks_needed(rt)} new blocks, "
                f"{self.pool.available} free")
        ids = rt.block_ids
        rt.block_ids = None                  # reservation consumed
        self._slot_blocks[slot] = ids
        row = np.zeros(self.pages_per_slot, np.int32)
        row[:len(ids)] = ids
        self.cache["block_tables"][slot] = torch.from_numpy(row).to(
            self.device)

    def _release_blocks(self, slot: int):
        if self.paged and self._slot_blocks[slot]:
            self.pool.release(self._slot_blocks[slot])
            self._slot_blocks[slot] = []
            self.cache["block_tables"][slot] = 0

    def _index_span(self, rt: RuntimeRequest, n_tokens: int):
        """Publish the slot's first ``n_tokens`` KV positions to the
        prefix index (full blocks only; the index takes its own ref on
        each newly indexed page, so they outlive this request)."""
        if rt.slot < 0 or not self._prefix_eligible(rt):
            return
        ctx = self._context_tokens(rt)
        self.prefix.insert(ctx[:n_tokens], self._slot_blocks[rt.slot],
                           max_tokens=n_tokens)

    def _cow_block(self, slot: int, bi: int) -> int:
        """Give ``slot`` a private copy of its ``bi``-th page (copy-on-
        write) if other owners share it.  Returns the (possibly new)
        page id."""
        old = self._slot_blocks[slot][bi]
        if self.pool.refcount(old) <= 1:
            return old
        if not self.pool.available and self.prefix is not None:
            self.prefix.evict(1)
        new = self.pool.alloc(1)[0]
        copy_page(self.cache, old, new)
        self._slot_blocks[slot][bi] = new
        self.cache["block_tables"][slot, bi] = new
        self.pool.release([old])
        self.cow_copies += 1
        return new

    def _cow_guard(self):
        """Before a decode round writes, split any shared page a slot's
        write frontier sits in (structurally unreachable through normal
        admission — kept so a shared page can never be scribbled on)."""
        for slot, rt in enumerate(self.slot_req):
            if rt is None:
                continue
            # a slot mid-prefill writes at its chunk frontier
            pos = rt.prefill_pos if rt.phase is Phase.PREFILLING \
                else rt.input_len + len(rt.generated) - 1
            blocks = self._slot_blocks[slot]
            bi = (pos % self.slot_len) // self.block_size
            if bi < len(blocks) and self.pool.refcount(blocks[bi]) > 1:
                self._cow_block(slot, bi)

    def free_slots(self) -> List[int]:
        return [i for i, f in enumerate(self.slot_free) if f]

    def _context_tokens(self, rt: RuntimeRequest) -> np.ndarray:
        """Prefill context: the prompt, plus — after a preemption — the
        tokens already generated (vLLM-style KV recompute)."""
        if not rt.generated:
            return np.asarray(rt.prompt_tokens, np.int32)
        return np.concatenate([np.asarray(rt.prompt_tokens, np.int32),
                               np.asarray(rt.generated, np.int32)])

    def begin_prefill(self, rt: RuntimeRequest, slot: int):
        """Claim ``slot`` for ``rt`` and stage its prefill (no compute):
        :meth:`prefill_step` advances it, possibly over several ticks."""
        n = len(self._context_tokens(rt))
        if n >= self.max_seq_len:
            raise ValueError(f"prefill context {n} >= max_seq_len")
        # block assignment is deferred to the first prefill_step, so a
        # prefill completing earlier in the same tick can be aliased
        rt.prefill_pos = 0
        rt.phase = Phase.PREFILLING
        rt.slot = slot
        self.slot_free[slot] = False
        self.slot_req[slot] = rt

    @torch.no_grad()
    def prefill_step(self, rt: RuntimeRequest,
                     length: Optional[int] = None) -> bool:
        """Advance ``rt``'s staged prefill by ``length`` context tokens
        (the whole remaining span when None) — one timed step, one
        profiler sample.  The final span samples the first output token
        and flips the request to RUNNING.  Returns True when done."""
        if rt.phase is not Phase.PREFILLING:
            raise ValueError(f"request {rt.req_id} has no staged prefill")
        slot = rt.slot
        if self.paged and not self._slot_blocks[slot]:
            # first step: claim the pages (aliasing any prefix indexed
            # since admission) and skip the cached span
            self._assign_blocks(rt, slot)
            self.cache["pos"][slot] = rt.cached_tokens
            rt.prefill_pos = rt.cached_tokens
        ctx = self._context_tokens(rt)
        n = len(ctx)
        done = rt.prefill_pos
        m = n - done if length is None else min(int(length), n - done)
        if m <= 0:
            raise ValueError(f"empty prefill span for request {rt.req_id}")
        last = done + m >= n
        whole = done == 0 and last
        if self.paged or whole:
            # SSM state is sequence-order sensitive: exact length (one
            # warm-up per distinct length), never a padded bucket
            L = m if self.cfg.ssm_layers else _bucket(m)
            toks = np.zeros((1, L), np.int32)
            toks[0, :m] = ctx[done:done + m]
        else:
            # dense chunks run at exact length (never bucketed)
            toks = np.asarray(ctx[done:done + m], np.int32)[None]
        toks = torch.from_numpy(toks).to(self.device)
        if whole and not self.paged:
            # dense whole-context fast path: one bucketed (SSM: exact-
            # length) prefill into a fresh single-slot cache (it touches
            # no engine state, so it warms as is), copied into the slot
            self._warm_up(("prefill", L),
                          lambda _s, t: self._prefill_one(t, n), toks)
            synchronize(self.device)
            t0 = time.perf_counter()
            logits, cache1 = self._prefill_one(toks, n)
            self._write_slot(slot, cache1)
            row = logits[None, :]
        elif whole:
            # whole-context fast path: one bucketed prefill
            self._warm_up(("prefill", L), self._prefill_step, toks, n, slot)
            synchronize(self.device)
            t0 = time.perf_counter()
            logits, _ = self._prefill_step(self.cache, toks, n, slot)
            row = logits[None, :]
        elif self.paged:
            # chunk / prefix-hit suffix: padded to a pow-2 bucket whose
            # padded rows are never written and never attended
            self._warm_up(("chunk", L), self._chunk_step, toks, slot, m)
            synchronize(self.device)
            t0 = time.perf_counter()
            logits, _ = self._chunk_step(self.cache, toks, slot, m)
            row = logits[:, 0]
        else:
            # dense chunk walk over a private single-slot cache, copied
            # into the slot when the final chunk completes; each new
            # chunk length warms on a scratch single-slot cache
            self._warm_up(("chunk", m), lambda _s, t: self._prefill_chunk(
                init_cache(self.cfg, 1, self.max_seq_len,
                           device=self.device), t), toks)
            cache1 = self._partial.get(slot)
            if cache1 is None:
                cache1 = self._partial[slot] = init_cache(
                    self.cfg, 1, self.max_seq_len, device=self.device)
            synchronize(self.device)
            t0 = time.perf_counter()
            logits, _ = self._prefill_chunk(cache1, toks)
            if last:
                self._write_slot(slot, self._partial.pop(slot))
            row = logits[:, 0]
        synchronize(self.device)
        dt = time.perf_counter() - t0
        self.clock += dt
        if self.profiler is not None:
            self.profiler.observe_prefill(1, m, dt)
        rt.prefill_pos = done + m
        if not last:
            return False
        rt.phase = Phase.RUNNING
        self._index_span(rt, n)
        if rt.ttft_time is None:            # preserved across preemptions
            rt.ttft_time = self.clock
        tok = int(sample(row, self.generator, self.temperature)[0])
        self._push_token(rt, tok)
        return True

    def preempt(self, rt: RuntimeRequest):
        """Evict a running request: free its slot and its blocks.  The
        generated tokens and TTFT are kept; the next prefill recomputes
        prompt + generated."""
        if rt.slot < 0 or self.slot_req[rt.slot] is not rt:
            raise ValueError(f"request {rt.req_id} is not running")
        self._partial.pop(rt.slot, None)     # drop any half-built cache
        self._release_blocks(rt.slot)
        self.slot_free[rt.slot] = True
        self.slot_req[rt.slot] = None
        rt.slot = -1
        rt.phase = Phase.WAITING
        rt.prefill_pos = 0
        rt.preemptions += 1

    def _push_token(self, rt: RuntimeRequest, tok: int):
        rt.generated.append(tok)
        if (self.eos >= 0 and tok == self.eos) or \
                len(rt.generated) >= rt.max_new_tokens:
            rt.phase = Phase.FINISHED
            rt.finish_time = self.clock
            self.finish_slot(rt)

    @torch.no_grad()
    def decode_round(self):
        """One decode iteration over every RUNNING slot.  Slots mid-
        prefill are masked out: the unmasked page write lands one garbage
        token at their frontier, which their next chunk overwrites before
        anything reads it (their ``pos`` is kept)."""
        running = [rt for rt in self.slot_req
                   if rt is not None and rt.phase is Phase.RUNNING]
        if not running:
            return
        if self.paged:
            self._cow_guard()
        active_np = np.array([rt is not None and rt.phase is Phase.RUNNING
                              for rt in self.slot_req])
        tokens = np.zeros((self.max_slots, 1), np.int32)
        for i, rt in enumerate(self.slot_req):
            if rt is not None and rt.phase is Phase.RUNNING:
                tokens[i, 0] = rt.generated[-1]
        b = len(running)
        accum = max(rt.input_len + len(rt.generated) for rt in running)
        tokens = torch.from_numpy(tokens).to(self.device)
        active = torch.from_numpy(active_np).to(self.device)
        self._warm_up("decode", self._decode_step, tokens, active)
        synchronize(self.device)
        t0 = time.perf_counter()
        logits, _ = self._decode_step(self.cache, tokens, active)
        synchronize(self.device)
        dt = time.perf_counter() - t0
        self.clock += dt
        if self.profiler is not None:
            self.profiler.observe_decode(b, accum, dt)
        toks = sample(logits, self.generator, self.temperature).tolist()
        for i, rt in enumerate(list(self.slot_req)):
            if rt is not None and rt.phase is Phase.RUNNING:
                self._push_token(rt, int(toks[i]))

    # ------------------------------------------------------- step planner
    def plan_step(self, disc: ExecutionDiscipline) -> StepPlan:
        """This tick's :class:`StepPlan`: one prefill item per PREFILLING
        slot (``ref`` is the slot id) and one decode item per RUNNING
        slot."""
        prefills, decodes = [], []
        for slot, rt in enumerate(self.slot_req):
            if rt is None:
                continue
            if rt.phase is Phase.PREFILLING:
                prefills.append((slot, rt.prefill_pos,
                                 rt.input_len + len(rt.generated)))
            elif rt.phase is Phase.RUNNING:
                decodes.append(slot)
        return disc.plan_step(prefills, decodes)

    def execute_step(self, plan: StepPlan):
        """Execute one mixed tick: every planned prefill span, then one
        decode round (a request whose final chunk just completed joins
        it)."""
        for it in plan.prefills:
            rt = self.slot_req[it.ref]
            if rt is not None and rt.phase is Phase.PREFILLING:
                self.prefill_step(rt, it.length)
        self.decode_round()

    # ------------------------------------------------------------ views
    def active_requests(self) -> List[RuntimeRequest]:
        """RUNNING requests in slot order (the ``active`` order of every
        :class:`SchedulerView` built here)."""
        return [rt for rt in self.slot_req
                if rt is not None and rt.phase is Phase.RUNNING]

    def build_view(self, waiting: Sequence[RuntimeRequest],
                   disc: Optional[ExecutionDiscipline],
                   model: Optional[LinearLatencyModel]) -> SchedulerView:
        """:class:`SchedulerView` over the engine's in-flight state plus
        a waiting list; ``now`` is the engine clock."""
        active_rts = self.active_requests()
        b = max(len(active_rts), 1)
        return SchedulerView(
            pending=tuple(rt.request for rt in waiting),
            active=tuple(make_active_view(
                rt.request, len(rt.generated),
                rt.max_new_tokens - len(rt.generated),
                rt.input_len + len(rt.generated), self.clock,
                rt.ttft_time, rt.submit_time, b, model,
                # only pages this request exclusively owns are freeable
                # by preempting it
                blocks_held=(sum(1 for bl in self._slot_blocks[rt.slot]
                                 if self.pool.refcount(bl) == 1)
                             if self.paged else 0))
                for rt in active_rts),
            now=self.clock, free=len(self.free_slots()),
            max_batch=self.max_slots,
            pending_generated=tuple(len(rt.generated) for rt in waiting),
            pending_cached=(tuple(self._probe_cached(rt) for rt in waiting)
                            if self.paged else ()),
            discipline=disc,
            free_blocks=self._admission_blocks() if self.paged else None,
            total_blocks=self.pool.total if self.paged else None,
            block_size=self.block_size if self.paged else 0,
            pages_per_slot=self.pages_per_slot if self.paged else 0)

    # ------------------------------------------------------------ runs
    def run_policy(self, rts: Sequence[RuntimeRequest],
                   policy: SchedulingPolicy, *,
                   discipline: "ExecutionDiscipline | str | None" = None,
                   model: Optional[LinearLatencyModel] = None,
                   respect_arrivals: bool = False):
        """Continuous batching with a pluggable :class:`SchedulingPolicy`
        — the same policy and :class:`ExecutionDiscipline` objects that
        drive the discrete-event core.  ``discipline`` overrides the
        engine's prefill mode for this run (else the policy's own, else
        ``chunked_prefill``); engine config is never mutated.
        ``respect_arrivals=True`` releases each request only once its
        ``arrival_time`` (relative to the run start) has passed on the
        engine clock."""
        pol, preemptive = resolve_policy(policy, model=model,
                                         max_batch=self.max_slots)
        if model is None:
            model = getattr(pol, "model", None)
        if discipline is None:
            # adopt the policy's own (possibly adaptive) discipline by
            # identity: the planner re-reads chunk_size every tick
            discipline = getattr(pol, "discipline", None)
        if discipline is not None:
            disc = make_discipline(discipline)
        else:
            disc = ChunkedPrefill(self.chunked_prefill) \
                if self.chunked_prefill else StallingPrefill()
        return self._run_policy_loop(rts, pol, preemptive, model,
                                     respect_arrivals, disc)

    def _run_policy_loop(self, rts, pol, preemptive, model,
                         respect_arrivals, disc):
        rts = list(rts)
        t0 = self.clock
        if respect_arrivals:
            future = sorted(rts, key=lambda rt: rt.request.arrival_time)
            waiting: List[RuntimeRequest] = []
        else:
            future, waiting = [], list(rts)
            for rt in waiting:
                rt.submit_time = self.clock
                rt.request.submit_time = self.clock
        fi = 0
        while waiting or fi < len(future) or not all(self.slot_free):
            # compare on t0 + arrival: (t0 + a) - t0 can round below a
            while fi < len(future) and \
                    t0 + future[fi].request.arrival_time <= self.clock:
                rt = future[fi]
                rt.submit_time = t0 + rt.request.arrival_time
                rt.request.submit_time = rt.submit_time
                waiting.append(rt)
                fi += 1
            free = self.free_slots()
            admitted = False
            decided = False
            if waiting and (free or (preemptive
                                     and not all(self.slot_free))):
                view = self.build_view(waiting, disc, model)
                admit, preempt = normalize_decision(pol.decide(view), view)
                decided = True
                active_rts = self.active_requests()
                for j in preempt:
                    vict = active_rts[j]
                    # re-prefill must fit: prompt + generated + next token
                    if vict.input_len + len(vict.generated) + 1 \
                            >= self.max_seq_len:
                        continue
                    self.preempt(vict)
                    waiting.append(vict)        # view indices stay valid
                    admitted = True
                free = self.free_slots()
                sel = []
                for j in admit:
                    if len(sel) >= len(free):
                        break
                    # reserve atomically so same-step admissions never
                    # race a probe against a later allocation
                    if self.paged and not self._reserve_blocks(waiting[j]):
                        continue        # out of KV blocks: keep waiting
                    sel.append(j)
                chosen = [waiting[j] for j in sel]
                for j in sorted(sel, reverse=True):
                    waiting.pop(j)
                for rt, slot in zip(chosen, free):
                    self.begin_prefill(rt, slot)
                admitted = admitted or bool(chosen)
            retune = getattr(pol, "retune", None)
            if not decided and retune is not None \
                    and not all(self.slot_free):
                retune(self.build_view([], disc, model))
            idle = all(self.slot_free)
            self.execute_step(self.plan_step(disc))
            if idle and not admitted:
                if fi < len(future):
                    # idle-wait for the next arrival on the engine clock
                    self.clock = max(self.clock,
                                     t0 + future[fi].request.arrival_time)
                elif waiting:
                    if self.paged and all(
                            self._unique_blocks_needed(rt)
                            > self._admission_blocks() for rt in waiting):
                        rt = waiting[0]
                        raise ValueError(
                            f"request {rt.req_id} needs "
                            f"{self._unique_blocks_needed(rt)} KV blocks "
                            f"but only {self._admission_blocks()} exist: "
                            "prompt + output budget exceeds the block "
                            "pool")
                    raise RuntimeError("admission stalled: policy admitted "
                                       "nothing while the engine was idle")
        return self._collect(rts)

    def run_fcfs(self, rts: Sequence[RuntimeRequest], **kw):
        """Continuous batching, FCFS admission."""
        return self.run_policy(rts, FCFSPolicy(), **kw)

    def run_priority(self, batches: Sequence[Sequence[RuntimeRequest]],
                     **kw):
        """Continuous batching with the planned priority order as the
        arrival order (paper §5.1)."""
        return self.run_policy([rt for b in batches for rt in b],
                               FCFSPolicy(), **kw)

    def run_planned(self, batches: Sequence[Sequence[RuntimeRequest]],
                    **kw):
        """Execute scheduler-planned batches sequentially (barrier between
        batches, enforced by ``PlannedPolicy``)."""
        allr = [rt for b in batches for rt in b]
        return self.run_policy(allr, PlannedPolicy(batches), **kw)

    def _collect(self, rts):
        out = {}
        for rt in rts:
            e2e, ttft, tpot = rt.metrics()
            out[rt.req_id] = {
                "e2e": e2e, "ttft": ttft, "tpot": tpot,
                "tokens": list(rt.generated),
                "met": meets_slo(rt.request, e2e, ttft, tpot),
                "preemptions": rt.preemptions,
                "cached": rt.cached_tokens,
            }
        return out

    def prefix_stats(self) -> Dict[str, float]:
        """Prefix-cache counters for benchmarks/diagnostics."""
        if self.prefix is None:
            return {"hit_rate": 0.0, "cached_blocks": 0, "cow_copies": 0,
                    "enabled": False}
        return {"hit_rate": self.prefix.hit_rate,
                "cached_blocks": len(self.prefix),
                "cow_copies": self.cow_copies, "enabled": True}
