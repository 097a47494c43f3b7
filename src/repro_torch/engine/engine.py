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

MLA archs (DeepSeek-V2) keep a latent per token instead of K/V, in
either layout, and have no chunked path: ``chunked_prefill`` is forced
to 0 and ``run_policy`` falls back to stalling prefill, with a warning,
when asked for a chunked discipline, as the JAX engine does; the prefix
index stays off for them.

A hybrid stack (zamba2: Mamba2 blocks and one shared attention block)
runs on either layout; on the paged one its SSM layers keep per-slot
state beside the pages.  As in the JAX engine, the prefix index is off
for it, and a paged chunk runs padded to its pow-2 bucket from the
slot's state as it stands, so the padded rows, and at a first chunk
the state the slot's previous request left, enter the recurrent state
(``ROADMAP.md`` §3 lists both as traps of the reference, kept for
parity).

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

The streaming loop (:mod:`repro_torch.serving.loop`) drives decode
through :meth:`Engine.dispatch_decode` instead: one decode round fused
with on-device sampling over a pow-2 slot prefix, queued on the current
stream without any read back to the host, so the loop can schedule the
next tick while the card computes.

**Tensor parallel** (``mesh=``, a rank's
:class:`~repro_torch.launch.mesh.Mesh`; the paged layout, so every arch
with attention layers: GQA or MLA, MLP or MoE FFN, and hybrids): one
process per rank, each holding its slice of the params
(``distributed.sharding``: ``param_specs`` adjusted by
``placement_specs``) and of the page arrays (``[N, P, kv/tp, hd]``), so
the hand-written paged kernels run unchanged on each rank's whole kv
heads; MLA's latent pages and a hybrid's per-slot SSM state are whole on
every rank, and every rank runs the SSM layers on them.  Rank 0 alone
owns the host side, which decides by the clock (the block pool, the
prefix index, the profiler, any policy or loop driving it); every other
rank runs :meth:`Engine.follow`, which replays rank 0's device work in
the same order: rank 0 sends, over the mesh's
gloo control group, each device step (prefill, chunk, decode round,
dispatched round, warm-up) together with the host-side writes queued
since the last one (block-table rows, ``pos``, copy-on-write page
copies, a token draw).  Each rank draws from the same whole logits with
its own identically seeded generator, so every rank samples the same
ids and the next round's inputs stay on the device; a dispatched round
also broadcasts the caller's feed from rank 0 to every rank, so the
ranks decode the same tokens whoever wrote it.  On a mesh with a data
axis (``(data, tp)``) the pages are whole over ``data``, as the
reference places them: every data group holds the same pool and runs
the same steps, each rank following rank 0; under
``ParallelismConfig(fsdp=True)`` each rank holds its FSDP slices of the
params and the paged forwards gather each layer's shards.  Every
collective has the mesh's timeout: ranks that disagree fail instead of
hanging.  Rank 0
calls :meth:`Engine.close` when done.  Several engines may share one
mesh (an :class:`~repro_torch.serving.fleet.EngineFleet` on one tp
group, the reference's layout): every rank builds them in the same order
before rank 0 drives any, each step rank 0 sends names its engine, and
one :meth:`Engine.follow` on each other rank replays the steps of every
engine built on its mesh until rank 0 has closed each of them.
"""
from __future__ import annotations

import dataclasses
import time
import warnings
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
from repro_torch.models.model import (forward_chunk,
                                      forward_chunk_paged, forward_decode,
                                      forward_decode_paged, forward_full,
                                      forward_prefill_paged, init_params)

# engine methods a warm-up may run on a mesh (every rank runs it)
MIRRORED_WARM_UPS = ("_prefill_step", "_chunk_step", "_decode_step",
                     "_decode_dispatch")


def _bucket(n: int, lo: int = 16) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


def _to_host(a):
    """A warm-up argument as rank 0 sends it: tensors as numpy arrays,
    a generator as a marker (the receiver makes a fresh one)."""
    if isinstance(a, torch.Tensor):
        return ("tensor", a.cpu().numpy())
    if isinstance(a, torch.Generator):
        return ("generator",)
    return ("value", a)


def _from_host(a, device):
    if a[0] == "tensor":
        return torch.from_numpy(a[1]).to(device)
    if a[0] == "generator":
        return torch.Generator(device=device)
    return a[1]


class Engine:
    def __init__(self, cfg: ModelConfig, params, max_slots: int = 8,
                 max_seq_len: int = 512, eos_token: int = -1,
                 temperature: float = 0.0, seed: int = 0,
                 profiler: Optional[LatencyProfiler] = None,
                 chunked_prefill: int = 0, paged: Optional[bool] = None,
                 block_size: int = 16, num_blocks: Optional[int] = None,
                 prefix_cache: bool = True, device=None, mesh=None,
                 parallelism=None):
        """``device`` (default ``cuda``; under a mesh, the mesh's) must hold
        ``params``.

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
        copy-on-write on divergent writes) for full-attention archs.

        ``mesh`` (this rank's :class:`~repro_torch.launch.mesh.Mesh` of
        ``(data, tp)``, from ``launch.mesh.make_host_mesh`` or ``spawn``)
        runs the engine on the mesh (module docstring): every rank
        builds it with the same arguments and the whole ``params`` (or
        already its own slice: engines on one rank may share another
        engine's ``params``); rank 0 then drives it and the others call
        :meth:`follow`.  Requires the paged layout, as the JAX engine
        does.  ``parallelism`` overrides the
        :class:`~repro_torch.distributed.sharding.ParallelismConfig`
        (default: tp on the ``model`` axis, no FSDP; ``fsdp=True`` slices
        the params over ``data`` too; ``expert_parallel`` picks the MoE
        FFN's expert-parallel branch)."""
        if cfg.num_codebooks > 1:
            # a K-codebook model emits [.., K, V] logits a step; the
            # engines sample one token a slot, as the JAX Engine does,
            # whose run_policy fails unpacking the codebook logits
            raise NotImplementedError(
                f"{cfg.name}: the engines sample one token stream a slot "
                f"and this model emits {cfg.num_codebooks} codebooks a "
                "step; the JAX Engine cannot serve it either")
        self.cfg = cfg
        if device is None and mesh is not None:
            device = mesh.device
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
        if mesh is not None and not self.paged:
            raise ValueError("mesh execution requires the paged KV layout "
                             "(paged=True with an attention arch)")
        self._init_mesh(mesh, parallelism)
        cache_kw = dict(mesh=mesh, parallelism=self.parallelism) \
            if mesh is not None else {}
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
                                          device=self.device, **cache_kw)
            # warm-up target: same slots and tables, two pages (every
            # table entry is the null page), so warming never touches
            # self.cache
            self._scratch = init_paged_cache(cfg, max_slots, max_seq_len,
                                             2, block_size,
                                             device=self.device, **cache_kw)
            # prefix sharing needs position-faithful, block-addressable
            # KV: no window rings, no recurrent (SSM) state
            self.prefix = RadixPrefixIndex(self.pool, block_size) \
                if (prefix_cache and not cfg.ssm_layers
                    and cfg.mla is None and not cfg.sliding_window) \
                else None
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
        # MLA archs have no chunked forward path
        self.chunked_prefill = 0 if cfg.mla is not None else chunked_prefill
        self._warm = set()
        self.cow_copies = 0          # copy-on-write page splits performed
        self._row = None             # the logits the next draw reads
        self._feed = None            # a following rank's dispatch feed
        if mesh is not None:
            self._handshake()

    # ------------------------------------------------------------- mesh
    def _init_mesh(self, mesh, parallelism):
        """Place ``self.params`` on this rank (its slice under
        ``placement_specs``; a leaf already at its slice's shape is kept)
        and build the ctx the forwards run under.  Without a mesh: no
        ctx, and this process drives the engine alone."""
        self.mesh = mesh
        self.ctx = None
        self.parallelism = None
        self._queued: List[tuple] = []
        # rank 0 of a mesh of more than one rank sends its device steps
        self._peers = mesh is not None and mesh.rank == 0 and mesh.size > 1
        self._leader = mesh is None or mesh.rank == 0
        if mesh is None:
            return
        # engines built on one mesh are numbered alike on every rank; a
        # following rank keeps its own until rank 0 stops them
        self._tag = mesh.engines_built
        mesh.engines_built += 1
        if not self._leader:
            mesh.followers[self._tag] = self
        from repro_torch.distributed.sharding import (ParallelismConfig,
                                                      local_shape, make_ctx,
                                                      param_specs,
                                                      placement_specs,
                                                      shard_leaf, tree_map)
        par = parallelism if parallelism is not None \
            else ParallelismConfig(fsdp=False)
        # the reference's engine hands its forwards no ctx
        # (src/repro/engine/engine.py:270, :281, :299), so there
        # attn_sharding="auto" changes nothing: its prefills attend over
        # the rank's heads as under "none", and so do this engine's (the
        # params placed alike)
        par = dataclasses.replace(par, attn_sharding="none")
        self.parallelism = par
        self.ctx = make_ctx(mesh, par)
        full = init_params(self.cfg, device="meta")
        specs = placement_specs(param_specs(full, self.cfg, mesh, par),
                                self.cfg, mesh, par)

        def place(t, whole, spec):
            if tuple(t.shape) == tuple(whole.shape):
                return shard_leaf(t, spec, mesh)
            if tuple(t.shape) == local_shape(whole.shape, spec, mesh):
                return t
            raise ValueError(f"a parameter of shape {tuple(t.shape)} is "
                             f"neither whole {tuple(whole.shape)} nor this "
                             f"rank's slice under {spec}")
        self.params = tree_map(place, self.params, full, specs)

    def _send(self, msg):
        import torch.distributed as dist
        dist.broadcast_object_list([msg], src=0,
                                   group=self.mesh.control_group)

    def _recv(self):
        import torch.distributed as dist
        box = [None]
        dist.broadcast_object_list(box, src=0,
                                   group=self.mesh.control_group)
        return box[0]

    def _handshake(self):
        """Rank 0 sends what the engine was built with; a rank built
        otherwise raises before any step could hang."""
        mine = (self.cfg, self.max_slots, self.max_seq_len,
                self.num_blocks, self.block_size, self.temperature,
                self.chunked_prefill, self.prefix is not None,
                self.parallelism, tuple(self.mesh.shape.items()))
        if self._peers:
            self._send(mine)
        elif self.mesh.size > 1:
            theirs = self._recv()
            if theirs != mine:
                raise ValueError(f"rank {self.mesh.rank} built its engine "
                                 f"as {mine}, rank 0 as {theirs}")

    def _op(self, name: str, *args, flush: bool = False, here=None):
        """Apply a device op here (``_do_<name>``); on rank 0 of a mesh
        also queue it for the other ranks, and with ``flush`` (the ops
        that run collectives) send the queue.  ``args`` are what the
        other ranks get (host values); ``here``, when given, what this
        rank runs with instead (its inputs already on the device, copied
        before a step's clock starts)."""
        if self._peers:
            self._queued.append((name, args))
            if flush:
                self._flush()
        return getattr(self, "_do_" + name)(*(args if here is None
                                               else here))

    def _flush(self):
        ops, self._queued = self._queued, []
        self._send((self._tag, ops))

    @torch.no_grad()
    def follow(self):
        """The loop of a rank other than 0: replay rank 0's device steps
        on this rank's shards, for every engine built on this rank's
        mesh (each message names its engine), until rank 0 has closed
        each of them."""
        if self._leader:
            raise RuntimeError("rank 0 drives the engine; follow() is for "
                               "the other ranks of a mesh")
        engines = self.mesh.followers
        while engines:
            tag, ops = self._recv()
            eng = engines[tag]
            for name, args in ops:
                if name == "stop":
                    del engines[tag]
                    break
                getattr(eng, "_do_" + name)(*args)

    def close(self):
        """On rank 0 of a mesh: stop this engine on the other ranks (their
        :meth:`follow` returns once every engine of the mesh is
        stopped).  Elsewhere nothing."""
        if self._peers:
            self._queued.append(("stop", ()))
            self._flush()
            self._peers = False

    # device ops: rank 0 runs them and the other ranks replay them
    def _do_table(self, slot: int, row):
        """Block-table row of ``slot`` (None: every entry the null
        page)."""
        if row is None:
            self.cache["block_tables"][slot] = 0
        else:
            self.cache["block_tables"][slot] = torch.from_numpy(row).to(
                self.device)

    def _do_table_entry(self, slot: int, bi: int, page: int):
        self.cache["block_tables"][slot, bi] = page

    def _do_pos(self, slot: int, value: int):
        self.cache["pos"][slot] = value

    def _do_copy_page(self, src: int, dst: int):
        copy_page(self.cache, src, dst)

    def _do_warm(self, key, name: str, args):
        fn = getattr(self, name)
        self._warm_run(key, fn, [_from_host(a, self.device) for a in args])

    def _on_device(self, a):
        """A step input on the engine's device (numpy as a follower
        receives it, or a tensor rank 0 already copied)."""
        if isinstance(a, np.ndarray):
            return torch.from_numpy(a).to(self.device)
        return a

    def _do_prefill(self, toks, n: int, slot: int):
        logits, _ = self._prefill_step(self.cache, self._on_device(toks),
                                       n, slot)
        self._row = logits[None, :]
        return self._row

    def _do_chunk(self, toks, slot: int, m: int):
        logits, _ = self._chunk_step(self.cache, self._on_device(toks),
                                     slot, m)
        self._row = logits[:, 0]
        return self._row

    def _do_decode(self, tokens, active):
        logits, _ = self._decode_step(self.cache, self._on_device(tokens),
                                      self._on_device(active))
        self._row = logits
        return logits

    def _do_sample(self):
        return sample(self._row, self.generator, self.temperature)

    def _do_dispatch(self, width: int, active_np, feed=None):
        if feed is None:                     # a following rank's own
            if self._feed is None:
                self._feed = torch.zeros((self.max_slots, 1),
                                         dtype=torch.int32,
                                         device=self.device)
            feed = self._feed
        if self.ctx is not None and self.mesh.size > 1:
            # every rank, each data group's tp ranks alike
            import torch.distributed as dist

            from repro_torch.models.layers import tally
            tally("feed", feed[:width])
            dist.broadcast(feed[:width], src=0,
                           group=self.mesh.group(self.mesh.axis_names))
        active = torch.from_numpy(np.array(active_np, dtype=bool))
        if self.device.type == "cuda":
            # a blocking host-to-device copy would wait for the rounds
            # in flight: copy from pinned memory, queued on the stream
            active = active.pin_memory().to(self.device, non_blocking=True)
        return self._decode_dispatch(self.cache, feed[:width], active,
                                     self.generator)

    # ------------------------------------------------------------ steps
    def _decode_step(self, cache, tokens, active):
        """tokens [B,1]; active [B] bool -> (logits [B,V], cache).  Paged:
        pages of inactive slots need no freeze (freed slots' tables point
        at the null page).  Dense: only active slots' rows are written.
        Either way an inactive slot's ``pos`` and SSM state keep their
        old values."""
        if self.paged:
            logits, new = forward_decode_paged(self.params, self.cfg,
                                               tokens=tokens, cache=cache,
                                               active=active, ctx=self.ctx)
        else:
            logits, new = forward_decode(self.params, self.cfg,
                                         tokens=tokens, cache=cache,
                                         active=active)
        # in place: ``cache`` may be a slot-prefix view of the pool
        # (:meth:`_slice_slots`), which a rebinding would not reach
        cache["pos"].copy_(torch.where(active, new["pos"], cache["pos"]))
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
                                     cache=cache, slot=slot, length=length,
                                     ctx=self.ctx)

    def _chunk_step(self, cache, tokens, slot, length):
        return forward_chunk_paged(self.params, self.cfg, tokens=tokens,
                                   cache=cache, slot=slot, length=length,
                                   ctx=self.ctx)

    def _warm_up(self, key, fn, *args):
        """Run ``fn`` once on the scratch pool, off the engine clock:
        first-use costs (kernel build and load, library handles, the
        allocator's first blocks for this shape) never reach the
        profiler's samples, and engine state is not touched."""
        if key in self._warm:
            return
        if self._peers:
            name = getattr(fn, "__name__", None)
            if name not in MIRRORED_WARM_UPS:
                raise ValueError(f"warm-up {fn!r} has no counterpart on the "
                                 "other ranks of the mesh")
            self._op("warm", key, name, [_to_host(a) for a in args],
                     flush=True)
        else:
            self._warm_run(key, fn, args)

    def _warm_run(self, key, fn, args):
        with torch.no_grad():
            fn(self._scratch, *args)
        self._scratch["pos"].zero_()
        synchronize(self.device)
        self._warm.add(key)

    # --------------------------------------- dispatch/sync split (serving)
    def _slice_slots(self, cache, width: int):
        """View of the first ``width`` slots of the paged pool: per-slot
        state (pos, block tables, SSM conv/ssm) sliced, the shared page
        tensors (K/V, or MLA's ckv/kpe latent pages) passed through.
        The slices are views and the decode step writes in place, so the
        round lands in the full pool with no merge."""
        return {"pos": cache["pos"][:width],
                "block_tables": cache["block_tables"][:width],
                "layers": [{k: (v[:width] if k in ("conv", "ssm") else v)
                            for k, v in layer.items()}
                           for layer in cache["layers"]]}

    def _decode_dispatch(self, cache, tokens, active, generator):
        """Fused decode round + on-device sampling over the first
        ``tokens.shape[0]`` slots (a pow-2 batch bucket on the paged
        layout, the whole pool on the dense one).  The sampled ids stay
        on the device: the next round can be dispatched from them
        without a host round trip."""
        width = tokens.shape[0]
        if width < self.max_slots:
            cache = self._slice_slots(cache, width)
        logits, _ = self._decode_step(cache, tokens, active)
        return sample(logits, generator, self.temperature)

    @torch.no_grad()
    def dispatch_decode(self, feed, active_np, width: Optional[int] = None,
                        lookahead: int = 0):
        """Queue one fused decode+sample round without waiting for it.

        ``feed``: ``[max_slots, 1]`` int32 tensor on the engine's device
        holding each running slot's last sampled token (typically
        written from the previous round's output, so chained rounds
        never touch the host).  ``active_np``: host bool mask.
        ``width``: batch width, a pow-2 bucket covering every active
        slot (paged only; the dense layout always runs the full pool).
        ``lookahead``: extra write positions the copy-on-write guard
        must cover while earlier rounds are still in flight.

        Returns the ``[width]`` int32 tensor of sampled ids at once; it
        is computed on the device's stream in order, and nothing here
        reads back to the host or synchronizes, so the caller does its
        host work (scheduling, delivery, block accounting) meanwhile.
        Off the clock, each width warms once on the scratch pool."""
        B = self.max_slots if (width is None or not self.paged) \
            else int(width)
        if not (0 < B <= self.max_slots):
            raise ValueError(f"width {width} outside (0, {self.max_slots}]")
        if any(active_np[B:]):
            raise ValueError(f"active slot >= dispatch width {B}")
        if self.paged:
            self._cow_guard(lookahead)
        if ("dispatch", B) not in self._warm:
            # a generator of its own: warming draws nothing from the
            # engine's sampling stream
            self._warm_up(("dispatch", B), self._decode_dispatch, feed[:B],
                          torch.zeros(B, dtype=torch.bool,
                                      device=self.device),
                          torch.Generator(device=self.device))
        active = np.array(active_np[:B], dtype=bool)
        if self._peers:
            # the feed stays here: the other ranks take it from the
            # broadcast inside the round
            self._queued.append(("dispatch", (B, active)))
            self._flush()
        return self._do_dispatch(B, active, feed)

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
        self._op("table", slot, row)

    def _release_blocks(self, slot: int):
        if self.paged and self._slot_blocks[slot]:
            self.pool.release(self._slot_blocks[slot])
            self._slot_blocks[slot] = []
            self._op("table", slot, None)

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
        self._op("copy_page", old, new)
        self._slot_blocks[slot][bi] = new
        self._op("table_entry", slot, bi, new)
        self.pool.release([old])
        self.cow_copies += 1
        return new

    def _cow_guard(self, lookahead: int = 0):
        """Before a decode round writes, split any shared page a slot's
        write frontier sits in (structurally unreachable through normal
        admission — kept so a shared page can never be scribbled on).
        ``lookahead`` widens the guard to the next write positions while
        earlier decode rounds are still in flight (the serving loop's
        overlapped dispatch): host token counts lag the device by that
        many rounds."""
        for slot, rt in enumerate(self.slot_req):
            if rt is None:
                continue
            # a slot mid-prefill writes at its chunk frontier
            pos = rt.prefill_pos if rt.phase is Phase.PREFILLING \
                else rt.input_len + len(rt.generated) - 1
            blocks = self._slot_blocks[slot]
            for d in range(lookahead + 1):
                bi = ((pos + d) % self.slot_len) // self.block_size
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
            self._op("pos", slot, rt.cached_tokens)
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
            # a whole SSM prefill runs at exact length (one warm-up per
            # distinct length): recurrent state is sequence-order
            # sensitive.  A paged chunk takes its pow-2 bucket whatever
            # the arch, as the JAX engine's does, so an SSM layer's state
            # takes in the padded rows too (ROADMAP.md §3)
            L = m if self.cfg.ssm_layers and whole else _bucket(m)
            toks = np.zeros((1, L), np.int32)
            toks[0, :m] = ctx[done:done + m]
        else:
            # dense chunks run at exact length (never bucketed)
            toks = np.asarray(ctx[done:done + m], np.int32)[None]
        ids = torch.from_numpy(toks).to(self.device)
        if whole and not self.paged:
            # dense whole-context fast path: one bucketed (SSM: exact-
            # length) prefill into a fresh single-slot cache (it touches
            # no engine state, so it warms as is), copied into the slot
            self._warm_up(("prefill", L),
                          lambda _s, t: self._prefill_one(t, n), ids)
            synchronize(self.device)
            t0 = time.perf_counter()
            logits, cache1 = self._prefill_one(ids, n)
            self._write_slot(slot, cache1)
            self._row = logits[None, :]
        elif whole:
            # whole-context fast path: one bucketed prefill
            self._warm_up(("prefill", L), self._prefill_step, ids, n, slot)
            synchronize(self.device)
            t0 = time.perf_counter()
            self._op("prefill", toks, n, slot, flush=True,
                     here=(ids, n, slot))
        elif self.paged:
            # chunk / prefix-hit suffix: padded to a pow-2 bucket whose
            # padded rows are never written and never attended
            self._warm_up(("chunk", L), self._chunk_step, ids, slot, m)
            synchronize(self.device)
            t0 = time.perf_counter()
            self._op("chunk", toks, slot, m, flush=True,
                     here=(ids, slot, m))
        else:
            # dense chunk walk over a private single-slot cache, copied
            # into the slot when the final chunk completes; each new
            # chunk length warms on a scratch single-slot cache
            self._warm_up(("chunk", m), lambda _s, t: self._prefill_chunk(
                init_cache(self.cfg, 1, self.max_seq_len,
                           device=self.device), t), ids)
            cache1 = self._partial.get(slot)
            if cache1 is None:
                cache1 = self._partial[slot] = init_cache(
                    self.cfg, 1, self.max_seq_len, device=self.device)
            synchronize(self.device)
            t0 = time.perf_counter()
            logits, _ = self._prefill_chunk(cache1, ids)
            if last:
                self._write_slot(slot, self._partial.pop(slot))
            self._row = logits[:, 0]
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
        tok = int(self._op("sample")[0])
        self._push_token(rt, tok)
        return True

    def prefill(self, rt: RuntimeRequest, slot: int):
        """Whole-prompt prefill: stage the slot and compute the full
        remaining context in one step (any cached prefix aliased).  The
        plan-driven executors instead call :meth:`begin_prefill` once
        and :meth:`prefill_step` per tick, as the discipline's
        :class:`StepPlan` dictates."""
        self.begin_prefill(rt, slot)
        self.prefill_step(rt)

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
        ids = torch.from_numpy(tokens).to(self.device)
        active = torch.from_numpy(active_np).to(self.device)
        self._warm_up("decode", self._decode_step, ids, active)
        synchronize(self.device)
        t0 = time.perf_counter()
        self._op("decode", tokens, active_np, flush=True,
                 here=(ids, active))
        synchronize(self.device)
        dt = time.perf_counter() - t0
        self.clock += dt
        if self.profiler is not None:
            self.profiler.observe_decode(b, accum, dt)
        toks = self._op("sample").tolist()
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
                                         max_batch=self.max_slots,
                                         device=self.device)
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
        if disc.chunk_size and self.cfg.mla is not None:
            # MLA archs have no chunked path (see __init__)
            warnings.warn(
                f"{disc!r} is unsupported for MLA archs; falling "
                "back to whole-prompt (stalling) prefill")
            disc = StallingPrefill()
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
