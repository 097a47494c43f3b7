"""Rank functions of the tensor-parallel tests: each runs in one process
per rank, started by ``repro_torch.launch.mesh.spawn``, and imports torch
and the port only (never JAX).  Inputs arrive as numpy trees and plain
values; results go back the same way, each rank's in a dict."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.bridge import from_jax_params
from repro_torch.distributed.sharding import (ParallelismConfig,
                                              cache_specs, local_shape,
                                              make_ctx)
from repro_torch.models.cache import init_paged_cache
from repro_torch.models.model import (forward_chunk_paged,
                                      forward_decode_paged, forward_full,
                                      forward_prefill_paged)

CPU = torch.device("cpu")
# the engine's device ops (Engine._do_<name>), each logged per rank
OPS = ("table", "table_entry", "pos", "copy_page", "warm", "prefill",
       "chunk", "decode", "sample", "dispatch")


# the tokens of the decode steps of :func:`paged_forwards`, one a slot
DECODE_FEEDS = ([[24], [61], [0], [0]], [[5], [6], [0], [0]],
                [[7], [8], [0], [0]])


def _np(x):
    return x.detach().cpu().numpy()


# ------------------------------------------------------------ forwards
def first_attn(tree, cfg):
    """The first attention layer's entry of a params or cache tree (a
    hybrid's shared block where its params hold the ``{}`` marker)."""
    i = list(cfg.layer_pattern).index("attn")
    return tree["layers"][i] or tree["shared_block"]


def paged_forwards(cfg, params, ctx, mesh=None):
    """Prefill 24 tokens into slot 0, then 32 tokens into slot 1 as two
    16-token chunks (an MLA arch, which has no chunked path: one whole
    prefill), then 3 decode steps over both (``DECODE_FEEDS``), plus one
    ``forward_full`` pass: the logits of each, the first attention
    layer's page shape, and every cache array after the decode steps."""
    cache = init_paged_cache(cfg, 4, 128, 33, 16, device=CPU, mesh=mesh)
    bt = np.zeros((4, 8), np.int32)
    bt[0, :4] = [1, 2, 3, 4]
    bt[1, :4] = [5, 6, 7, 8]
    cache["block_tables"] = torch.from_numpy(bt)
    toks = torch.arange(1, 25, dtype=torch.int32)[None]
    pages = first_attn(cache, cfg)
    out = {"page_shape": tuple(pages["ckv" if "ckv" in pages
                                     else "k"].shape)}
    with torch.no_grad():
        lg, _ = forward_prefill_paged(params, cfg, tokens=toks, cache=cache,
                                      slot=0, length=24, ctx=ctx)
        out["prefill"] = _np(lg)
        ids = torch.arange(30, 62, dtype=torch.int32)[None]
        if cfg.mla is not None:
            lg, _ = forward_prefill_paged(params, cfg, tokens=ids,
                                          cache=cache, slot=1, length=32,
                                          ctx=ctx)
        else:
            for i in range(2):
                lg, _ = forward_chunk_paged(
                    params, cfg, tokens=ids[:, 16 * i:16 * (i + 1)],
                    cache=cache, slot=1, length=16, ctx=ctx)
        out["chunk"] = _np(lg)
        out["decode"] = []
        for feed in DECODE_FEEDS:
            lg, new = forward_decode_paged(
                params, cfg, tokens=torch.tensor(feed, dtype=torch.int32),
                cache=cache, ctx=ctx)
            cache["pos"].copy_(new["pos"])
            out["decode"].append(_np(lg))
        out["cache"] = [{k: _np(v) for k, v in layer.items()}
                        for layer in cache["layers"]]
        lg, _, _ = forward_full(params, cfg, tokens=toks, ctx=ctx)
        out["full"] = _np(lg)
    return out


def forward_suite(mesh, cases, moe_cases=()):
    """``cases``: (cfg, params tree) pairs through :func:`paged_forwards`
    on this rank's shard; ``moe_cases``: (cfg, MoE block tree, x,
    expert_parallel) through ``moe_ffn`` with a ctx."""
    from repro_torch.distributed.sharding import (param_specs,
                                                  placement_specs,
                                                  shard_params)
    from repro_torch.models.moe import moe_ffn
    par = ParallelismConfig(fsdp=False)
    ctx = make_ctx(mesh, par)
    out = {"rank": mesh.rank, "forwards": [], "moe": []}
    for cfg, tree in cases:
        params = from_jax_params(tree, CPU, mesh, cfg=cfg)
        res = paged_forwards(cfg, params, ctx, mesh)
        res["attn_shapes"] = {k: tuple(v.shape) for k, v in
                              first_attn(params, cfg)["attn"].items()}
        out["forwards"].append(res)
    for cfg, block, x, ep in moe_cases:
        p = ParallelismConfig(fsdp=False, expert_parallel=ep)
        whole = from_jax_params(block, CPU)
        tree = {"embed": torch.empty(0, 0), "final_norm": {},
                "layers": [{"moe": whole}]}
        specs = placement_specs(param_specs(tree, cfg, mesh, p), cfg, mesh,
                                p)
        mine = shard_params({"moe": whole}, specs["layers"][0], mesh)["moe"]
        with torch.no_grad():
            y, aux = moe_ffn(mine, cfg, torch.from_numpy(x),
                             make_ctx(mesh, p))
        out["moe"].append({"out": _np(y), "aux": float(aux),
                           "experts": int(mine["w_gate"].shape[0])})
    return out


# -------------------------------------------------------------- engines
class FixedClock:
    """A stand-in for the ``time`` module whose ``perf_counter`` moves
    ``step`` seconds (default 1 ms) a call: every timed engine step then
    takes exactly ``step``, so the policies that read the engine clock
    decide alike in both packages (a slow clock makes slo-preempt
    preempt)."""

    def __init__(self, step: float = 1e-3):
        self.t, self.step = 0.0, step

    def perf_counter(self):
        self.t += self.step
        return self.t


def _summary(v):
    if isinstance(v, np.ndarray):
        return v.tolist()
    if isinstance(v, torch.Tensor):
        return _np(v).tolist()
    if isinstance(v, (list, tuple)):
        return [_summary(a) for a in v]
    return v


def log_ops(eng):
    """Wrap the engine's device ops to log (name, args) as this rank ran
    them; a draw logs the ids it drew.  Returns the log."""
    log = []
    for name in OPS:
        fn = getattr(eng, "_do_" + name)

        def wrapped(*args, _fn=fn, _name=name):
            res = _fn(*args)
            if _name == "dispatch":
                args = args[:2]              # the feed is rank 0's own
            entry = [_name, _summary(list(args))]
            if _name == "sample":
                entry.append(_summary(res))
            log.append(entry)
            return res
        setattr(eng, "_do_" + name, wrapped)
    return log


def _requests(workload, vocab):
    from repro_torch.data import synthetic
    from repro_torch.engine.request import RuntimeRequest
    kind = workload[0]
    if kind == "serve":
        pairs = synthetic.sample_serve_workload(workload[1], vocab,
                                                seed=workload[2])
    else:
        pairs = synthetic.sample_multiturn_token_requests(
            workload[1], turns=workload[2], vocab=vocab)
    return pairs, [RuntimeRequest(request=r, prompt_tokens=p,
                                  max_new_tokens=r.output_len)
                   for r, p in pairs]


def cow_by_hand(eng, pairs, runtime_request):
    """A request repeating the first prompt (its pages cached by an
    earlier run) aliases them; slot 0's first page is then split by
    hand (copy-on-write) before 3 decode rounds.  Returns (tokens,
    cached tokens)."""
    r, p = pairs[0]
    prompt = np.concatenate([np.asarray(p, np.int32),
                             np.array([3, 5, 7], np.int32)])
    rt = runtime_request(prompt, r)
    eng.begin_prefill(rt, 0)
    eng.prefill_step(rt)
    cached = rt.cached_tokens
    eng._cow_block(0, 0)
    for _ in range(3):
        eng.decode_round()
    return list(rt.generated), cached


def _port_rt(prompt, r):
    from repro_torch.core.slo import Request
    from repro_torch.engine.request import RuntimeRequest
    req = Request(req_id=999, task_type=r.task_type, input_len=len(prompt),
                  slo=r.slo, output_len=8)
    return RuntimeRequest(request=req, prompt_tokens=prompt,
                          max_new_tokens=8)


def run_job(eng, job, vocab):
    """Rank 0's side of one job: the engine's results by request."""
    from repro_torch.core.latency_model import PAPER_TABLE2
    from repro_torch.core import policies
    pairs, rts = _requests(job["workload"], vocab)
    if job["kind"] == "loop":
        from repro_torch.serving import ServeLoop
        from repro_torch.data import synthetic
        pairs = synthetic.sample_serve_workload(
            job["workload"][1], vocab, seed=job["workload"][2],
            arrival_rate=50.0)
        loop = ServeLoop(eng, job["policy"], model=PAPER_TABLE2,
                         discipline=job["discipline"])
        loop.start(warm_lengths=[len(p) for _, p in pairs])
        loop.submit_trace(pairs)
        res = loop.serve()
        return {rid: {"tokens": v["tokens"], "preemptions":
                      v["preemptions"]} for rid, v in res.items()}, None
    pol = policies.make(job["policy"], model=PAPER_TABLE2,
                        max_batch=eng.max_slots)
    res = eng.run_policy(rts, pol, discipline=job["discipline"])
    out = {rid: {"tokens": v["tokens"], "preemptions": v["preemptions"],
                 "cached": v["cached"]} for rid, v in res.items()}
    cow = cow_by_hand(eng, pairs, _port_rt) if job.get("cow") else None
    return out, cow


def engine_suite(mesh, jobs):
    """Each job: ``{"cfg", "tree", "engine": kwargs, "kind": "policy" |
    "loop", "policy", "discipline", "workload", "ep", "fsdp", "cow",
    "clock"}`` (``clock``: seconds a timed step, default 1 ms).  Every
    rank builds the engine on its shard; rank 0 runs the job while the
    others follow.  Per job and rank: the op log, the page shapes, every
    param's shape, and on rank 0 the results, ``prefix_stats()`` and the
    copy-on-write count."""
    from repro_torch.engine import engine as engine_mod
    from repro_torch.engine.engine import Engine
    out = []
    for job in jobs:
        engine_mod.time = FixedClock(job.get("clock", 1e-3))
        cfg = job["cfg"]
        par = ParallelismConfig(fsdp=job.get("fsdp", False),
                                expert_parallel=job.get("ep", False),
                                attn_sharding=job.get("attn", "none"))
        params = from_jax_params(job["tree"], CPU, mesh, cfg=cfg,
                                 parallelism=par)
        eng = Engine(cfg, params, device="cpu", mesh=mesh, parallelism=par,
                     **job["engine"])
        log = log_ops(eng)
        whole = init_paged_cache(cfg, eng.max_slots, eng.max_seq_len,
                                 eng.num_blocks, eng.block_size,
                                 device=torch.device("meta"))
        specs = cache_specs(whole, cfg, mesh, par, eng.max_slots)
        rec = {"log": log, "pages": sorted({tuple(v.shape) for layer in
                                            eng.cache["layers"]
                                            for v in layer.values()}),
               "layer_shapes": [{k: tuple(v.shape) for k, v in
                                 layer.items()}
                                for layer in eng.cache["layers"]],
               # the rank's pool: the cache specs' slice of a whole one
               "specs": [local_shape(whole["layers"][0][k].shape,
                                     specs["layers"][0][k], mesh)
                         for k in whole["layers"][0]] ==
               [tuple(v.shape) for v in eng.cache["layers"][0].values()],
               "attn_sharding": eng.ctx.attn_sharding,
               "param_shapes": {p: tuple(t.shape)
                                for p, t in _named(eng.params)},
               "attn_shapes": {k: tuple(v.shape) for k, v in
                               first_attn(eng.params, cfg)["attn"].items()}}
        if mesh.rank != 0:
            eng.follow()
        else:
            rec["results"], rec["cow_tokens"] = run_job(eng, job,
                                                        cfg.vocab_size)
            rec["prefix"] = eng.prefix_stats()
            rec["cow"] = eng.cow_copies
            eng.close()
        rec["replicated"] = replicated_digests(eng.cache, specs)
        out.append(rec)
    return out


def _named(tree, prefix=""):
    """(dotted path, leaf) over a tree of dicts and lists."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _named(v, f"{prefix}{k}.")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _named(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1], tree


def replicated_digests(cache, specs):
    """A digest of each cache array the specs keep whole on every rank
    (MLA latent pages, per-slot SSM state), by layer and name: ranks
    that wrote the same bits give the same digests."""
    import hashlib
    return [{k: hashlib.sha1(_np(v).tobytes()).hexdigest()
             for k, v in layer.items()
             if all(e is None for e in spec[k])}
            for layer, spec in zip(cache["layers"], specs["layers"])]


def fleet_suite(mesh, jobs):
    """Each job: ``{"cfg", "tree", "engine": kwargs, "mapper", "pairs"}``.
    Every rank builds two engines on its shard, the second sharing the
    first's params; rank 0 serves ``pairs`` (a trace of (Request,
    prompt) pairs) through an ``EngineFleet`` of them while the other
    ranks follow both.  Per job and rank: each engine's op log and its
    params' storage (shared or not); on rank 0 each stream's tokens in
    trace order and the instance each request went to."""
    from repro_torch.core.latency_model import PAPER_TABLE2
    from repro_torch.engine import engine as engine_mod
    from repro_torch.engine.engine import Engine
    from repro_torch.serving import EngineFleet
    out = []
    for job in jobs:
        engine_mod.time = FixedClock()
        cfg = job["cfg"]
        par = ParallelismConfig(fsdp=False)
        params = from_jax_params(job["tree"], CPU, mesh, cfg=cfg,
                                 parallelism=par)
        first = Engine(cfg, params, device="cpu", mesh=mesh,
                       parallelism=par, **job["engine"])
        second = Engine(cfg, first.params, device="cpu", mesh=mesh,
                        parallelism=par, **job["engine"])
        engines = [first, second]
        rec = {"logs": [log_ops(eng) for eng in engines],
               "shared": first.params["embed"].data_ptr()
               == second.params["embed"].data_ptr()}
        if mesh.rank != 0:
            first.follow()
        else:
            fleet = EngineFleet(engines, "fcfs", mapper=job["mapper"],
                                model=PAPER_TABLE2)
            streams = fleet.submit_trace(job["pairs"])
            fleet.serve()
            fleet.close()
            rec["tokens"] = [list(st.tokens) for st in streams]
            rec["instances"] = [len(lp.results()) for lp in fleet.loops]
        out.append(rec)
    return out


def diverging_follower(mesh, job):
    """Rank 0 serves ``job`` while rank 1 replays each decode round as a
    bare draw: it skips the round's collectives and waits for rank 0's
    next step, while rank 0 waits in the round's first all_reduce.  The
    group's timeout must end both waits with an error."""
    from repro_torch.engine.engine import Engine
    cfg = job["cfg"]
    params = from_jax_params(job["tree"], CPU, mesh, cfg=cfg,
                             parallelism=ParallelismConfig(fsdp=False))
    eng = Engine(cfg, params, device="cpu", mesh=mesh,
                 parallelism=ParallelismConfig(fsdp=False), **job["engine"])
    if mesh.rank != 0:
        eng._do_decode = lambda tokens, active: eng._do_sample()
        eng.follow()
    else:
        run_job(eng, job, cfg.vocab_size)
        eng.close()


def model_suite(mesh, cases, jobs):
    """:func:`forward_suite` over ``cases``, then :func:`engine_suite`
    over ``jobs``, in one start of the ranks."""
    return {"forwards": forward_suite(mesh, cases)["forwards"],
            "engines": engine_suite(mesh, jobs)}


# ------------------------------------------------------------- rendezvous
def rank_sum(mesh, value):
    """This rank's (rank, coords, the sum over every rank of ``value +
    rank``): one collective over the world the rendezvous joined."""
    import torch.distributed as dist
    t = torch.tensor([float(value + mesh.rank)])
    dist.all_reduce(t, group=mesh.group(("data", "model")))
    return mesh.rank, dict(mesh.coords), float(t)
