"""The port's streaming serving loop (``repro_torch.serving``) against
the JAX ``ServeLoop``, and the reference's serving-loop checks on the
port, on reduced ``qwen3-1.7b`` (and ``mamba2-780m``) in float32 on the
CPU.

Per request: identical greedy tokens and the same completion set.  The
SLO policies and the arrivals read the wall clock, so admission order
and preemption counts may differ between the two loops (and between
two runs of one); tokens are compared per request, never per tick.
Overlapped (one round in flight) and synchronous loops emit identical
tokens, a preemption while a round is in flight included: the
overshoot token of the evicted request is dropped at readback."""
import ast
import dataclasses
import inspect
import textwrap
import threading

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_reduced
from repro.core.latency_model import PAPER_TABLE2 as JAX_MODEL
from repro.data import synthetic as jax_synthetic
from repro.engine.engine import Engine as JaxEngine
from repro.models import init_params
from repro.serving import ServeLoop as JaxServeLoop
from repro_torch.bridge import from_jax_params
from repro_torch.core.latency_model import PAPER_TABLE2
from repro_torch.core.policies import Decision
from repro_torch.core.slo import SLO, Request
from repro_torch.data import synthetic
from repro_torch.data.traces import sample_trace_workload
from repro_torch.engine.engine import Engine
from repro_torch.engine.request import RuntimeRequest
from repro_torch.serving import EngineFleet, ServeLoop
from repro_torch.serving import loop as loop_mod

torch.set_num_threads(2)
CFG = dataclasses.replace(get_reduced("qwen3-1.7b"), dtype="float32")
SSM_CFG = dataclasses.replace(get_reduced("mamba2-780m"), dtype="float32")
ENGINE_KW = dict(max_slots=4, max_seq_len=256)


def _bridged(cfg):
    jp = jax.jit(init_params, static_argnums=1)(jax.random.PRNGKey(0), cfg)
    return jp, from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")


@pytest.fixture(scope="module")
def params():
    return _bridged(CFG)


def _engine(params, cfg=CFG, **kw):
    return Engine(cfg, params[1], device="cpu", **{**ENGINE_KW, **kw})


def _serve(port, params, cfg=CFG, paged=True, discipline=None,
           policy="fcfs", overlap=True, n=6):
    """One seeded Poisson trace through a fresh loop of either package:
    ``({req_id: tokens}, loop)``."""
    syn = synthetic if port else jax_synthetic
    pairs = syn.sample_serve_workload(n, cfg.vocab_size, seed=0,
                                      arrival_rate=50.0)
    if port:
        loop = ServeLoop(_engine(params, cfg, paged=paged), policy,
                         model=PAPER_TABLE2, discipline=discipline,
                         overlap=overlap)
    else:
        loop = JaxServeLoop(JaxEngine(cfg, params[0], paged=paged,
                                      **ENGINE_KW), policy,
                            model=JAX_MODEL, discipline=discipline,
                            overlap=overlap)
    loop.start(warm_lengths=[len(p) for _, p in pairs])
    loop.submit_trace(pairs)
    res = loop.serve()
    assert len(res) == n
    return {rid: v["tokens"] for rid, v in res.items()}, loop


@pytest.mark.parametrize("policy", ["fcfs", "slo-preempt"])
@pytest.mark.parametrize("discipline", ["stall", "chunked:16"])
@pytest.mark.parametrize("paged", [True, False])
def test_serve_loop_tokens_match_jax(params, paged, discipline, policy):
    got, loop = _serve(True, params, paged=paged, discipline=discipline,
                       policy=policy)
    want, _ = _serve(False, params, paged=paged, discipline=discipline,
                     policy=policy)
    assert sorted(got) == sorted(want)
    for rid in want:
        assert got[rid] == want[rid], rid
    assert loop.eng.paged is paged
    assert loop.metrics.summary()["overlap_frac"] > 0


def test_ssm_serve_loop_tokens_match_jax():
    ssm = _bridged(SSM_CFG)
    got, loop = _serve(True, ssm, cfg=SSM_CFG, n=4)
    want, _ = _serve(False, ssm, cfg=SSM_CFG, n=4)
    assert got == want
    assert not loop.eng.paged


# ------------------------------------------- the reference's loop checks
def _prompts(n, seed=0, lo=8, hi=40):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, CFG.vocab_size,
                         int(rng.integers(lo, hi))).astype(np.int32)
            for _ in range(n)]


def _run(params, overlap=True, paged=True, prompts=(), max_new=5,
         rate_gap=0.002, policy="fcfs", **loop_kw):
    eng = _engine(params, paged=paged, num_blocks=64 if paged else None)
    loop = ServeLoop(eng, policy, overlap=overlap, **loop_kw)
    loop.start(warm_lengths=[len(p) for p in prompts])
    streams = [loop.submit(p, max_new_tokens=max_new,
                           slo=SLO(ttft=100.0, tpot=10.0),
                           arrival_time=i * rate_gap)
               for i, p in enumerate(prompts)]
    res = loop.serve()
    return loop, streams, res


@pytest.mark.parametrize("paged", [False, True])
def test_overlap_sync_token_parity(params, paged):
    prompts = _prompts(7, seed=3)
    _, s_sync, _ = _run(params, overlap=False, paged=paged,
                        prompts=prompts)
    loop, s_over, _ = _run(params, overlap=True, paged=paged,
                           prompts=prompts)
    for a, b in zip(s_sync, s_over):
        assert a.tokens == b.tokens and len(a.tokens) == 5
    assert loop.metrics.summary()["overlap_frac"] > 0


def test_stream_metrics_agree_with_engine_accounting(params):
    _, streams, res = _run(params, prompts=_prompts(6, seed=4))
    for st in streams:
        row = res[st.req_id]
        assert st.ttft() == pytest.approx(row["ttft"], abs=0.05)
        assert st.e2e() == pytest.approx(row["e2e"], abs=0.05)
        assert st.tokens == row["tokens"]
        assert sum(st.tbts()) == pytest.approx(st.e2e() - st.ttft(),
                                               abs=1e-9)


def test_arrival_pacing_on_wall_clock(params):
    loop = ServeLoop(_engine(params), "fcfs")
    loop.start(warm_lengths=[16])
    prompts = _prompts(2, seed=5, lo=16, hi=17)
    t_arr = 0.15
    early = loop.submit(prompts[0], max_new_tokens=3, arrival_time=0.0)
    late = loop.submit(prompts[1], max_new_tokens=3, arrival_time=t_arr)
    loop.serve()
    assert early.events[0].t < t_arr
    assert late.submit_time == pytest.approx(t_arr, abs=0.06)
    assert late.events[0].t >= t_arr


def test_dispatch_widths_are_pow2_buckets(params):
    loop, _, _ = _run(params, prompts=_prompts(3, seed=6), max_new=6,
                      rate_gap=0.0)
    widths = {g.dispatch_width for g in loop.metrics.gauges
              if g.dispatch_width > 0}
    assert widths and all(w & (w - 1) == 0 and w <= 4 for w in widths)
    assert {("dispatch", w) for w in (1, 2, 4)} <= loop.eng._warm
    loop1, _, _ = _run(params, prompts=_prompts(1, seed=7), max_new=6)
    assert {g.dispatch_width for g in loop1.metrics.gauges
            if g.dispatch_width > 0} == {1}


def test_dense_loop_dispatches_the_whole_pool(params):
    """Buckets follow the layout: a dense engine's round always spans
    the whole slot pool, and only that width warms."""
    loop, _, _ = _run(params, paged=False, prompts=_prompts(1, seed=7),
                      max_new=6)
    assert {g.dispatch_width for g in loop.metrics.gauges
            if g.dispatch_width > 0} == {4}
    assert {k for k in loop.eng._warm if k[0] == "dispatch"} == \
        {("dispatch", 4)}


def test_loop_device_work_runs_under_its_stream(params, monkeypatch):
    """Warm-up, prefill, dispatch and delivery (which frees blocks) all
    run inside the loop's stream context: on the card that stream is
    the loop's own, so fleet members never wait on each other's
    rounds.  Here the context is counted, and every engine entry point
    the loop reaches must find it entered."""
    loop = ServeLoop(_engine(params), "fcfs")
    assert loop._stream is None                  # no stream on the CPU
    depth, calls = [0], []

    class Ctx:
        def __enter__(self):
            depth[0] += 1

        def __exit__(self, *exc):
            depth[0] -= 1
    monkeypatch.setattr(loop, "_on_stream", Ctx)
    eng = loop.eng
    for name in ("dispatch_decode", "prefill_step", "finish_slot",
                 "_warm_up"):
        real = getattr(eng, name)

        def wrapped(*a, _real=real, _name=name, **k):
            calls.append((_name, depth[0]))
            return _real(*a, **k)
        monkeypatch.setattr(eng, name, wrapped)
    loop.start(warm_lengths=[16])
    streams = [loop.submit(p, max_new_tokens=4)
               for p in _prompts(3, seed=22, lo=10, hi=20)]
    for _ in range(3):
        loop.tick()
    loop.drain()
    loop.serve()
    assert all(st.done and len(st.tokens) == 4 for st in streams)
    assert {n for n, _ in calls} == {"dispatch_decode", "prefill_step",
                                     "finish_slot", "_warm_up"}
    assert all(d == 1 for _, d in calls), calls


def test_preemptive_policy_completes_all(params):
    from repro_torch.core.latency_model import LinearLatencyModel
    model = LinearLatencyModel(alpha_p=1e-6, beta_p=1e-4, gamma_p=1e-5,
                               delta_p=2e-3, alpha_d=1e-7, beta_d=1e-4,
                               gamma_d=1e-6, delta_d=1e-3)
    eng = _engine(params, max_slots=2, num_blocks=64)
    loop = ServeLoop(eng, "slo-preempt", model=model)
    loop.start()
    streams = [loop.submit(p, max_new_tokens=24, slo=SLO(e2e=60.0),
                           task_type="code", arrival_time=0.0)
               for p in _prompts(2, seed=8, lo=24, hi=40)]
    streams += [loop.submit(p, max_new_tokens=3,
                            slo=SLO(ttft=0.03, tpot=0.05),
                            arrival_time=0.02 + i * 0.01)
                for i, p in enumerate(_prompts(3, seed=9, lo=8, hi=16))]
    assert len(loop.serve()) == 5
    for st, want in zip(streams, [24, 24, 3, 3, 3]):
        assert st.done and st.error is None and len(st.tokens) == want


def test_unservable_request_is_rejected(params):
    eng = _engine(params, num_blocks=8, block_size=16)
    loop = ServeLoop(eng, "fcfs")
    loop.start()
    ok = loop.submit(_prompts(1, seed=10, lo=16, hi=17)[0],
                     max_new_tokens=4)
    big = loop.submit(np.zeros(100, np.int32), max_new_tokens=60)
    loop.serve()
    assert ok.done and ok.error is None and len(ok.tokens) == 4
    assert big.error is not None and big.tokens == []
    s = loop.metrics.summary()
    assert s["rejected"] == 1 and s["n"] == 1


def test_summary_and_gauges_sanity(params):
    loop, _, _ = _run(params, prompts=_prompts(6, seed=11))
    s = loop.metrics.summary()
    assert s["n"] == 6 and s["tokens"] == 30
    assert 0.0 <= s["attainment"] <= 1.0
    assert s["overlap_frac"] > 0.0 and s["tokens_per_s"] > 0
    assert s["queue_depth_max"] >= 0
    rows = loop.metrics.rows()
    assert rows and rows[0][0] == "serve_summary"


def test_chunked_discipline_streams_end_to_end(params):
    prompts = _prompts(5, seed=20, lo=20, hi=40)
    _, s_stall, _ = _run(params, prompts=prompts)
    loop, s_chunk, res = _run(params, prompts=prompts,
                              discipline="chunked:16")
    assert loop.disc.chunk_size == 16 and len(res) == len(prompts)
    for a, b in zip(s_stall, s_chunk):
        assert b.done and b.error is None
        assert a.tokens == b.tokens and len(b.tokens) == 5
    gauges = loop.metrics.gauges
    assert sum(g.prefill_tokens for g in gauges) >= \
        sum(len(p) for p in prompts)
    assert any(g.prefilling > 0 for g in gauges)


def test_chunked_engine_default_adopted_and_dynamic_chunk_streams(params):
    assert ServeLoop(_engine(params, chunked_prefill=16),
                     "fcfs").disc.chunk_size == 16
    loop = ServeLoop(_engine(params, num_blocks=64), "dynamic-chunk",
                     model=PAPER_TABLE2)
    assert loop.disc is loop.pol.discipline      # identity: retune flows
    loop.start()
    streams = [loop.submit(p, max_new_tokens=4,
                           slo=SLO(ttft=100.0, tpot=10.0))
               for p in _prompts(4, seed=21, lo=20, hi=40)]
    loop.serve()
    for st in streams:
        assert st.done and st.error is None and len(st.tokens) == 4


def test_stream_iteration_from_other_thread(params):
    loop = ServeLoop(_engine(params), "fcfs")
    loop.start(warm_lengths=[16])
    seen = []
    st = loop.submit(_prompts(1, seed=12, lo=16, hi=17)[0],
                     max_new_tokens=4)
    reader = threading.Thread(
        target=lambda: seen.extend(ev.token for ev in st))
    reader.start()
    loop.serve()
    reader.join(timeout=5)
    assert not reader.is_alive()
    assert seen == st.tokens and len(seen) == 4


@pytest.mark.parametrize("source", ["synthetic", "traces"])
def test_trace_replay(params, source):
    """A ``(Request, prompt_tokens)`` trace replays through
    ``submit_trace``: the synthetic serve workload, and the in-repo
    ShareGPT length histograms of ``data.traces``."""
    if source == "synthetic":
        pairs = synthetic.sample_serve_workload(
            4, CFG.vocab_size, seed=13, arrival_rate=200.0,
            in_range=(8, 24), out_range=(3, 6))
    else:
        pairs = sample_trace_workload(4, CFG.vocab_size, rate=200.0,
                                      seed=13, max_input=40, max_output=6)
    loop = ServeLoop(_engine(params), "fcfs")
    loop.start(warm_lengths=[len(p) for _, p in pairs])
    loop.submit_trace(pairs)
    res = loop.serve()
    assert len(res) == 4
    for (r, _), v in zip(pairs, (res[i] for i in sorted(res))):
        assert "met_wall" in v and len(v["tokens"]) == \
            r.planning_output_len()


# ------------------------------------------------------ dispatch_decode
def _admitted(eng, n, seed=14):
    rts = []
    for slot, p in enumerate(_prompts(n, seed=seed, lo=10, hi=30)):
        rt = RuntimeRequest(request=Request(
            req_id=slot, task_type="chat", input_len=len(p), slo=SLO(),
            output_len=32), prompt_tokens=p, max_new_tokens=32)
        eng.prefill(rt, slot)
        rts.append(rt)
    return rts


@pytest.mark.parametrize("paged,width,n", [(True, 1, 1), (True, 2, 2),
                                           (True, 4, 3), (False, None, 3)])
def test_dispatch_decode_matches_decode_round(params, paged, width, n):
    """Chained fused decode+sample rounds at a pow-2 width (the feed
    written from the previous round's device output) emit the greedy
    tokens of ``decode_round`` and leave the same positions."""
    ref = _engine(params, paged=paged)
    want = _admitted(ref, n)
    eng = _engine(params, paged=paged)
    got = _admitted(eng, n)
    feed = torch.zeros((4, 1), dtype=torch.int32)
    active = np.zeros(4, bool)
    active[:n] = True
    for s, rt in enumerate(got):
        feed[s, 0] = rt.generated[-1]
    w = 4 if width is None else width
    for _ in range(6):
        ref.decode_round()
        toks = eng.dispatch_decode(feed, active, width=width)
        assert toks.shape == (w,) and toks.dtype == torch.int32
        feed[:w, 0] = toks
        for s, rt in enumerate(got):
            rt.generated.append(int(toks[s]))
    assert [rt.generated for rt in got] == [rt.generated for rt in want]
    assert torch.equal(eng.cache["pos"], ref.cache["pos"])
    if paged:
        with pytest.raises(ValueError, match="dispatch width"):
            eng.dispatch_decode(feed, np.ones(4, bool), width=w // 2 or 1)


def _code(fn):
    """Source of ``fn`` without its docstring."""
    tree = ast.parse(textwrap.dedent(inspect.getsource(fn)))
    body = tree.body[0].body
    if body and isinstance(body[0], ast.Expr) and \
            isinstance(body[0].value, ast.Constant):
        body.pop(0)
    return ast.unparse(tree)


@pytest.mark.parametrize("fn", [Engine.dispatch_decode,
                                Engine._decode_dispatch,
                                Engine._slice_slots, Engine._decode_step,
                                Engine._cow_guard,
                                ServeLoop._dispatch_round,
                                loop_mod._queue_readback],
                         ids=lambda f: f.__name__)
def test_dispatch_reads_nothing_to_the_host(fn):
    """A dispatched round queues work and returns: nothing on its path
    reads a device value back or waits for the device."""
    code = _code(fn)
    for call in (".item(", ".tolist(", ".cpu(", ".numpy(", "synchronize(",
                 "np.asarray(t", "int(t"):
        assert call not in code, (fn.__name__, call)


def test_consume_waits_on_its_ticket_only():
    code = _code(ServeLoop._consume)
    assert "ticket.done.synchronize()" in code
    assert code.count("synchronize(") == 1 and ".cpu(" not in code
    assert "torch.cuda" not in code and "self.eng" not in code


def test_warm_dispatch_touches_no_host_readback(params, monkeypatch):
    """At run time too: once its width is warm, a dispatch calls no
    readback and no device synchronize (they raise here)."""
    eng = _engine(params)
    _admitted(eng, 2)
    feed = torch.zeros((4, 1), dtype=torch.int32)
    active = np.array([True, True, False, False])
    eng.dispatch_decode(feed, active, width=2)             # warms width 2

    def refuse(*a, **k):
        raise AssertionError("host readback inside dispatch_decode")
    for name in ("item", "tolist", "cpu", "numpy"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    monkeypatch.setattr("repro_torch.engine.engine.synchronize", refuse)
    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    toks = eng.dispatch_decode(feed, active, width=2, lookahead=1)
    monkeypatch.undo()
    assert toks.shape == (2,)


# -------------------------------------------- preemption with a round out
class _EvictOnce:
    """FCFS admission; the first time an ``urgent`` request waits with no
    slot free, evict the running request in the lowest slot."""
    preemptive = True

    def __init__(self):
        self.evicted = False

    def decide(self, view):
        evict = []
        if not self.evicted and view.free == 0 and view.active and any(
                r.task_type == "urgent" for r in view.pending):
            self.evicted = True
            evict = [0]
        return Decision(admit=list(range(len(view.pending))), preempt=evict)


def _preempt_run(params, overlap, paged):
    eng = _engine(params, max_slots=2, paged=paged)
    loop = ServeLoop(eng, _EvictOnce(), overlap=overlap)
    in_flight = []
    real_preempt = eng.preempt

    def preempt(rt):
        # the victim rides the round still in flight: its token from
        # that round must be dropped at readback
        in_flight.append(loop._inflight is not None and any(
            r is rt for _, r, _ in loop._inflight.parts))
        real_preempt(rt)
    eng.preempt = preempt
    # participants of consumed rounds vs tokens delivered: the difference
    # is the tokens dropped at readback
    seen = {"parts": 0, "delivered": 0}
    real_consume, real_deliver = loop._consume, loop._deliver

    def consume(ticket):
        seen["parts"] += len(ticket.parts)
        real_consume(ticket)

    def deliver(rt, tok, t):
        seen["delivered"] += 1
        real_deliver(rt, tok, t)
    loop._consume, loop._deliver = consume, deliver
    loop.start(warm_lengths=[32])
    streams = [loop.submit(p, max_new_tokens=12, task_type="code")
               for p in _prompts(2, seed=15, lo=20, hi=32)]
    for _ in range(4):
        loop.tick()
    streams.append(loop.submit(_prompts(1, seed=16, lo=10, hi=20)[0],
                               max_new_tokens=4, task_type="urgent"))
    res = loop.serve()
    return ([st.tokens for st in streams], res, in_flight,
            seen["parts"] - seen["delivered"])


@pytest.mark.parametrize("paged", [True, False])
def test_preemption_with_a_round_in_flight(params, paged):
    got, res, in_flight, dropped = _preempt_run(params, True, paged)
    want, _, sync_flight, sync_dropped = _preempt_run(params, False, paged)
    assert in_flight == [True] and sync_flight == [False]
    assert dropped == 1 and sync_dropped == 0
    assert sum(v["preemptions"] for v in res.values()) == 1
    assert got == want and [len(t) for t in got] == [12, 12, 4]


# ----------------------------------------------------------------- fleet
@pytest.mark.parametrize("mapper", ["least-loaded", "round-robin"])
def test_fleet_completes_every_request(params, mapper):
    def trace():
        return synthetic.sample_serve_workload(6, CFG.vocab_size, seed=17,
                                               in_range=(8, 24),
                                               out_range=(3, 6))
    pairs = trace()
    single = ServeLoop(_engine(params, max_slots=2), "fcfs")
    single.start(warm_lengths=[len(p) for _, p in pairs])
    want = single.submit_trace(pairs)
    single.serve()
    want = [st.tokens for st in want]
    fleet = EngineFleet([_engine(params, max_slots=2) for _ in range(2)],
                        "fcfs", mapper=mapper, model=PAPER_TABLE2)
    pairs = trace()
    fleet.start(warm_lengths=[len(p) for _, p in pairs])
    if mapper == "least-loaded":         # online routing, one by one
        streams = [fleet.submit(p, max_new_tokens=r.planning_output_len(),
                                request=r) for r, p in pairs]
    else:
        streams = fleet.submit_trace(pairs)
    res = fleet.serve()
    assert [st.tokens for st in streams] == want
    assert sorted(res) == sorted(st.req_id for st in streams)
    ranges = [{rid // 1_000_000 for rid in lp.results()}
              for lp in fleet.loops]
    assert all(len(r) == 1 for r in ranges if r)
    assert ranges[0] != ranges[1] and all(ranges)
    s = fleet.metrics.summary()
    assert s["n"] == 6 and s["tokens"] == sum(len(t) for t in want)


def test_fleet_ticks_its_loops_in_turn_on_the_calling_thread(params):
    """No thread per loop: each unfinished loop ticks once per pass, on
    the thread that called ``serve()``."""
    fleet = EngineFleet([_engine(params, max_slots=2) for _ in range(2)],
                        "fcfs", mapper="round-robin")
    ticks = []
    for i, lp in enumerate(fleet.loops):
        real = lp.tick

        def tick(_real=real, _i=i):
            ticks.append((_i, threading.get_ident()))
            _real()
        lp.tick = tick
    fleet.start(warm_lengths=[16])
    streams = [fleet.submit(p, max_new_tokens=6, arrival_time=0.0)
               for p in _prompts(4, seed=23, lo=10, hi=20)]
    fleet.serve()
    assert all(st.done and len(st.tokens) == 6 for st in streams)
    assert {t for _, t in ticks} == {threading.get_ident()}
    order = [i for i, _ in ticks]
    # both loops carry two requests of equal length, so they finish on
    # the same pass: strict alternation throughout
    assert order == [0, 1] * (len(order) // 2)


@pytest.mark.parametrize("selector", ["route:annealed", "slo-reanneal:jax"])
def test_batched_annealer_selectors_run(params, selector, monkeypatch):
    """Both reach the batched annealer, on the engines' device (the CPU
    here): the fleet's planning mapper when it routes a trace, the
    policy at each admission event with a queue.  Every request
    completes with its whole output."""
    from repro_torch.core import annealing_torch
    calls = []
    for name in ("priority_mapping_torch", "priority_mapping_multi_torch"):
        real = getattr(annealing_torch, name)

        def spy(*a, _real=real, **kw):
            calls.append(kw["device"])
            return _real(*a, **kw)
        monkeypatch.setattr(annealing_torch, name, spy)
    pairs = synthetic.sample_serve_workload(8, CFG.vocab_size, seed=18,
                                            arrival_rate=50.0)
    if selector == "route:annealed":
        loop = EngineFleet([_engine(params) for _ in range(2)], "fcfs",
                           mapper="annealed", model=PAPER_TABLE2)
    else:
        loop = ServeLoop(_engine(params), selector, model=PAPER_TABLE2)
        assert loop.pol.backend == "jax"
    loop.start(warm_lengths=[len(p) for _, p in pairs])
    streams = loop.submit_trace(pairs)
    res = loop.serve()
    assert len(res) == len(pairs)
    assert all(st.done and len(st.tokens) == r.output_len
               for (r, _), st in zip(pairs, streams))
    assert calls and all(torch.device(d).type == "cpu" for d in calls)
