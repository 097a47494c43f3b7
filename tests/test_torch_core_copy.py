"""The port's copies of the framework-free scheduling core schedule
exactly as the reference ``repro.core`` does: the same annealed
permutation and G, the same policy decisions on the same view, the same
discrete-event results, and the same block-pool / prefix-index state
under one operation sequence.  The batched-annealer selectors run on the
port's annealer (``core/annealing_torch.py``) where the reference runs
its JAX one: the same memory-greedy assignment, annealed plans no worse
than their starting solutions, and source that differs from the
reference only in the annealer's names and the ``device`` it runs on.
The trace sampler and the serving loop's token streams and metrics are
verbatim copies (import paths rewritten), and replay and summarize
alike."""
import importlib
import pathlib
import re

import numpy as np
import pytest

PKGS = ("repro", "repro_torch")


def _mods(pkg):
    return {name: importlib.import_module(f"{pkg}.{name}") for name in (
        "core", "core.slo", "core.policies", "core.latency_model",
        "core.annealing", "core.events", "data.synthetic", "engine.blocks",
        "engine.prefix", "data.traces", "serving.metrics",
        "serving.stream")}


def _annealed(m):
    reqs = m["data.synthetic"].sample_requests(24, seed=3)
    res = m["core.annealing"].priority_mapping(
        m["core.slo"].as_arrays(reqs), m["core.latency_model"].PAPER_TABLE2,
        8, m["core.annealing"].SAParams(seed=0))
    return (res.perm.tolist(), res.batch_id.tolist(), res.G,
            res.evaluations, res.early_exit)


def _view(m):
    """Six pending requests (two with tight TTFT SLOs) against two
    loose-SLO running ones on a full paged executor: slo-preempt
    evicts."""
    slo, pol = m["core.slo"], m["core.policies"]
    model = m["core.latency_model"].PAPER_TABLE2
    reqs = m["data.synthetic"].sample_requests(8, seed=11)
    for r in reqs[:2]:
        r.slo = slo.SLO(ttft=0.2, tpot=0.2)
        r.submit_time = 1.4
    for r in reqs[6:]:
        r.slo = slo.SLO(e2e=1e3)
    active = tuple(pol.make_active_view(
        r, generated=12, remaining=r.output_len - 12,
        context_len=r.input_len + 12, now=1.5, ttft=0.9, e2e_base=0.0,
        batch=2, model=model, blocks_held=6) for r in reqs[6:])
    return pol.SchedulerView(
        pending=tuple(reqs[:6]), active=active, now=1.5, free=0,
        max_batch=3, discipline=pol.StallingPrefill(), free_blocks=20,
        total_blocks=64, block_size=16, pages_per_slot=128), model


def _decide(m, policy):
    view, model = _view(m)
    pol = m["core.policies"].make(policy, model=model, max_batch=3)
    dec = pol.decide(view)
    return list(dec.admit), list(dec.preempt)


def _simulated(m, policy, discipline):
    reqs = m["data.synthetic"].sample_requests(20, seed=4)
    rng = np.random.default_rng(0)
    t = 0.0
    for i, r in enumerate(reqs):
        t += float(rng.exponential(0.3))
        r.arrival_time = t
        if i % 3 == 2:                 # tight arrivals: preemption bait
            r.slo = m["core.slo"].SLO(ttft=1.0, tpot=0.2)
    res = m["core.events"].simulate(
        reqs, m["core.latency_model"].PAPER_TABLE2, 2, policy,
        discipline=discipline, noise_sigma=0.05,
        rng=np.random.default_rng(1))
    return (res.e2e, res.ttft, res.met, res.preemptions)


def _pool_and_index(m):
    pool = m["engine.blocks"].BlockPool(24)
    idx = m["engine.prefix"].RadixPrefixIndex(pool, 4)
    rng = np.random.default_rng(2)
    sys_prompt = rng.integers(0, 50, 12).tolist()
    log = []
    for i in range(6):
        toks = sys_prompt + rng.integers(0, 50, 4 + i).tolist()
        got = idx.match(toks, max_tokens=len(toks) - 1)
        pool.share(got)
        fresh = pool.alloc(-(-len(toks) // 4) - len(got))
        idx.insert(toks, got + fresh, max_tokens=len(toks))
        log.append((got, fresh, pool.available, len(idx),
                    idx.reclaimable()))
        if i % 2:
            pool.release(got + fresh)
    log.append((idx.evict(3), pool.available, len(idx), idx.hit_rate))
    return log


def _trace(m):
    pairs = m["data.traces"].sample_trace_workload(
        12, 500, rate=4.0, process="bursty", seed=5, max_input=300)
    return [(r.req_id, r.task_type, r.input_len, r.output_len,
             r.arrival_time, (r.slo.ttft, r.slo.tpot, r.slo.e2e), p.tolist())
            for r, p in pairs]


def _served(m):
    """Token streams and metrics fed one scripted serving run: pushes at
    fixed wall times, a rejection, gauges."""
    met, stream = m["serving.metrics"], m["serving.stream"]
    sink = met.ServingMetrics()
    reqs = m["data.synthetic"].sample_requests(5, seed=6)
    for i, r in enumerate(reqs):
        st = stream.TokenStream(r.req_id)
        st.submit_time = 0.1 * i
        for k in range(3 + i):
            st.push(k, 0.1 * i + 0.05 * (k + 1) ** 1.5)
        st.close(1.0 + i)
        sink.on_finish(r, met.RequestTimeline(
            req_id=r.req_id, task_type=r.task_type, arrival=r.arrival_time,
            submit=st.submit_time, first_token=st.events[0].t,
            finish=st.events[-1].t, n_tokens=len(st.events), tbt=st.tbts(),
            preemptions=i % 2))
        sink.on_gauge(met.StepGauge(t=0.1 * i, queue_depth=4 - i, active=i,
                                    free_blocks=10 - i, dispatch_width=2,
                                    overlapped=bool(i % 2),
                                    prefill_tokens=16 * (i % 3)))
    sink.on_finish(reqs[0], met.RequestTimeline(
        req_id=99, task_type="chat", arrival=0.0, submit=0.0,
        first_token=None, finish=None, n_tokens=0, tbt=[], rejected=True))
    both = met.ServingMetrics.aggregate([sink, met.ServingMetrics()])
    return sink.summary(), sink.rows(), both.summary(), sink.met(0)


CASES = {
    "priority_mapping": _annealed,
    "decide-fcfs": lambda m: _decide(m, "fcfs"),
    "decide-slo-reanneal": lambda m: _decide(m, "slo-reanneal"),
    "decide-slo-preempt": lambda m: _decide(m, "slo-preempt"),
    "simulate-fcfs": lambda m: _simulated(m, "fcfs", "stall"),
    "simulate-slo-reanneal-chunked": lambda m: _simulated(
        m, "slo-reanneal", "chunked:64"),
    "simulate-slo-preempt": lambda m: _simulated(m, "slo-preempt", "stall"),
    "block-pool-and-prefix-index": _pool_and_index,
    "trace-workload": _trace,
    "serving-metrics": _served,
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_copy_schedules_identically(case):
    ref, port = (CASES[case](_mods(pkg)) for pkg in PKGS)
    assert port == ref


SRC = pathlib.Path(__file__).resolve().parents[1] / "src"


@pytest.mark.parametrize("module", ["data/traces.py", "serving/stream.py",
                                    "serving/metrics.py"])
def test_verbatim_copies(module):
    ref = (SRC / "repro" / module).read_text()
    assert (SRC / "repro_torch" / module).read_text() == \
        re.sub(r"\brepro\.", "repro_torch.", ref)


def _starts_g(m, reqs, model, mb):
    """The better of Algorithm 1's two starting solutions' G."""
    obj = m["core.objective"]
    arrays = m["core.slo"].as_arrays(reqs)
    return max(obj.evaluate(arrays, model, *obj.fcfs_schedule(len(reqs),
                                                              mb)).G,
               obj.evaluate(arrays, model, *obj.sorted_by_e2e_schedule(
                   arrays, model, mb)).G)


@pytest.mark.parametrize("selector", [
    "slo-reanneal:jax", "scheduler-use-jax", "route:annealed"])
def test_batched_annealer_selectors_run(selector):
    """Each selector that reaches the JAX annealer in the reference runs
    on the port's annealer on the CPU: the memory-greedy assignment is
    the reference's exactly (it draws no random numbers), and every
    instance's annealed plan scores (numpy ``evaluate``) no lower than
    its starting solutions."""
    ref, port = _mods("repro"), _mods("repro_torch")
    for m in (ref, port):
        m["core.objective"] = importlib.import_module(
            m["core"].__name__ + ".objective")
    model = port["core.latency_model"].PAPER_TABLE2
    jmodel = ref["core.latency_model"].PAPER_TABLE2
    reqs = port["data.synthetic"].sample_requests(20, seed=9)
    jreqs = ref["data.synthetic"].sample_requests(20, seed=9)
    obj, as_arrays = port["core.objective"], port["core.slo"].as_arrays
    # finite memory, so the memory-greedy assignment spreads the requests
    mem, jmem = (importlib.import_module(m["core"].__name__ + ".profiler")
                 .MemoryModel(total_memory=1e6) for m in (port, ref))
    if selector == "slo-reanneal:jax":
        pol = port["core.policies"].make(selector, model=model, max_batch=4,
                                         device="cpu")
        assert pol.backend == "jax" and pol.device == "cpu"
        # the policy admits in the annealed order, and the annealed
        # schedule scores no lower than the starting solutions
        from repro_torch.core.annealing_torch import priority_mapping_torch
        arrays = as_arrays(reqs)
        perm, bid, _ = priority_mapping_torch(arrays, model, 4, pol._jax_cfg,
                                              seed=0, device="cpu")
        assert pol._anneal_perm(arrays) == perm.tolist()
        assert sorted(perm.tolist()) == list(range(20))
        assert obj.evaluate(arrays, model, perm, bid).G >= \
            _starts_g(port, reqs, model, 4) * (1 - 1e-5)
        view, _ = _view(port)
        dec = pol.decide(view)
        assert sorted(dec.admit) == list(range(len(view.pending)))
        return
    if selector == "scheduler-use-jax":
        sched = port["core"].SLOAwareScheduler(
            model, num_instances=2, max_batch=4, memory=mem, use_jax=True,
            device="cpu")
        want = ref["core"].SLOAwareScheduler(
            jmodel, num_instances=2, max_batch=4, memory=jmem,
            use_jax=True).schedule(jreqs).assignment
    else:
        mapper = port["core.policies"].make(selector, model=model,
                                            max_batch=4, memory=mem,
                                            device="cpu")
        states = [port["core.policies"].InstanceState(instance_id=i)
                  for i in range(2)]
        jstates = [ref["core.policies"].InstanceState(instance_id=i)
                   for i in range(2)]
        got = mapper.map_batch(reqs, states)
        assert got == ref["core.policies"].make(
            selector, model=jmodel, max_batch=4, memory=jmem).map_batch(
                jreqs, jstates)
        orders = mapper.plan(reqs, states)
        assert [sorted(o) for o in orders] == [
            [k for k, inst in enumerate(got) if inst == i] for i in range(2)]
        want = {r.req_id: i for r, i in zip(jreqs, got)}
        sched = mapper._scheduler(2)
    out = sched.schedule(reqs)
    assert out.assignment == want
    for q in out.queues:
        plan = [r for b in q.batches for r in b]
        sizes = [len(b) for b in q.batches]
        assert len(plan) >= 5 and max(sizes) <= 4
        g = obj.evaluate(as_arrays(plan), model, np.arange(len(plan)),
                         np.repeat(np.arange(len(sizes)), sizes)).G
        assert g >= _starts_g(port, plan, model, 4) * (1 - 1e-5)


def test_core_copies_differ_only_in_the_annealer_and_its_device():
    """policies.py, scheduler.py and core/__init__.py are the
    reference's with import paths rewritten, the JAX annealer's module
    and front ends renamed to the port's, and a ``device`` argument
    passed through to the annealer: with those names mapped back and the
    device arguments taken out, every character but whitespace is the
    reference's."""
    names = (("annealing_torch", "annealing_jax"),
             ("priority_mapping_multi_torch", "priority_mapping_multi_jax"),
             ("priority_mapping_torch", "priority_mapping_jax"))
    device = (",device=None", ",device=self.device", ",device=device",
              "self.device=device")
    for module in ("core/policies.py", "core/scheduler.py",
                   "core/__init__.py"):
        port = (SRC / "repro_torch" / module).read_text()
        for a, b in names:
            port = port.replace(a, b)
        port = re.sub(r"\s+", "", re.sub(r"\brepro_torch\.", "repro.", port))
        n_device = sum(port.count(d) for d in device)
        for d in device:
            port = port.replace(d, "")
        ref = re.sub(r"\s+", "", (SRC / "repro" / module).read_text())
        assert port == ref, module
        assert n_device == {"core/policies.py": 10, "core/scheduler.py": 3,
                            "core/__init__.py": 0}[module]
