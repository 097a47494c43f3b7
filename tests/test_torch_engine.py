"""Port engine vs JAX engine: the same seeded workloads through
``Engine.run_policy`` under fcfs / slo-reanneal / slo-preempt, the index
family (W-index, SJF, EDF) and dynamic-chunk, stalling and
``chunked:16`` prefill, prefix cache on and off, on reduced
``qwen3-1.7b`` in float32.

Per request: identical greedy tokens and the same completion set.  The
SLO policies read the measured engine clock, so their admission order
may differ between the two engines; tokens are compared per request,
never per tick.  Under fcfs, the index policies and dynamic-chunk the
prefix-cache totals (``prefix_stats()``) must match too, and under fcfs,
whose order is clock-free, the cached tokens per request and the
copy-on-write count."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_reduced
from repro.core import policies as jax_policies
from repro.core.latency_model import PAPER_TABLE2 as JAX_MODEL
from repro.data import synthetic as jax_synthetic
from repro.engine.engine import Engine as JaxEngine
from repro.engine.request import RuntimeRequest as JaxRuntimeRequest
from repro.models import init_params
from repro_torch.bridge import from_jax_params
from repro_torch.core import policies
from repro_torch.core.latency_model import PAPER_TABLE2
from repro_torch.data import synthetic
from repro_torch.engine.engine import Engine
from repro_torch.engine.request import RuntimeRequest

torch.set_num_threads(2)
CFG = dataclasses.replace(get_reduced("qwen3-1.7b"), dtype="float32")
SSM_CFG = dataclasses.replace(get_reduced("mamba2-780m"), dtype="float32")
DANUBE_CFG = dataclasses.replace(get_reduced("h2o-danube-1.8b"),
                                 dtype="float32")
ENGINE_KW = dict(max_slots=3, max_seq_len=256)


@pytest.fixture(scope="module")
def params():
    jp = jax.jit(init_params, static_argnums=1)(jax.random.PRNGKey(0), CFG)
    return jp, from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")


def _pairs(syn, workload):
    if workload == "serve":
        return syn.sample_serve_workload(6, CFG.vocab_size, seed=0)
    return syn.sample_multiturn_token_requests(2, turns=3,
                                               vocab=CFG.vocab_size)


def _run(port: bool, params, policy, discipline, prefix, workload):
    syn = synthetic if port else jax_synthetic
    rt_cls = RuntimeRequest if port else JaxRuntimeRequest
    rts = [rt_cls(request=r, prompt_tokens=p, max_new_tokens=r.output_len)
           for r, p in _pairs(syn, workload)]
    if port:
        eng = Engine(CFG, params[1], prefix_cache=prefix, device="cpu",
                     **ENGINE_KW)
        pol = policies.make(policy, model=PAPER_TABLE2, max_batch=3)
    else:
        eng = JaxEngine(CFG, params[0], prefix_cache=prefix, **ENGINE_KW)
        pol = jax_policies.make(policy, model=JAX_MODEL, max_batch=3)
    return eng.run_policy(rts, pol, discipline=discipline), eng


@pytest.mark.parametrize("policy,discipline,prefix,workload", [
    ("fcfs", "stall", True, "serve"),
    ("fcfs", "stall", False, "serve"),
    ("slo-reanneal", "stall", True, "serve"),
    ("slo-preempt", "stall", True, "serve"),
    ("fcfs", "chunked:16", True, "serve"),
    ("fcfs", "stall", True, "multiturn"),
    ("fcfs", "stall", False, "multiturn"),
    ("fcfs", "chunked:16", True, "multiturn"),
    ("index", "stall", True, "serve"),
    ("index:sjf", "stall", True, "serve"),
    ("index:edf", "stall", True, "serve"),
    ("dynamic-chunk", None, True, "serve"),
])
def test_engine_tokens_match_jax(params, policy, discipline, prefix,
                                 workload):
    got, eng = _run(True, params, policy, discipline, prefix, workload)
    want, jeng = _run(False, params, policy, discipline, prefix, workload)
    assert sorted(got) == sorted(want)
    for rid in want:
        assert got[rid]["tokens"] == want[rid]["tokens"], rid
    if policy not in ("slo-reanneal", "slo-preempt"):
        assert eng.prefix_stats() == jeng.prefix_stats()
    if policy == "fcfs":
        assert [got[r]["cached"] for r in sorted(got)] == \
            [want[r]["cached"] for r in sorted(want)]
        assert eng.cow_copies == jeng.cow_copies
    if workload == "multiturn" and prefix:
        assert eng.prefix_stats()["hit_rate"] > 0


def test_warm_up_leaves_engine_cache_untouched(params):
    """Warm-up runs on a scratch pool: the engine's pages, positions and
    block tables are bit-identical before and after."""
    eng = Engine(CFG, params[1], device="cpu", **ENGINE_KW)
    r, p = synthetic.sample_serve_workload(1, CFG.vocab_size, seed=3)[0]
    rt = RuntimeRequest(request=r, prompt_tokens=p, max_new_tokens=4)
    eng.begin_prefill(rt, 0)
    eng.prefill_step(rt)                      # pages now hold a prompt
    eng.decode_round()
    snap = [t.clone() for t in _tensors(eng.cache)]
    toks = torch.ones((1, 64), dtype=torch.int32)
    eng._warm_up(("prefill", 64), eng._prefill_step, toks, 40, 1)
    eng._warm_up(("chunk", 64), eng._chunk_step, toks, 1, 40)
    eng._warm_up(("decode-probe",), eng._decode_step,
                 torch.ones((3, 1), dtype=torch.int32),
                 torch.tensor([True, True, True]))
    assert all(torch.equal(a, b) for a, b in zip(snap, _tensors(eng.cache)))


def _tensors(cache):
    yield cache["pos"]
    yield cache["block_tables"]
    for layer in cache["layers"]:
        yield from layer.values()


def test_entry_points_need_cuda_unless_asked(params):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine(CFG, params[1], **ENGINE_KW)


def _preempt_by_hand(port: bool, params, paged, prefix, discipline,
                     cfg=CFG):
    """Two admitted, one evicted, a third admitted into its slot, a
    second eviction, then the first re-admitted on another slot (and the
    second after it); every step runs the engine's own tick plan.
    Returns the tokens, preemption counts and, after every step, the free
    blocks and the generated counts."""
    syn = synthetic if port else jax_synthetic
    rt_cls = RuntimeRequest if port else JaxRuntimeRequest
    pol = policies if port else jax_policies
    disc = pol.make_discipline(discipline)
    rts = [rt_cls(request=r, prompt_tokens=p, max_new_tokens=14)
           for r, p in syn.sample_serve_workload(3, cfg.vocab_size, seed=5)]
    kw = dict(paged=paged, prefix_cache=prefix, **ENGINE_KW)
    eng = Engine(cfg, params[1], device="cpu", **kw) if port \
        else JaxEngine(cfg, params[0], **kw)
    log = []

    def ticks(n, until=None):
        """``n`` ticks, then more until ``until`` has 3 tokens (a chunked
        prefill takes several ticks: evict only running requests)."""
        while n > 0 or (until is not None and len(until.generated) < 3):
            eng.execute_step(eng.plan_step(disc))
            log.append((eng.pool.available if paged else None,
                        [len(rt.generated) for rt in rts]))
            n -= 1

    a, b, c = rts
    eng.begin_prefill(a, 0)
    eng.begin_prefill(b, 1)
    ticks(4, until=a)
    eng.preempt(a)
    eng.begin_prefill(c, 0)                  # into the evicted slot
    ticks(4, until=c)
    eng.preempt(b)
    eng.begin_prefill(a, 1)                  # back, on another slot
    ticks(3)
    eng.begin_prefill(b, 2)
    while not all(eng.slot_free):
        ticks(1)
    return ([rt.generated for rt in rts], [rt.preemptions for rt in rts],
            log, eng.prefix_stats())


@pytest.fixture(scope="module")
def ssm_params():
    jp = jax.jit(init_params, static_argnums=1)(jax.random.PRNGKey(0),
                                                SSM_CFG)
    return jp, from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")


@pytest.fixture(scope="module")
def danube_params():
    jp = jax.jit(init_params, static_argnums=1)(jax.random.PRNGKey(0),
                                                DANUBE_CFG)
    return jp, from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")


@pytest.mark.parametrize("arch,paged,prefix,discipline", [
    pytest.param("qwen3-1.7b", *row, id="-".join(map(str, row)))
    for row in ((True, True, "stall"), (True, False, "stall"),
                (True, True, "chunked:16"), (False, False, "stall"),
                (False, False, "chunked:16"))] + [
    pytest.param("mamba2-780m", False, False, disc, id=f"mamba2-{disc}")
    for disc in ("stall", "chunked:16")] + [
    pytest.param("h2o-danube-1.8b", True, False, "stall",
                 id="danube-paged-stall")])
def test_preemption_by_hand_matches_jax(request, arch, paged, prefix,
                                        discipline):
    """Reduced qwen3-1.7b on both layouts, Mamba2 on the dense one (its
    conv / SSM state re-prefilled after each eviction), and Danube's
    sliding window on the paged one (no prefix cache for a window)."""
    if arch == "mamba2-780m":
        params, cfg = request.getfixturevalue("ssm_params"), SSM_CFG
    elif arch == "h2o-danube-1.8b":
        params, cfg = request.getfixturevalue("danube_params"), DANUBE_CFG
    else:
        params, cfg = request.getfixturevalue("params"), CFG
    got = _preempt_by_hand(True, params, paged, prefix, discipline, cfg)
    want = _preempt_by_hand(False, params, paged, prefix, discipline, cfg)
    assert got == want
    tokens, preemptions, _, stats = got
    assert preemptions == [1, 1, 0] and all(len(t) == 14 for t in tokens)
    assert stats["enabled"] is (paged and prefix)
    if stats["enabled"]:
        assert stats["hit_rate"] > 0          # re-admissions hit the index
