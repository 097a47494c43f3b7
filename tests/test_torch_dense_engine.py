"""Port dense engine vs JAX dense engine: the same seeded workloads
through ``Engine(paged=False).run_policy`` under fcfs / slo-reanneal /
slo-preempt with stalling and ``chunked:16`` prefill, on reduced
``qwen3-1.7b`` in float32, and on reduced ``h2o-danube-1.8b`` with its
window cut to 64 tokens and prompts longer than the window.

Per request: identical greedy tokens and the same completion set (SLO
policies read the measured engine clock, so ticks are never compared).
Also: a decode round leaves an inactive slot's cache rows and ``pos``
untouched while that slot is mid-chunked-prefill, and warm-up leaves
the engine's cache untouched."""
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
from repro_torch.engine.request import Phase, RuntimeRequest

torch.set_num_threads(2)
QWEN = dataclasses.replace(get_reduced("qwen3-1.7b"), dtype="float32")
# h2o-danube's 4096-token window cut to 64: the ring (64 slots) is shorter
# than the prompts below, so prefill wraps it and decode evicts
DANUBE = dataclasses.replace(get_reduced("h2o-danube-1.8b"),
                             dtype="float32", sliding_window=64)
ENGINE_KW = dict(max_slots=3, max_seq_len=256, paged=False)


def _params(cfg):
    jp = jax.jit(init_params, static_argnums=1)(jax.random.PRNGKey(0), cfg)
    return jp, from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")


@pytest.fixture(scope="module")
def qwen():
    return _params(QWEN)


@pytest.fixture(scope="module")
def danube():
    return _params(DANUBE)


def _workload(syn, cfg, long_prompts):
    # long prompts (70-120 tokens): over the 64-token window, and some
    # whose pow-2 bucket (128) pads past the ring
    kw = dict(in_range=(70, 121)) if long_prompts else {}
    return syn.sample_serve_workload(6, cfg.vocab_size, seed=0, **kw)


def _run(port, params, cfg, policy, discipline, long_prompts=False):
    syn = synthetic if port else jax_synthetic
    rt_cls = RuntimeRequest if port else JaxRuntimeRequest
    rts = [rt_cls(request=r, prompt_tokens=p, max_new_tokens=r.output_len)
           for r, p in _workload(syn, cfg, long_prompts)]
    if port:
        eng = Engine(cfg, params[1], device="cpu", **ENGINE_KW)
        pol = policies.make(policy, model=PAPER_TABLE2, max_batch=3)
    else:
        eng = JaxEngine(cfg, params[0], **ENGINE_KW)
        pol = jax_policies.make(policy, model=JAX_MODEL, max_batch=3)
    return eng.run_policy(rts, pol, discipline=discipline), eng


def _same(got, want):
    assert sorted(got) == sorted(want)
    for rid in want:
        assert got[rid]["tokens"] == want[rid]["tokens"], rid
        assert len(got[rid]["tokens"]) > 0


@pytest.mark.parametrize("policy,discipline", [
    ("fcfs", "stall"),
    ("fcfs", "chunked:16"),
    ("slo-reanneal", "stall"),
    ("slo-reanneal", "chunked:16"),
    ("slo-preempt", "stall"),
    ("slo-preempt", "chunked:16"),
])
def test_dense_engine_tokens_match_jax(qwen, policy, discipline):
    got, eng = _run(True, qwen, QWEN, policy, discipline)
    want, _ = _run(False, qwen, QWEN, policy, discipline)
    _same(got, want)
    assert eng.pool is None and eng.prefix is None and not eng._partial


@pytest.mark.parametrize("discipline", ["stall", "chunked:16"])
def test_dense_engine_window_ring_matches_jax(danube, discipline):
    """Prompts longer than the window: the bucketed whole-prompt prefill
    ring-writes the last 64 *padded* positions (reference behaviour,
    ROADMAP §3), chunks walk at exact length; both as the JAX engine."""
    got, _ = _run(True, danube, DANUBE, "fcfs", discipline,
                  long_prompts=True)
    want, _ = _run(False, danube, DANUBE, "fcfs", discipline,
                   long_prompts=True)
    _same(got, want)


def test_dense_window_prefill_keeps_padded_positions(danube):
    """Reference quirk, reproduced (ROADMAP §3): with a window shorter
    than the prompt, the dense whole-prompt prefill pads the prompt to
    its pow-2 bucket and ring-writes the last ``window`` *padded*
    positions, so pad K/V displaces real tokens and later decode steps
    attend to it.  Chunked prefill (exact lengths) and the paged engine
    keep the real tokens and agree with each other."""
    def run(**kw):
        rts = [RuntimeRequest(request=r, prompt_tokens=p,
                              max_new_tokens=r.output_len)
               for r, p in _workload(synthetic, DANUBE, True)]
        eng = Engine(DANUBE, danube[1], max_slots=3, max_seq_len=256,
                     device="cpu", **kw)
        return {k: v["tokens"] for k, v in eng.run_fcfs(rts).items()}
    paged = run(paged=True)
    assert run(paged=False, chunked_prefill=16) == paged
    assert run(paged=False) != paged


def _tensors(cache):
    yield cache["pos"]
    for layer in cache["layers"]:
        yield from layer.values()


def test_decode_round_freezes_slot_mid_chunked_prefill(qwen):
    """Slot 0 decodes while slot 1 is mid-chunked-prefill: the round
    writes slot 0's row only; slot 1's pool rows and ``pos`` (and the
    idle slot 2's) are bit-identical afterwards."""
    eng = Engine(QWEN, qwen[1], device="cpu", **ENGINE_KW)
    pairs = synthetic.sample_serve_workload(2, QWEN.vocab_size, seed=3)
    a, b = (RuntimeRequest(request=r, prompt_tokens=p, max_new_tokens=8)
            for r, p in pairs)
    eng.begin_prefill(a, 0)
    eng.prefill_step(a)
    eng.begin_prefill(b, 1)
    eng.prefill_step(b, 8)
    assert b.phase is Phase.PREFILLING and 1 in eng._partial
    before = [t.clone() for t in _tensors(eng.cache)]
    n_a = len(a.generated)
    eng.decode_round()
    assert len(a.generated) == n_a + 1 and not b.generated
    after = list(_tensors(eng.cache))
    assert after[0].tolist() == [int(before[0][0]) + 1, 0, 0]
    for old, new in zip(before[1:], after[1:]):
        assert torch.equal(old[1:], new[1:])
        assert not torch.equal(old[0], new[0])
    # the chunked prefill then completes and joins the decode rounds
    while b.phase is Phase.PREFILLING:
        eng.prefill_step(b, 8)
    assert b.generated and int(eng.cache["pos"][1]) == len(pairs[1][1])


def test_dense_warm_up_leaves_engine_cache_untouched(qwen):
    """Warm-up runs on scratch caches: the engine's rings and positions
    are bit-identical before and after."""
    eng = Engine(QWEN, qwen[1], device="cpu", **ENGINE_KW)
    r, p = synthetic.sample_serve_workload(1, QWEN.vocab_size, seed=3)[0]
    rt = RuntimeRequest(request=r, prompt_tokens=p, max_new_tokens=4)
    eng.begin_prefill(rt, 0)
    eng.prefill_step(rt)
    eng.decode_round()
    snap = [t.clone() for t in _tensors(eng.cache)]
    eng._warm_up(("decode-probe",), eng._decode_step,
                 torch.ones((3, 1), dtype=torch.int32),
                 torch.tensor([True, True, True]))
    eng._warm_up(("prefill-probe",),
                 lambda _s, t: eng._prefill_one(t, 40),
                 torch.ones((1, 64), dtype=torch.int32))
    assert all(torch.equal(a, b) for a, b in zip(snap, _tensors(eng.cache)))
