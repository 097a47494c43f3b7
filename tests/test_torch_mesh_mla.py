"""MLA under a tensor-parallel mesh: reduced ``deepseek-v2-lite-16b`` in
float32 (4 MLA heads; layer 0 a dense MLP, layer 1 4 experts top-2 and a
shared expert) on two spawned ranks (gloo, CPU) against the JAX package
on one device.

Forwards (tp 4: ``test_torch_mesh_mla_tp4.py``): paged prefill of two
slots (MLA has no chunked path), three decode steps and ``forward_full``
on each rank's 2 heads, within 1e-5 of the JAX logits, every rank's
logits and latent pages bit for bit alike; a 3-head MLA, whose heads do
not divide tp 2, holds the whole block on every rank and runs it
replicated, within the same bound.  The engine: ``Engine(mesh=...)`` on
both MoE branches (expert parallel: 2 of 4 experts a rank; baseline:
every expert) under fcfs and slo-preempt (stalling prefill: MLA has no
chunked path; on a clock of 0.5 s a step, so that it preempts), against
the JAX ``Engine``: identical greedy tokens,
completion sets, preemption counts and ``prefix_stats()``; both ranks
replay the same device steps and end with the same latent pages."""
import concurrent.futures
import dataclasses

import jax
import numpy as np
import pytest

from helpers import torch_mesh_ranks as ranks
from repro.configs import get_reduced
from repro.models import MLAConfig as JaxMLA
from repro.models import ModelConfig as JaxConfig
from repro.models import init_params
from repro_torch.configs import get_reduced as port_reduced
from repro_torch.launch.mesh import spawn
from repro_torch.models.config import MLAConfig as PortMLA
from repro_torch.models.config import ModelConfig as PortConfig
from test_torch_mesh_engine import ENGINE_KW, check_against_jax, jax_job
from test_torch_mesh_model import _close, jax_forwards

ARCH = "deepseek-v2-lite-16b"
MODELS = {
    "deepseek": (dataclasses.replace(get_reduced(ARCH), dtype="float32"),
                 dataclasses.replace(port_reduced(ARCH), dtype="float32")),
}
MLA3 = dict(name="t-mla3", family="dense", num_layers=2, d_model=48,
            num_heads=3, num_kv_heads=3, head_dim=16, d_ff=96,
            vocab_size=96, dtype="float32")
LATENT = dict(kv_lora_rank=32, q_lora_rank=0, qk_nope_head_dim=16,
              qk_rope_head_dim=8, v_head_dim=16)
MODELS["mla3"] = (JaxConfig(**MLA3, mla=JaxMLA(**LATENT)),
                  PortConfig(**MLA3, mla=PortMLA(**LATENT)))
SERVE = dict(kind="policy", model="deepseek", discipline="stall",
             workload=("serve", 5, 2))
# slo-preempt on a clock of 0.5 s a step, slow enough that it preempts
PREEMPT = dict(SERVE, policy="slo-preempt", workload=("serve", 6, 0),
               clock=0.5)
JOBS = {
    "expert-parallel-fcfs": dict(SERVE, policy="fcfs", ep=True),
    "baseline-fcfs": dict(SERVE, policy="fcfs"),
    "expert-parallel-slo-preempt": dict(PREEMPT, ep=True),
    "baseline-slo-preempt": dict(PREEMPT),
}


@pytest.fixture(scope="module")
def trees():
    out = {}
    for name, (cfg, _) in MODELS.items():
        jp = jax.jit(init_params, static_argnums=1)(jax.random.PRNGKey(2),
                                                    cfg)
        out[name] = (jp, jax.tree.map(np.asarray, jp))
    return out


@pytest.fixture(scope="module")
def want(trees):
    return {name: jax_forwards(MODELS[name][0], trees[name][0])
            for name in MODELS}


def spawn_suite(tp, trees, jobs=None):
    cases = [(MODELS[name][1], trees[name][1]) for name in MODELS]
    specs = [dict(job, cfg=MODELS[job["model"]][1],
                  tree=trees[job["model"]][1], engine=ENGINE_KW)
             for job in (jobs or {}).values()]
    return spawn(ranks.model_suite, tp, (cases, specs), device="cpu",
                 threads=1, timeout=60, deadline=240)


def _jax_jobs(params):
    """The JAX engine's run of each policy (one device: no branches)."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for job in JOBS.values():
            if job["policy"] not in out:
                out[job["policy"]] = jax_job(params, job, mp,
                                             cfg=MODELS["deepseek"][0])
    return out


@pytest.fixture(scope="module")
def jax_pending(trees):
    """The JAX engine's runs, on a thread of their own so that they run
    while this process waits on the spawned ranks."""
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        yield pool.submit(_jax_jobs, trees["deepseek"][0])


@pytest.fixture(scope="module")
def runs(trees, jax_pending):
    return spawn_suite(2, trees, JOBS)


@pytest.fixture(scope="module")
def jax_runs(jax_pending):
    out = jax_pending.result()
    # the slow clock's run preempts (the preemption path on the mesh)
    assert sum(v["preemptions"] for v in out["slo-preempt"][0].values())
    return out


def check_forwards(runs, want, name, what):
    """Each rank's logits within 1e-5 of JAX's, every rank's alike."""
    i = list(MODELS).index(name)
    first = runs[0]["forwards"][i][what]
    for rank in runs:
        got = rank["forwards"][i][what]
        for g, w in zip(got, want[name][what]) if what == "decode" \
                else [(got, want[name][what])]:
            _close(g, w)
        assert np.array_equal(np.asarray(got), np.asarray(first))


def check_latent(runs, name):
    """Every rank's latent pages (the whole latent, written by each
    rank) bit for bit alike after the decode steps."""
    i = list(MODELS).index(name)
    first = runs[0]["forwards"][i]["cache"]
    for rank in runs[1:]:
        for a, b in zip(rank["forwards"][i]["cache"], first):
            assert sorted(a) == ["ckv", "kpe"]
            for k in a:
                assert np.array_equal(a[k], b[k]), k


def check_mla_heads(runs, name, tp):
    """Each rank's MLA weights: ``nh/tp`` heads where they divide tp,
    else all of them; the latent pages whole."""
    cfg = MODELS[name][1]
    m = cfg.mla
    h = cfg.num_heads // tp if cfg.num_heads % tp == 0 else cfg.num_heads
    for rank in runs:
        res = rank["forwards"][list(MODELS).index(name)]
        shapes = res["attn_shapes"]
        assert shapes["wq"][1] == h * (m.qk_nope_head_dim
                                       + m.qk_rope_head_dim)
        assert shapes["w_uk"][1] == h * m.qk_nope_head_dim
        assert shapes["w_uv"][1] == shapes["wo"][0] == h * m.v_head_dim
        assert shapes["w_dkv"] == (cfg.d_model, m.kv_lora_rank)
        assert res["page_shape"] == (33, 16, m.kv_lora_rank)


@pytest.mark.parametrize("what", ["prefill", "chunk", "decode", "full"])
@pytest.mark.parametrize("name", list(MODELS))
def test_mla_logits_match_jax(runs, want, name, what):
    check_forwards(runs, want, name, what)


@pytest.mark.parametrize("name", list(MODELS))
def test_mla_heads_and_latent_per_rank(runs, name):
    check_mla_heads(runs, name, 2)
    check_latent(runs, name)


@pytest.mark.parametrize("name", list(JOBS))
def test_tp2_mla_engine_matches_jax(runs, jax_runs, name):
    job = JOBS[name]
    check_against_jax(runs[0]["engines"][list(JOBS).index(name)],
                      *jax_runs[job["policy"]], job)


@pytest.mark.parametrize("name", list(JOBS))
def test_mla_ranks_replay_and_agree(runs, name):
    """Both ranks ran the same device steps and drew the same ids, and
    their latent pages (replicated under the cache specs) end equal."""
    lead, follow = (r["engines"][list(JOBS).index(name)] for r in runs)
    assert lead["log"] == follow["log"]
    assert {e[0] for e in lead["log"]} >= {"prefill", "decode", "sample"}
    assert lead["replicated"] == follow["replicated"]
    assert all(sorted(d) == ["ckv", "kpe"] for d in lead["replicated"])
    # each rank's pool is the cache specs' slice of a whole one
    assert lead["specs"] and follow["specs"]
