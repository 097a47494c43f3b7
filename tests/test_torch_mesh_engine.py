"""The port's tensor-parallel paged engine (``Engine(mesh=...)``, two
spawned ranks over gloo on the CPU) against the JAX ``Engine`` on one
device, on reduced ``qwen3-1.7b`` in float32 (4 q / 2 kv heads: one kv
head a rank).

Rank 0 runs the jobs through ``run_policy`` and ``ServeLoop`` while rank
1 follows.  Both engines read a clock that moves 1 ms a step
(``FixedClock``), so the clock-reading policies (slo-reanneal,
slo-preempt) decide alike in both packages.  Per job: identical greedy
tokens, completion sets, preemption counts and ``prefix_stats()``; each
rank holds ``kv/2`` heads of every page array; and both ranks ran the
same device steps with the same arguments and drew the same ids.  The
multi-turn, copy-on-write and temperature runs: ``test_torch_mesh_prefix.py``."""
import dataclasses

import jax
import numpy as np
import pytest

from helpers import torch_mesh_ranks as ranks
from repro.configs import get_reduced
from repro.core import policies as jax_policies
from repro.core.latency_model import PAPER_TABLE2 as JAX_MODEL
from repro.core.slo import Request
from repro.data import synthetic as jax_synthetic
from repro.engine import engine as jax_engine_mod
from repro.engine.engine import Engine as JaxEngine
from repro.engine.request import RuntimeRequest
from repro.models import init_params
from repro.serving import ServeLoop as JaxServeLoop
from repro_torch.configs import get_reduced as port_reduced
from repro_torch.launch.mesh import spawn

CFG = dataclasses.replace(get_reduced("qwen3-1.7b"), dtype="float32")
PORT_CFG = dataclasses.replace(port_reduced("qwen3-1.7b"), dtype="float32")
ENGINE_KW = dict(max_slots=3, max_seq_len=256)
JOBS = {
    "fcfs": dict(kind="policy", policy="fcfs", discipline="stall",
                 workload=("serve", 6, 0)),
    "slo-reanneal": dict(kind="policy", policy="slo-reanneal",
                         discipline="stall", workload=("serve", 6, 0)),
    "slo-preempt-chunked": dict(kind="policy", policy="slo-preempt",
                                discipline="chunked:16",
                                workload=("serve", 6, 0)),
    "serve-loop": dict(kind="loop", policy="fcfs", discipline="stall",
                       workload=("serve", 6, 0)),
}


@pytest.fixture(scope="module")
def tree():
    jp = jax.jit(init_params, static_argnums=1)(jax.random.PRNGKey(0), CFG)
    return jp, jax.tree.map(np.asarray, jp)


def spawn_jobs(jobs, tree):
    """The jobs on two spawned ranks: {name: [rank 0's, rank 1's]}."""
    specs = [dict(job, cfg=PORT_CFG, tree=tree[1],
                  engine=dict(ENGINE_KW,
                              temperature=job.get("temperature", 0.0)))
             for job in jobs.values()]
    out = spawn(ranks.engine_suite, 2, (specs,), device="cpu", threads=1,
                timeout=60, deadline=240)
    return {name: [out[r][i] for r in range(2)]
            for i, name in enumerate(jobs)}


@pytest.fixture(scope="module")
def port(tree):
    return spawn_jobs(JOBS, tree)


def _jax_rt(prompt, r):
    req = Request(req_id=999, task_type=r.task_type, input_len=len(prompt),
                  slo=r.slo, output_len=8)
    return RuntimeRequest(request=req, prompt_tokens=prompt,
                          max_new_tokens=8)


def jax_job(params, job, monkeypatch, cfg=CFG):
    """The job on the JAX engine, its clock ``job["clock"]`` (default
    1 ms) a step as the port's."""
    monkeypatch.setattr(jax_engine_mod, "time",
                        ranks.FixedClock(job.get("clock", 1e-3)))
    eng = JaxEngine(cfg, params, **ENGINE_KW)
    kind, n, k = job["workload"]
    if job["kind"] == "loop":
        pairs = jax_synthetic.sample_serve_workload(n, cfg.vocab_size,
                                                    seed=k,
                                                    arrival_rate=50.0)
        loop = JaxServeLoop(eng, job["policy"], model=JAX_MODEL,
                            discipline=job["discipline"])
        loop.start(warm_lengths=[len(p) for _, p in pairs])
        loop.submit_trace(pairs)
        res = loop.serve()
        return {rid: {"tokens": v["tokens"], "preemptions": v["preemptions"]}
                for rid, v in res.items()}, None, eng
    if kind == "serve":
        pairs = jax_synthetic.sample_serve_workload(n, cfg.vocab_size,
                                                    seed=k)
    else:                       # n conversations of k turns
        pairs = jax_synthetic.sample_multiturn_token_requests(
            n, turns=k, vocab=cfg.vocab_size)
    rts = [RuntimeRequest(request=r, prompt_tokens=p,
                          max_new_tokens=r.output_len) for r, p in pairs]
    pol = jax_policies.make(job["policy"], model=JAX_MODEL,
                            max_batch=ENGINE_KW["max_slots"])
    res = eng.run_policy(rts, pol, discipline=job["discipline"])
    out = {rid: {"tokens": v["tokens"], "preemptions": v["preemptions"],
                 "cached": v["cached"]} for rid, v in res.items()}
    cow = ranks.cow_by_hand(eng, pairs, _jax_rt) if job.get("cow") \
        else None
    return out, cow, eng


@pytest.mark.parametrize("name", list(JOBS))
def test_tp2_engine_matches_jax(port, tree, name, monkeypatch):
    job = JOBS[name]
    check_against_jax(port[name][0], *jax_job(tree[0], job, monkeypatch),
                      job)


def check_against_jax(got, want, want_cow, jeng, job):
    """Identical greedy tokens, completion set, preemption counts (and
    cached tokens per request) and prefix stats; the copy-on-write run's
    tokens and counts."""
    assert sorted(got["results"]) == sorted(want)       # completion set
    for rid in want:
        assert got["results"][rid]["tokens"] == want[rid]["tokens"], rid
        assert got["results"][rid]["preemptions"] == \
            want[rid]["preemptions"], rid
        if "cached" in want[rid]:
            assert got["results"][rid]["cached"] == want[rid]["cached"]
    assert got["prefix"] == jeng.prefix_stats()
    if job.get("cow"):
        assert got["prefix"]["hit_rate"] > 0
        assert list(got["cow_tokens"]) == [list(want_cow[0]), want_cow[1]]
        assert want_cow[1] > 0                      # the prompt aliased
        assert got["cow"] == jeng.cow_copies >= 1


def check_replay(lead, follow, job):
    """Rank 1 ran every device step rank 0 ran, in order and with the
    same arguments, and drew the same ids."""
    assert lead["log"] == follow["log"]
    kinds = {entry[0] for entry in lead["log"]}
    assert {"sample", "table"} <= kinds and kinds & {"prefill", "chunk"}
    assert ("dispatch" if job["kind"] == "loop" else "decode") in kinds


@pytest.mark.parametrize("name", list(JOBS))
def test_ranks_replay_the_same_device_steps(port, name):
    check_replay(*port[name], JOBS[name])


def test_each_rank_holds_its_kv_heads(port):
    """Every page array of each rank: [N, P, kv/2, hd] (and nothing
    else on the pages), the slice the cache specs give it."""
    kv, hd = PORT_CFG.num_kv_heads, PORT_CFG.head_dim
    n = ENGINE_KW["max_slots"] * (ENGINE_KW["max_seq_len"] // 16) + 1
    for rec in port["fcfs"]:
        assert rec["pages"] == [(n, 16, kv // 2, hd)]
        assert rec["specs"]
