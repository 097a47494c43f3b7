"""The port's tensor-parallel paged engine on two spawned ranks (gloo, CPU)
against the JAX ``Engine`` on one device, float32: reduced ``dbrx-132b``
(4 experts top-2; its kv heads set to 2 so that attention splits, one kv
head a rank) on the MoE FFN's expert-parallel branch (2 experts a rank,
the ranks' outputs summed) and its baseline branch (every expert on
every rank, prefill sequences split over the ranks), stalled and
``chunked:16``; and the indivisible 6 q / 3 kv heads, where each rank
holds every head and whole pages and the attention block runs
replicated.  Identical greedy tokens, completion sets, preemption counts
and ``prefix_stats()``; both ranks replay the same device steps."""
import dataclasses

import jax
import numpy as np
import pytest

from helpers import torch_mesh_ranks as ranks
from repro.configs import get_reduced
from repro.models import ModelConfig as JaxConfig
from repro.models import init_params
from repro_torch.configs import get_reduced as port_reduced
from repro_torch.launch.mesh import spawn
from repro_torch.models.config import ModelConfig as PortConfig
from test_torch_mesh_engine import ENGINE_KW, check_against_jax, jax_job

DBRX = dict(dtype="float32", num_kv_heads=2)
KV3 = dict(name="t-kv3", family="dense", num_layers=2, d_model=48,
           num_heads=6, num_kv_heads=3, head_dim=8, d_ff=96, vocab_size=97,
           dtype="float32")
MODELS = {
    "dbrx": (dataclasses.replace(get_reduced("dbrx-132b"), **DBRX),
             dataclasses.replace(port_reduced("dbrx-132b"), **DBRX)),
    "kv3": (JaxConfig(**KV3), PortConfig(**KV3)),
}
SERVE = dict(kind="policy", policy="fcfs", workload=("serve", 5, 2))
JOBS = {
    "dbrx-expert-parallel": dict(SERVE, model="dbrx", discipline="stall",
                                 ep=True),
    "dbrx-baseline": dict(SERVE, model="dbrx", discipline="stall"),
    "dbrx-baseline-chunked": dict(SERVE, model="dbrx",
                                  discipline="chunked:16"),
    "kv3-replicated": dict(SERVE, model="kv3", discipline="stall"),
}


@pytest.fixture(scope="module")
def trees():
    out = {}
    for name, (cfg, _) in MODELS.items():
        jp = jax.jit(init_params, static_argnums=1)(jax.random.PRNGKey(1),
                                                    cfg)
        out[name] = (jp, jax.tree.map(np.asarray, jp))
    return out


@pytest.fixture(scope="module")
def port(trees):
    jobs = [dict(job, cfg=MODELS[job["model"]][1],
                 tree=trees[job["model"]][1], engine=ENGINE_KW)
            for job in JOBS.values()]
    out = spawn(ranks.engine_suite, 2, (jobs,), device="cpu", threads=1,
                timeout=60, deadline=240)
    return {name: [out[r][i] for r in range(2)]
            for i, name in enumerate(JOBS)}


@pytest.mark.parametrize("name", list(JOBS))
def test_tp2_engine_matches_jax(port, trees, name, monkeypatch):
    job = JOBS[name]
    cfg = MODELS[job["model"]][0]
    check_against_jax(port[name][0],
                      *jax_job(trees[job["model"]][0], job, monkeypatch,
                               cfg=cfg), job)
    lead, follow = port[name]
    assert lead["log"] == follow["log"]


@pytest.mark.parametrize("name", list(JOBS))
def test_pages_per_rank(port, name):
    """DBRX: each rank's pages hold its one kv head; kv 3: whole."""
    cfg = MODELS[JOBS[name]["model"]][1]
    kv = cfg.num_kv_heads // 2 if cfg.num_kv_heads % 2 == 0 \
        else cfg.num_kv_heads
    n = ENGINE_KW["max_slots"] * (ENGINE_KW["max_seq_len"] // 16) + 1
    for rec in port[name]:
        assert rec["pages"] == [(n, 16, kv, cfg.head_dim)]
