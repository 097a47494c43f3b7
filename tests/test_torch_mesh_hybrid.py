"""The Zamba2 hybrid under a tensor-parallel mesh: reduced ``zamba2-1.2b``
in float32 at 4 layers (SSM, ATTN, SSM, ATTN, so that the one shared
attention block runs twice; 4 q / 4 kv heads) on two spawned ranks
(gloo, CPU) against the JAX package on one device.

Forwards (tp 4: ``test_torch_mesh_hybrid_tp4.py``; slo-preempt and the
``ServeLoop``: ``test_torch_mesh_hybrid_policies.py``): paged prefill, two
chunks and three decode steps, and ``forward_full``, within 1e-5 of the
JAX logits, every rank's alike: the shared block on each rank's 2 heads,
the SSM layers whole on every rank, whose per-slot conv and recurrent
state end bit for bit alike.  The engine: ``Engine(mesh=...)`` under
fcfs stall and fcfs ``chunked:16``, against the JAX ``Engine`` with the
clocks at 1 ms a step: identical
greedy tokens, completion sets, preemption counts and ``prefix_stats()``.
The reference's two SSM-state traps hold under the mesh too: a paged
chunk runs padded to its bucket from the slot's state as it stands, so
a ragged prompt's padded rows enter the state, and a reused slot's first
chunk reads what its previous request left; the chunked run's tokens
differ from the stalling run's on a ragged prompt, and equal JAX's.
Both ranks replay the same device steps and end with the same SSM
state."""
import concurrent.futures
import dataclasses

import jax
import numpy as np
import pytest

from helpers import torch_mesh_ranks as ranks
from repro.configs import get_reduced
from repro.models import init_params
from repro_torch.configs import get_reduced as port_reduced
from repro_torch.launch.mesh import spawn
from test_torch_mesh_engine import ENGINE_KW, check_against_jax, jax_job
from test_torch_mesh_model import _close, jax_forwards

PATTERN = ("ssm", "attn", "ssm", "attn")
KW = dict(num_layers=4, layer_pattern=PATTERN, dtype="float32")
CFG = dataclasses.replace(get_reduced("zamba2-1.2b"), **KW)
PORT_CFG = dataclasses.replace(port_reduced("zamba2-1.2b"), **KW)
SERVE = dict(kind="policy", workload=("serve", 6, 0))
JOBS = {
    "fcfs-stall": dict(SERVE, policy="fcfs", discipline="stall"),
    "fcfs-chunked": dict(SERVE, policy="fcfs", discipline="chunked:16"),
}


@pytest.fixture(scope="module")
def tree():
    jp = jax.jit(init_params, static_argnums=1)(jax.random.PRNGKey(3), CFG)
    return jp, jax.tree.map(np.asarray, jp)


@pytest.fixture(scope="module")
def want(tree):
    return jax_forwards(CFG, tree[0])


def spawn_suite(tp, tree, jobs=None):
    specs = [dict(job, cfg=PORT_CFG, tree=tree[1], engine=ENGINE_KW)
             for job in (jobs or {}).values()]
    return spawn(ranks.model_suite, tp, ([(PORT_CFG, tree[1])], specs),
                 device="cpu", threads=1, timeout=60, deadline=240)


def jax_jobs(params, jobs):
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for name, job in jobs.items():
            out[name] = jax_job(params, job, mp, cfg=CFG)
    return out


@pytest.fixture(scope="module")
def jax_pending(tree):
    """The JAX engine's runs, started on a thread of their own so that
    they run while this process waits on the spawned ranks."""
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        yield pool.submit(jax_jobs, tree[0], JOBS)


@pytest.fixture(scope="module")
def runs(tree, jax_pending):
    return spawn_suite(2, tree, JOBS)


@pytest.fixture(scope="module")
def jax_runs(jax_pending):
    return jax_pending.result()


def check_forwards(runs, want, what):
    first = runs[0]["forwards"][0][what]
    for rank in runs:
        got = rank["forwards"][0][what]
        for g, w in zip(got, want[what]) if what == "decode" \
                else [(got, want[what])]:
            _close(g, w)
        assert np.array_equal(np.asarray(got), np.asarray(first))


def check_shards(runs, tp):
    """The shared block and its pages on ``kv/tp`` heads a rank; the SSM
    layers' state whole on every rank and bit for bit alike."""
    kv, hd = PORT_CFG.num_kv_heads, PORT_CFG.head_dim
    first = runs[0]["forwards"][0]["cache"]
    for rank in runs:
        res = rank["forwards"][0]
        assert res["page_shape"] == (33, 16, kv // tp, hd)
        assert res["attn_shapes"]["wk"] == (PORT_CFG.d_model,
                                            kv // tp * hd)
        for i, kind in enumerate(PATTERN):
            if kind == "ssm":
                assert sorted(res["cache"][i]) == ["conv", "ssm"]
                for k in ("conv", "ssm"):
                    assert np.array_equal(res["cache"][i][k], first[i][k])


@pytest.mark.parametrize("what", ["prefill", "chunk", "decode", "full"])
def test_hybrid_logits_match_jax(runs, want, what):
    check_forwards(runs, want, what)


def test_hybrid_shards_per_rank(runs):
    check_shards(runs, 2)


@pytest.mark.parametrize("name", list(JOBS))
def test_tp2_hybrid_engine_matches_jax(runs, jax_runs, name):
    got = runs[0]["engines"][list(JOBS).index(name)]
    check_against_jax(got, *jax_runs[name], JOBS[name])


def test_hybrid_chunk_traps_reproduced(runs, jax_runs):
    """``chunked:16`` differs from the stalling run on a ragged prompt
    (padded rows and a reused slot's state enter the recurrent state) in
    the mesh engine as in the JAX engine, and equals the JAX run."""
    from repro_torch.data import synthetic
    lengths = [len(p) for _, p in synthetic.sample_serve_workload(
        6, PORT_CFG.vocab_size, seed=0)]
    engines = runs[0]["engines"]
    chunked = engines[list(JOBS).index("fcfs-chunked")]["results"]
    stall = engines[list(JOBS).index("fcfs-stall")]["results"]
    ragged = [rid for rid, n in zip(sorted(stall), lengths) if n % 16]
    assert ragged
    assert any(chunked[rid]["tokens"] != stall[rid]["tokens"]
               for rid in ragged)
    want_chunked = jax_runs["fcfs-chunked"][0]
    assert {r: v["tokens"] for r, v in chunked.items()} == \
        {r: v["tokens"] for r, v in want_chunked.items()}


def check_replay(runs, jobs, name):
    """Both ranks ran the same device steps with the same arguments and
    drew the same ids, and every layer's SSM state (whole on each rank)
    ends bit for bit alike."""
    lead, follow = (r["engines"][list(jobs).index(name)] for r in runs)
    assert lead["log"] == follow["log"]
    kinds = {e[0] for e in lead["log"]}
    assert ("dispatch" if jobs[name]["kind"] == "loop" else "decode") \
        in kinds
    assert lead["replicated"] == follow["replicated"]
    assert [sorted(d) for d in lead["replicated"]] == \
        [["conv", "ssm"], [], ["conv", "ssm"], []]
    # each rank's pool is the cache specs' slice of a whole one
    assert lead["specs"] and follow["specs"]


@pytest.mark.parametrize("name", list(JOBS))
def test_hybrid_ranks_replay_and_agree(runs, name):
    check_replay(runs, JOBS, name)
