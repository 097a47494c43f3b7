"""The Zamba2 hybrid's tensor-parallel engine (two spawned ranks, gloo on
the CPU; reduced ``zamba2-1.2b`` at 4 layers in float32, as in
``test_torch_mesh_hybrid.py``) under slo-preempt (stalling prefill at
1 ms a step, and ``chunked:16`` at 0.25 s a step, slow enough that it
preempts) and through a ``ServeLoop`` (dispatched rounds at pow-2
widths slice the per-slot SSM state as views), against the JAX
``Engine`` and
``ServeLoop`` with both clocks alike: identical greedy tokens,
completion sets, preemption counts and ``prefix_stats()``; both ranks
replay the same device steps and end with the same SSM state."""
import concurrent.futures

import pytest

import test_torch_mesh_hybrid as base
from test_torch_mesh_engine import check_against_jax
from test_torch_mesh_hybrid import SERVE, tree  # noqa: F401 (fixture)

JOBS = {
    "slo-preempt-stall": dict(SERVE, policy="slo-preempt",
                              discipline="stall"),
    # a clock of 0.25 s a step: slow enough that slo-preempt preempts
    "slo-preempt-chunked-slow": dict(SERVE, policy="slo-preempt",
                                     discipline="chunked:16", clock=0.25),
    "serve-loop": dict(kind="loop", policy="fcfs", discipline="stall",
                       workload=("serve", 6, 0)),
}


@pytest.fixture(scope="module")
def jax_pending(tree):                                  # noqa: F811
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        yield pool.submit(base.jax_jobs, tree[0], JOBS)


@pytest.fixture(scope="module")
def runs(tree, jax_pending):                            # noqa: F811
    return base.spawn_suite(2, tree, JOBS)


@pytest.mark.parametrize("name", list(JOBS))
def test_tp2_hybrid_engine_matches_jax_policies(runs, jax_pending, name):
    got = runs[0]["engines"][list(JOBS).index(name)]
    check_against_jax(got, *jax_pending.result()[name], JOBS[name])


def test_hybrid_mesh_engine_preempts(runs, jax_pending):
    """The slow clock's run preempts, a re-prefill of a preempted
    request's prompt and generated tokens into a fresh slot, on both
    ranks as in the JAX engine."""
    got = runs[0]["engines"][list(JOBS).index("slo-preempt-chunked-slow")]
    want = jax_pending.result()["slo-preempt-chunked-slow"][0]
    n = sum(v["preemptions"] for v in want.values())
    assert n > 0
    assert sum(v["preemptions"] for v in got["results"].values()) == n


@pytest.mark.parametrize("name", list(JOBS))
def test_hybrid_ranks_replay_and_agree_policies(runs, name):
    base.check_replay(runs, JOBS, name)
