"""The port's tensor-parallel paged engine on two spawned ranks (gloo,
CPU) against the JAX ``Engine`` on one device, reduced ``qwen3-1.7b`` in
float32, the jobs of ``test_torch_mesh_engine.py`` that reach the prefix
cache and the sampler: a multi-turn trace with prefix hits under fcfs,
then a request aliasing a cached prompt whose first page is split by
hand (copy-on-write on every rank's shard) before three decode rounds;
and a run at temperature 0.8, where every rank draws the same ids from
the same logits with its own alike-seeded generator (no JAX
counterpart: the two packages' generators differ).  Last, ranks that
disagree on a step fail on the process group's timeout."""
import time

import pytest

from helpers import torch_mesh_ranks as ranks
from repro_torch.launch.mesh import spawn
from test_torch_mesh_engine import (ENGINE_KW, PORT_CFG, check_against_jax,
                                    check_replay, jax_job, spawn_jobs,
                                    tree)  # noqa: F401  (fixture)

JOBS = {
    "multiturn-cow": dict(kind="policy", policy="fcfs", discipline="stall",
                          workload=("multiturn", 2, 3), cow=True),
    "temperature": dict(kind="policy", policy="fcfs", discipline="stall",
                        workload=("serve", 4, 1), temperature=0.8),
}


@pytest.fixture(scope="module")
def port(tree):                                        # noqa: F811
    return spawn_jobs(JOBS, tree)


def test_multiturn_cow_matches_jax(port, tree, monkeypatch):  # noqa: F811
    job = JOBS["multiturn-cow"]
    check_against_jax(port["multiturn-cow"][0],
                      *jax_job(tree[0], job, monkeypatch), job)


@pytest.mark.parametrize("name", list(JOBS))
def test_ranks_replay_the_same_device_steps(port, name):
    check_replay(*port[name], JOBS[name])


def test_ranks_draw_the_same_ids_at_temperature(port):
    lead, follow = port["temperature"]
    draws = [e[2] for e in lead["log"] if e[0] == "sample"]
    assert draws == [e[2] for e in follow["log"] if e[0] == "sample"]
    for v in lead["results"].values():
        assert len(v["tokens"]) > 0
        assert all(0 <= t < PORT_CFG.vocab_size for t in v["tokens"])


def test_ranks_that_disagree_fail_on_the_timeout(tree):   # noqa: F811
    """A follower that replays a decode round as something else (a bare
    draw, no collectives) leaves rank 0 in the round's all_reduce: the
    run ends with the process group's timeout error, well before the
    spawn deadline."""
    job = dict(kind="policy", policy="fcfs", discipline="stall",
               workload=("serve", 2, 0), cfg=PORT_CFG, tree=tree[1],
               engine=dict(ENGINE_KW))
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="Timed out waiting") as err:
        spawn(ranks.diverging_follower, 2, (job,), device="cpu", threads=1,
              timeout=5, deadline=120)
    assert "still running" not in str(err.value)
    assert time.monotonic() - t0 < 60
