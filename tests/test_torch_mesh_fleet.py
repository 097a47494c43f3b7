"""An ``EngineFleet`` of tensor-parallel engines: two ``Engine(mesh=...)``
on the same two spawned ranks (gloo, CPU; one tp group, the reference's
layout in ``tests/helpers/verify_sharding.py::check_fleet_parity``), the
second sharing the first's sharded params, reduced ``qwen3-1.7b`` in
float32.  Rank 0 runs the fleet (the mapper, both loops' ticks) and rank
1's one ``follow()`` replays both engines' steps.  Under ``least-loaded``
and ``round-robin`` each stream's greedy tokens equal a JAX
``ServeLoop`` over one engine on the same backlogged trace, as
``tests/test_sharding.py::test_fleet_token_parity_single_device``
checks on one device; both clocks move 1 ms a step.  Both ranks ran the
same steps of each engine."""
import numpy as np
import pytest

from helpers import torch_mesh_ranks as ranks
from repro.core.slo import SLO as JaxSLO
from repro.core.slo import Request as JaxRequest
from repro.engine import engine as jax_engine_mod
from repro.engine.engine import Engine as JaxEngine
from repro.serving import ServeLoop as JaxServeLoop
from repro_torch.core.slo import SLO, Request
from repro_torch.launch.mesh import spawn
from test_torch_mesh_engine import CFG, ENGINE_KW, PORT_CFG, tree  # noqa: F401

MAPPERS = ("least-loaded", "round-robin")
N, OUT = 8, 6


def trace(request, slo):
    """8 requests of 6-39 tokens, 6 new tokens each, all at t=0."""
    rng = np.random.default_rng(5)
    out = []
    for i in range(N):
        toks = rng.integers(1, CFG.vocab_size - 1,
                            int(rng.integers(6, 40))).astype(np.int32)
        out.append((request(req_id=i, task_type="chat",
                            input_len=len(toks), slo=slo(), output_len=OUT,
                            arrival_time=0.0), toks))
    return out


@pytest.fixture(scope="module")
def fleets(tree):                                      # noqa: F811
    jobs = [dict(cfg=PORT_CFG, tree=tree[1], engine=ENGINE_KW, mapper=m,
                 pairs=trace(Request, SLO)) for m in MAPPERS]
    out = spawn(ranks.fleet_suite, 2, (jobs,), device="cpu", threads=1,
                timeout=60, deadline=240)
    return {m: [out[r][i] for r in range(2)] for i, m in enumerate(MAPPERS)}


@pytest.fixture(scope="module")
def single(tree):                                      # noqa: F811
    """Each stream's tokens from one JAX ServeLoop over one engine."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_engine_mod, "time", ranks.FixedClock())
        loop = JaxServeLoop(JaxEngine(CFG, tree[0], **ENGINE_KW))
        streams = loop.submit_trace(trace(JaxRequest, JaxSLO))
        loop.serve()
    return [list(st.tokens) for st in streams]


@pytest.mark.parametrize("mapper", MAPPERS)
def test_fleet_of_mesh_engines_matches_one_jax_loop(fleets, single,
                                                     mapper):
    lead = fleets[mapper][0]
    assert lead["tokens"] == single
    assert all(len(t) == OUT for t in lead["tokens"])
    # both instances served requests, each request once
    assert all(n > 0 for n in lead["instances"])
    assert sum(lead["instances"]) == N


@pytest.mark.parametrize("mapper", MAPPERS)
def test_follower_replays_both_engines(fleets, mapper):
    """Rank 1 ran each engine's device steps in rank 0's order and with
    its arguments, and drew the same ids; the second engine on each rank
    holds the first's params, not a copy."""
    lead, follow = fleets[mapper]
    assert lead["logs"] == follow["logs"]
    for log in lead["logs"]:
        assert {e[0] for e in log} >= {"prefill", "dispatch", "sample"}
    assert lead["shared"] and follow["shared"]
