"""The port's paged engine on a mesh with a data axis (``Engine(mesh=)`` at
(data 2, tp 1), two spawned ranks over gloo on the CPU) against the JAX
``Engine`` on a host mesh of the same shape (4 host devices in a
subprocess, ``tests/helpers/jax_mesh_engine.py``), reduced
``qwen3-1.7b`` in float32, with the params whole over ``data``
(``fsdp=False``) and FSDP-sliced over it (``ParallelismConfig(fsdp=True)``,
each layer's shards gathered in the paged forwards).
``test_torch_mesh_engine_data_tp2.py`` runs the same jobs at (2, 2).

Rank 0 drives each job (fcfs stall, slo-preempt ``chunked:16`` on an
engine clock of 0.3 s a step, so that it preempts, and one ``ServeLoop``)
while the other ranks follow.  Per job: identical greedy tokens,
completion sets, preemption counts and ``prefix_stats()``; every rank,
whatever its data coordinate, ran the same device steps with the same
arguments and drew the same ids; each rank holds its slice of every
param (``sharding.rank_specs``) and page array (kv heads over tp, whole
over data)."""
import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest

from helpers import torch_mesh_ranks as ranks
from repro.configs import get_reduced
from repro.models import init_params
from repro_torch.configs import get_reduced as port_reduced
from repro_torch.distributed import sharding as psh
from repro_torch.launch.mesh import Mesh, spawn
from repro_torch.models.cache import init_paged_cache

HERE = pathlib.Path(__file__).resolve().parent
CFG = dataclasses.replace(get_reduced("qwen3-1.7b"), dtype="float32")
PORT_CFG = dataclasses.replace(port_reduced("qwen3-1.7b"), dtype="float32")
ENGINE_KW = dict(max_slots=3, max_seq_len=256)
JOBS = {
    "fcfs": dict(kind="policy", policy="fcfs", discipline="stall",
                 workload=("serve", 6, 0)),
    "slo-preempt-chunked": dict(kind="policy", policy="slo-preempt",
                                discipline="chunked:16", clock=0.3,
                                workload=("serve", 6, 0)),
    "serve-loop": dict(kind="loop", policy="fcfs", discipline="stall",
                       workload=("serve", 6, 0)),
}
CASES = [f"{name}-{fsdp}" for fsdp in ("whole", "fsdp") for name in JOBS]


def _job(case):
    name, fsdp = case.rsplit("-", 1)
    return dict(JOBS[name], fsdp=fsdp == "fsdp")


def start_jax(tree_jax, mesh_shape, tmp):
    """The JAX engines of every case on a host mesh of ``mesh_shape``, in
    a subprocess started now: returns (process, output path)."""
    leaves = jax.tree.leaves(tree_jax)
    cases = [dict(_job(c), name=c, mesh=list(mesh_shape),
                  workload=list(_job(c)["workload"])) for c in CASES]
    spec = dict(arch="qwen3-1.7b", replace=dict(dtype="float32"),
                engine=ENGINE_KW, cases=cases)
    src, dst = tmp / "in.npz", tmp / "out.json"
    np.savez(src, spec=json.dumps(spec),
             **{f"p{i}": np.asarray(a) for i, a in enumerate(leaves)})
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=str(HERE.parent / "src"))
    proc = subprocess.Popen([sys.executable,
                             str(HERE / "helpers" / "jax_mesh_engine.py"),
                             str(src), str(dst)], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    return proc, dst


def run_both(mesh_shape, tmp):
    """{"port": {case: [each rank's record]}, "jax": {case: results}}: the
    JAX subprocess runs while the port's ranks do."""
    jp = jax.jit(init_params, static_argnums=1)(jax.random.PRNGKey(0), CFG)
    tree = jax.tree.map(np.asarray, jp)
    proc, dst = start_jax(jp, mesh_shape, tmp)
    try:
        data, tp = mesh_shape
        specs = [dict(_job(c), cfg=PORT_CFG, tree=tree,
                      engine=dict(ENGINE_KW)) for c in CASES]
        out = spawn(ranks.engine_suite, tp, (specs,), data=data,
                    device="cpu", threads=1, timeout=120, deadline=400)
        log, _ = proc.communicate(timeout=400)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0, log.decode()[-3000:]
    with open(dst) as f:
        want = json.load(f)
    port = {c: [out[r][i] for r in range(data * tp)]
            for i, c in enumerate(CASES)}
    return {"port": port, "jax": want, "shape": mesh_shape}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_both((2, 1), tmp_path_factory.mktemp("engine-data"))


def check_against_jax(runs, case):
    """Identical greedy tokens, completion set, preemption counts, cached
    tokens per request and prefix stats."""
    got = runs["port"][case][0]
    want = runs["jax"][case]
    assert sorted(got["results"]) == sorted(int(r) for r in
                                            want["results"])
    for rid, w in want["results"].items():
        g = got["results"][int(rid)]
        assert g["tokens"] == w["tokens"], rid
        assert g["preemptions"] == w["preemptions"], rid
        if "cached" in w:
            assert g["cached"] == w["cached"], rid
    assert got["prefix"] == want["prefix"]
    if case.startswith("slo-preempt"):
        assert sum(w["preemptions"] for w in want["results"].values()) > 0
        assert want["prefix"]["hit_rate"] > 0      # re-admissions hit


def check_replay(runs, case):
    """Every rank, each data coordinate included, ran rank 0's device
    steps in order with the same arguments and drew the same ids."""
    recs = runs["port"][case]
    lead = recs[0]
    for r in recs[1:]:
        assert r["log"] == lead["log"]
    kinds = {entry[0] for entry in lead["log"]}
    assert {"sample", "table"} <= kinds and kinds & {"prefill", "chunk"}
    job = _job(case)
    assert ("dispatch" if job["kind"] == "loop" else "decode") in kinds


def check_slices(runs, case):
    """Each rank's params are its slices under ``rank_specs`` (FSDP:
    ``1/data`` of each sharded leaf), its pages ``[N, P, kv/tp, hd]``
    whole over data, and the ranks of one tp coordinate hold the same
    pages' shapes."""
    data, tp = runs["shape"]
    fsdp = _job(case)["fsdp"]
    par = psh.ParallelismConfig(fsdp=fsdp)
    full = dict(ranks._named(init_params_meta()))
    split = 0
    for r, rec in enumerate(runs["port"][case]):
        mesh = Mesh({"data": data, "model": tp}, rank=r)
        specs = dict(ranks._named(psh.rank_specs(PORT_CFG, mesh, par)))
        assert sorted(rec["param_shapes"]) == sorted(full)
        for path, shape in rec["param_shapes"].items():
            want = psh.local_shape(full[path].shape, specs[path], mesh)
            assert shape == want, path
            split += shape != tuple(full[path].shape)
        assert rec["specs"]                # pages: the cache specs' slice
        kv, hd = PORT_CFG.num_kv_heads, PORT_CFG.head_dim
        n = ENGINE_KW["max_slots"] * (ENGINE_KW["max_seq_len"] // 16) + 1
        assert rec["pages"] == [(n, 16, kv // tp, hd)]
    # FSDP slices some leaf over data; without it only tp splits them
    assert (split > 0) is (fsdp or tp > 1)


def init_params_meta():
    from repro_torch.models.model import init_params as port_init
    return port_init(PORT_CFG, device="meta")


def test_whole_pages_over_data():
    """The page arrays' specs name no data axis: each data group holds the
    same pool, as the reference places it (``_paged_cache_specs``)."""
    cache = init_paged_cache(PORT_CFG, 3, 256, 49, 16, device="meta")
    mesh = Mesh({"data": 2, "model": 2})
    for fsdp in (False, True):
        specs = psh.cache_specs(cache, PORT_CFG, mesh,
                                psh.ParallelismConfig(fsdp=fsdp), 3)
        for layer in specs["layers"]:
            for spec in layer.values():
                assert "data" not in [a for e in spec if e is not None
                                      for a in ((e,) if isinstance(e, str)
                                                else e)]


@pytest.mark.parametrize("case", CASES)
def test_data_engine_matches_jax(runs, case):
    check_against_jax(runs, case)


@pytest.mark.parametrize("case", CASES)
def test_data_ranks_replay_the_same_steps(runs, case):
    check_replay(runs, case)


@pytest.mark.parametrize("case", CASES)
def test_data_ranks_hold_their_slices(runs, case):
    check_slices(runs, case)
