"""The port's dry run (``repro_torch.launch.dryrun``): every ``ASSIGNED``
arch x 4 shapes x both production meshes by spec arithmetic, with no
process group and no compile.

* Argument bytes against the JAX package's own shardings: a subprocess
  with 512 host devices (``tests/helpers/jax_dryrun_bytes.py``,
  ``jax.eval_shape`` only) sums the ``NamedSharding.shard_shape`` bytes
  of every param, moment, cache and input leaf; the port's per-device
  argument bytes must equal them exactly once each leaf the report names
  as held whole (``held_whole``: the port's placement keeps it whole over
  tp where ``param_specs`` cuts it) counts at its reference bytes, and
  each named leaf's reference bytes must be the JAX leaf's.
* Collective arithmetic against spawned ranks: at (2, 2) on a global
  batch of 4 and at (2, 1) on a batch of 3 (replicated over data),
  reduced configs in float32, each rank runs one train step or one paged
  decode round and tallies its collectives by kind
  (``layers.collective_counts``); the dry run's prediction for the same
  config, mesh, parallelism and shape must equal every rank's tally,
  calls and bytes, exactly."""
import dataclasses
import glob
import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from helpers import torch_mesh_dryrun_ranks as ranks
from repro_torch.configs import ASSIGNED, get_config
from repro_torch.configs import get_reduced as port_reduced
from repro_torch.distributed.sharding import ParallelismConfig
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import Mesh, spawn

HERE = pathlib.Path(__file__).resolve().parent
MESHES = ("16x16", "2x16x16")
# the reference's record keys (src/repro/launch/dryrun.py: analyze,
# run_one)
REFERENCE_KEYS = ("flops_per_device", "bytes_accessed_per_device",
                  "argument_bytes", "output_bytes", "temp_bytes",
                  "peak_bytes", "collective_bytes_per_device",
                  "collective_counts", "arch", "shape", "mesh", "lower_s",
                  "compile_s", "param_count", "active_param_count")
FSDP, WHOLE = dict(fsdp=True), dict(fsdp=False)
EP = dict(fsdp=True, expert_parallel=True)
AUTO = dict(fsdp=True, attn_sharding="auto")
# (arch, kind, parallelism) of the spawned-rank cases, on each mesh
TALLY_CASES = [
    ("qwen3-1.7b", "train", FSDP), ("qwen3-1.7b", "train", AUTO),
    ("qwen3-1.7b", "decode", FSDP), ("qwen3-1.7b", "decode", WHOLE),
    ("deepseek-v2-lite-16b", "train", FSDP),
    ("deepseek-v2-lite-16b", "train", EP),
    ("deepseek-v2-lite-16b", "decode", EP),
    ("deepseek-v2-lite-16b", "decode", WHOLE),
    ("zamba2-1.2b", "train", AUTO), ("zamba2-1.2b", "decode", FSDP),
    ("musicgen-medium", "train", FSDP), ("qwen2-vl-7b", "train", FSDP),
    ("dbrx-132b", "decode", FSDP), ("mamba2-780m", "train", FSDP)]
TALLY_MESHES = {"2x2": ((2, 2), 4), "2x1": ((2, 1), 3)}
SEQ = 32


def _name(case):
    arch, kind, par = case
    flags = "+".join(k if v is True else str(v) for k, v in par.items()
                     if v) or "whole"
    return f"{arch}-{kind}-{flags}"


def _cfg(arch):
    return dataclasses.replace(port_reduced(arch), dtype="float32")


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The JAX shard bytes (a subprocess started first), the CLI's 80
    records, and each spawned mesh's tallies."""
    tmp = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=str(HERE.parent / "src"))
    env.pop("XLA_FLAGS", None)
    jax_out = tmp / "jax.json"
    proc = subprocess.Popen([sys.executable,
                             str(HERE / "helpers" / "jax_dryrun_bytes.py"),
                             str(jax_out)], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    try:
        dryrun.main(["--arch", "all", "--shape", "all", "--both-meshes",
                     "--out-dir", str(tmp / "records"), "--device", "cpu"])
        records = {}
        for path in glob.glob(str(tmp / "records" / "*.json")):
            with open(path) as f:
                records[os.path.basename(path)[:-5]] = json.load(f)
        tallies = {}
        for name, (shape, batch) in TALLY_MESHES.items():
            cases = [dict(cfg=_cfg(a), kind=k, par=p, batch=batch, seq=SEQ)
                     for a, k, p in TALLY_CASES]
            got = spawn(ranks.tally_suite, shape[1], (cases,),
                        data=shape[0], device="cpu", threads=1,
                        timeout=120, deadline=400)
            for i, case in enumerate(TALLY_CASES):
                tallies[(name, _name(case))] = [g[i] for g in got]
        log, _ = proc.communicate(timeout=400)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0, log.decode()[-3000:]
    with open(jax_out) as f:
        return {"records": records, "jax": json.load(f),
                "tallies": tallies}


def test_cli_writes_every_case(run):
    """80 records (10 archs x 4 shapes x 2 meshes) with the reference's
    keys; with ``--device cpu`` (the spec arithmetic alone) the fields a
    measured step gives are null; no process group was started."""
    recs = run["records"]
    assert len(ASSIGNED) == 10
    want = {f"{a}_{s}_{m}" for a in ASSIGNED for s in dryrun.SHAPES
            for m in MESHES}
    assert set(recs) == want
    for rec in recs.values():
        assert set(REFERENCE_KEYS) <= set(rec)
        for key in ("flops_per_device", "bytes_accessed_per_device",
                    "temp_bytes", "peak_bytes", "lower_s", "compile_s"):
            assert rec[key] is None
        assert rec["argument_bytes"] > 0 and rec["output_bytes"] > 0
        assert set(rec["collective_counts"]) == \
            set(rec["collective_bytes_per_device"])
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ASSIGNED)
def test_argument_bytes_match_jax_shard_shapes(run, arch, mesh):
    for shape in dryrun.SHAPES:
        key = f"{arch}_{shape}_{mesh}"
        rec, want = run["records"][key], run["jax"][key]
        held = rec["held_whole"]
        adjusted = rec["argument_bytes"] \
            - sum(h["port_bytes"] for h in held) \
            + sum(h["reference_bytes"] for h in held)
        assert adjusted == want["param_bytes"] + want["moment_bytes"] + \
            want["cache_bytes"] + want["input_bytes"], key
        for field in ("cache_bytes", "input_bytes"):
            assert rec[field] == want[field], (key, field)
        for h in held:
            leaf = h["leaf"]
            if leaf.startswith(("mu.", "nu.")):
                assert h["reference_bytes"] == want["moments"][leaf[3:]]
            else:
                assert h["reference_bytes"] == want["leaves"][leaf], leaf
            assert h["port_bytes"] > h["reference_bytes"]


def test_held_whole_names_the_port_departures(run):
    """Qwen3-1.7B's 8 kv heads do not divide tp 16: every attention
    projection of its 28 layers is held whole over tp (``wq``, ``wk``,
    ``wv``, ``wo``; the qk-norm scales are whole in both); DBRX's experts
    are whole on every tp rank of the baseline branch.  An arch whose
    heads divide tp (Phi-4-mini's 24 q / 8 kv do not; DeepSeek's 16 MLA
    heads do) departs only where its MoE does."""
    qwen = run["records"]["qwen3-1.7b_decode_32k_16x16"]["held_whole"]
    assert {h["leaf"].split(".", 2)[2] for h in qwen} == \
        {"attn.wq", "attn.wk", "attn.wv", "attn.wo"}
    assert len(qwen) == 4 * 28
    dbrx = {h["leaf"] for h in
            run["records"]["dbrx-132b_decode_32k_16x16"]["held_whole"]}
    assert "layers.0.moe.w_gate" in dbrx
    ds = {h["leaf"].rsplit(".", 1)[1] for h in run["records"][
        "deepseek-v2-lite-16b_decode_32k_16x16"]["held_whole"]}
    assert ds == {"w_gate", "w_up", "w_down"}


def test_memory_parts_add_up(run):
    """Arguments: params + moments + cache + inputs; a train step hands
    back its params and moments (updated in place) and five float32
    metrics; a serving step its cache and the rank's logits."""
    for key, rec in run["records"].items():
        parts = rec["param_bytes"] + rec["moment_bytes"] + \
            rec["cache_bytes"] + rec["input_bytes"]
        assert rec["argument_bytes"] == parts, key
        cfg = get_config(rec["arch"])
        if rec["shape"] == "train_4k":
            assert rec["output_bytes"] == rec["param_bytes"] + \
                rec["moment_bytes"] + 4 * dryrun.N_METRICS
            assert rec["cache_bytes"] == 0 and rec["moment_bytes"] > 0
        else:
            assert rec["output_bytes"] > rec["cache_bytes"] > 0, key
            assert rec["moment_bytes"] == 0
        assert rec["param_count"] == cfg.param_count()


@pytest.mark.parametrize("case", TALLY_CASES, ids=_name)
@pytest.mark.parametrize("mesh", list(TALLY_MESHES))
def test_collectives_match_spawned_ranks(run, mesh, case):
    (data, tp), batch = TALLY_MESHES[mesh]
    arch, kind, par = case
    nbytes, calls = dryrun.collectives(
        _cfg(arch), kind, Mesh({"data": data, "model": tp}),
        ParallelismConfig(**par), batch, SEQ)
    want = {k: {"calls": calls[k], "bytes": nbytes[k]} for k in calls}
    for r, got in enumerate(run["tallies"][(mesh, _name(case))]):
        assert got == want, (r, got, want)
    assert want or kind == "decode"
