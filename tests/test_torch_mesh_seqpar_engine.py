"""``attn_sharding="auto"`` where the reference leaves it without effect,
and where it runs as ``"none"``:

* the serving engine: the JAX ``Engine`` hands its forwards no ctx, so
  its prefills attend as without a mesh whatever the parallelism says;
  ``Engine(mesh, parallelism=ParallelismConfig(fsdp=False,
  attn_sharding="auto"))`` of the port (two spawned ranks, reduced
  ``qwen3-1.7b`` float32) builds its ctx with ``"none"``, holds its
  rank's heads (``placement_specs`` under ``"none"``) and gives the JAX
  ``Engine``'s greedy tokens, completion sets, preemption counts and
  prefix stats under fcfs and slo-preempt + chunked:16;
* a length the tp axis does not divide (41 tokens at tp 2): the
  reference's ``_seq_parallel_wanted`` is false and the pass runs as
  ``"none"``, the attention whole on every rank (the ``"auto"``
  placement keeps the GQA weights whole): logits within 1e-5 of the
  largest |logit|, loss 1e-6 relative and every gradient within 1e-5 of
  its leaf's max of the ``"none"`` pass's, and every attention call over
  the whole sequence at offset 0."""
import pytest

from helpers import torch_mesh_ranks as ranks
from test_torch_mesh_engine import (PORT_CFG, check_against_jax, jax_job,
                                    tree)  # noqa: F401  (fixture)
from test_torch_mesh_seqpar import (AUTO, batches, check_loss_and_grads,
                                    check_logits, gathered_logits,
                                    run_port, single_device)
from test_torch_mesh_train import configs
from repro_torch.launch.mesh import spawn

JOBS = {
    "fcfs": dict(kind="policy", policy="fcfs", discipline="stall",
                 workload=("serve", 6, 0), attn="auto"),
    "slo-preempt-chunked": dict(kind="policy", policy="slo-preempt",
                                discipline="chunked:16",
                                workload=("serve", 6, 0), attn="auto"),
}
ODD = 41
CASES = [("qwen3-1.7b", "1x2", "auto"), ("qwen3-1.7b", "1x2", "none")]
PARS = {CASES[0]: AUTO, CASES[1]: dict(fsdp=True)}


@pytest.fixture(scope="module")
def engines(tree):                                          # noqa: F811
    specs = [dict(job, cfg=PORT_CFG, tree=tree[1],
                  engine=dict(max_slots=3, max_seq_len=256))
             for job in JOBS.values()]
    out = spawn(ranks.engine_suite, 2, (specs,), device="cpu", threads=1,
                timeout=60, deadline=240)
    return {name: [out[r][i] for r in range(2)]
            for i, name in enumerate(JOBS)}


@pytest.mark.parametrize("name", list(JOBS))
def test_auto_engine_matches_jax_engine(engines, tree, name,   # noqa: F811
                                        monkeypatch):
    job = JOBS[name]
    check_against_jax(engines[name][0], *jax_job(tree[0], job, monkeypatch),
                      job)


def test_auto_engine_runs_as_none(engines):
    h, kv, hd = PORT_CFG.num_heads, PORT_CFG.num_kv_heads, \
        PORT_CFG.head_dim
    for rec in engines["fcfs"]:
        assert rec["attn_sharding"] == "none"
        assert rec["attn_shapes"]["wq"] == (PORT_CFG.d_model, h // 2 * hd)
        assert rec["attn_shapes"]["wk"] == (PORT_CFG.d_model, kv // 2 * hd)


@pytest.fixture(scope="module")
def odd(tmp_path_factory):
    arch = CASES[0][0]
    refs = {arch: single_device(arch, batches(configs(arch)[1], 1, ODD),
                                steps=0)}
    return run_port(refs, CASES, tmp_path_factory.mktemp("odd"), steps=0,
                    pars=PARS)


def test_indivisible_length_runs_as_none(odd):
    auto, none = odd[CASES[0]], odd[CASES[1]]
    check_logits(gathered_logits(none, "1x2"), auto, "1x2")
    check_loss_and_grads(none[0], auto)
    for r in auto:
        assert r["attention_calls"] == [(ODD, ODD, 0)] * 2
