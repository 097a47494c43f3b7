"""Sequence-parallel attention (``attn_sharding="auto"``) on four tp ranks
(1, 4), float32, for the archs of ``tests/test_torch_mesh_seqpar_moe.py``:
reduced ``dbrx-132b`` on the MoE FFN's baseline branch (each rank's 32
rows its slice of the sequence), ``deepseek-v2-lite-16b`` (MLA with one
head a rank, around which the rows are gathered; the shared expert in
quarters) and ``zamba2-1.2b`` at 4 layers (the shared block's rows taken
inside it).  Logits within 1e-5 of the largest |logit| of the JAX
``"auto"`` forward on four host devices; loss and aux 1e-6 relative and
every gradient within 1e-5 of its leaf's max (5e-5 for ``A_log`` /
``dt_bias``) of the JAX ``"auto"`` mesh step; slices and replicas after
one step."""
import pytest

from test_torch_mesh_seqpar import (AUTO, MESHES, batches,
                                    check_attention_rows,
                                    check_loss_and_grads, check_logits,
                                    check_whole_attention, mesh_results,
                                    single_device)
from test_torch_mesh_train import check_slices, configs

CASES = [(a, "1x4") for a in ("dbrx-132b", "deepseek-v2-lite-16b",
                              "zamba2-1.2b")]


@pytest.fixture(scope="module")
def refs():
    return {c[0]: single_device(c[0], batches(configs(c[0])[1], 2), steps=0)
            for c in CASES}


@pytest.fixture(scope="module")
def results(refs, tmp_path_factory):
    return mesh_results(refs, CASES,
                        tmp_path_factory.mktemp("seqpar-moe-tp4"), steps=1)


@pytest.mark.parametrize("case", CASES, ids="-".join)
def test_auto_tp4_logits_match_jax_auto(refs, results, case):
    check_logits(results[0][case]["logits"], results[1][case], case[1])
    check_attention_rows(refs[case[0]]["cfg"], results[1][case], case[1])


@pytest.mark.parametrize("case", CASES, ids="-".join)
def test_auto_tp4_loss_and_grads_match_jax_auto(results, case):
    check_loss_and_grads(results[0][case], results[1][case])
    for r in results[1][case]:
        assert abs(r["aux"] - results[0][case]["aux"]) <= \
            1e-6 * abs(results[0][case]["aux"])


@pytest.mark.parametrize("case", CASES, ids="-".join)
def test_auto_tp4_slices_and_replicas(refs, results, case):
    cfg = refs[case[0]]["cfg"]
    check_slices(cfg, MESHES[case[1]], results[1][case], AUTO)
    if cfg.mla is None:
        check_whole_attention(cfg, results[1][case])
