"""Sequence-parallel attention (``attn_sharding="auto"``) on four tp ranks
(1, 4), float32: the dense archs and checks of
``tests/test_torch_mesh_seqpar.py`` (each rank 32 of the 128 rows;
reduced ``qwen3-1.7b``'s 2 kv heads, which ``"none"`` cannot split four
ways; ``h2o-danube-1.8b``'s window of 64 over two rank boundaries):
logits, loss and gradients against the JAX ``"auto"`` mesh step on four
host devices, 3 train steps against the JAX steps on one device, slices
and replicas."""
import pytest

from test_torch_mesh_seqpar import (AUTO, ARCHS, MESHES, STEPS, batches,
                                    check_attention_rows,
                                    check_loss_and_grads, check_logits,
                                    check_whole_attention, mesh_results,
                                    single_device)
from test_torch_mesh_train import check_slices, check_steps, configs

CASES = [(a, "1x4") for a in ARCHS]


@pytest.fixture(scope="module")
def refs():
    return {a: single_device(a, batches(configs(a)[1], 1 + STEPS))
            for a in ARCHS}


@pytest.fixture(scope="module")
def results(refs, tmp_path_factory):
    return mesh_results(refs, CASES, tmp_path_factory.mktemp("seqpar-tp4"))


@pytest.mark.parametrize("case", CASES, ids="-".join)
def test_auto_tp4_logits_match_jax_auto(refs, results, case):
    check_logits(results[0][case]["logits"], results[1][case], case[1])
    check_attention_rows(refs[case[0]]["cfg"], results[1][case], case[1])


@pytest.mark.parametrize("case", CASES, ids="-".join)
def test_auto_tp4_loss_and_grads_match_jax_auto(results, case):
    check_loss_and_grads(results[0][case], results[1][case])


@pytest.mark.parametrize("case", CASES, ids="-".join)
def test_auto_tp4_three_steps_match_jax(refs, results, case):
    check_steps(refs[case[0]], results[1][case])


@pytest.mark.parametrize("case", CASES, ids="-".join)
def test_auto_tp4_slices_and_replicas(refs, results, case):
    check_slices(refs[case[0]]["cfg"], MESHES[case[1]], results[1][case],
                 AUTO)
    check_whole_attention(refs[case[0]]["cfg"], results[1][case])
