"""Sequence-parallel attention (``attn_sharding="auto"``) on the MoE archs
and the hybrid, at (1, 2), float32, as ``tests/test_torch_mesh_seqpar.py``
holds the dense ones: reduced ``dbrx-132b`` (GQA with 1 kv head, 4
experts top-2 on every layer) on the MoE FFN's baseline branch (the
rows are each rank's slice of the sequence already: the router and the
experts enter them, the load-balance loss the mean of the slices') and
on the expert-parallel branch (the rows gathered, run as on the whole
sequence, the rank's rows handed back); ``deepseek-v2-lite-16b`` (MLA,
which the reference keeps off the sequence path: the rows gathered
around it; layer 1 an MoE with a split shared expert) on the baseline
branch; ``zamba2-1.2b`` at 4 layers (SSM, ATTN, SSM, ATTN: the residual
stays whole, the shared GQA block takes its rows inside ``gqa_full``).

Logits within 1e-5 of the JAX ``"auto"`` forward on the same mesh, loss
and aux 1e-6 relative of the JAX ``"auto"`` mesh step, every gradient
within 1e-5 of its leaf's max of it (5e-5 for ``A_log`` / ``dt_bias``):
on the baseline branch the reference's mesh semantics are the result
(its aux is the mean over the slices, not one device's), and its
gradients are right.  On the expert-parallel branch the reference's
backward at tp > 1 is wrong (``tests/test_torch_mesh_train_moe_ep.py``),
so its expert weights' gradients go against the JAX mesh step and every
gradient against the true one, the single-device JAX gradient (data 1:
the loss is one device's).  Zamba2 also takes 3 train steps against the
JAX steps on one device (``test_torch_mesh_train.check_steps``'
bounds)."""
import pytest

from test_torch_mesh_seqpar import (AUTO, STEPS, MESHES, batches,
                                    check_attention_rows,
                                    check_loss_and_grads, check_logits,
                                    check_whole_attention, mesh_results,
                                    single_device)
from test_torch_mesh_train import check_slices, check_steps, configs
from test_torch_mesh_train_moe_ep import EXPERTS

EP = ("dbrx-132b", "1x2", "ep")
CASES = [("dbrx-132b", "1x2"), EP, ("deepseek-v2-lite-16b", "1x2"),
         ("zamba2-1.2b", "1x2")]
PARS = {EP: dict(AUTO, expert_parallel=True)}


@pytest.fixture(scope="module")
def refs():
    return {a: single_device(a, batches(configs(a)[1], 1 + STEPS),
                             steps=STEPS if a == "zamba2-1.2b" else 0)
            for a in dict.fromkeys(c[0] for c in CASES)}


@pytest.fixture(scope="module")
def results(refs, tmp_path_factory):
    return mesh_results(refs, CASES, tmp_path_factory.mktemp("seqpar-moe"),
                        ep=(EP,), pars=PARS)


@pytest.mark.parametrize("case", CASES, ids="-".join)
def test_auto_logits_match_jax_auto(refs, results, case):
    check_logits(results[0][case]["logits"], results[1][case], case[1])
    check_attention_rows(refs[case[0]]["cfg"], results[1][case], case[1])


@pytest.mark.parametrize("case", [c for c in CASES if c != EP],
                         ids="-".join)
def test_auto_loss_and_grads_match_jax_auto(results, case):
    check_loss_and_grads(results[0][case], results[1][case])
    for r in results[1][case]:
        assert abs(r["aux"] - results[0][case]["aux"]) <= \
            1e-6 * abs(results[0][case]["aux"])


def test_auto_expert_parallel_grads(refs, results):
    """Loss and aux as the JAX mesh step's; every gradient the true one
    (the single-device JAX gradient); the leaves downstream of the last
    MoE layer's input as the JAX mesh step's too.  Upstream of that the
    reference's expert-parallel backward at tp > 1 is wrong
    (``test_torch_mesh_train_moe_ep.py``): DBRX has an MoE FFN on every
    layer, so layer 0's expert weights' gradients are off as well (52-76%
    of their max in the measurement that set this case up; the port's
    within 3.5e-6 of the truth)."""
    ref, res = results[0][EP], results[1][EP]
    truth = refs["dbrx-132b"]
    check_loss_and_grads(truth, res)
    last = f"layers[{len(truth['cfg'].layer_pattern) - 1}]"
    check_loss_and_grads(ref, res, [
        p for p in ref["grads"] if p in ("lm_head", "final_norm.scale")
        or (p.startswith(last) and p.endswith(EXPERTS))])


def test_auto_hybrid_three_steps_match_jax(refs, results):
    check_steps(refs["zamba2-1.2b"], results[1][("zamba2-1.2b", "1x2")])


@pytest.mark.parametrize("case", CASES, ids="-".join)
def test_auto_slices_and_replicas(refs, results, case):
    cfg, res = refs[case[0]]["cfg"], results[1][case]
    check_slices(cfg, MESHES[case[1]], res, PARS.get(case, AUTO))
    if cfg.mla is None:
        check_whole_attention(cfg, res)
