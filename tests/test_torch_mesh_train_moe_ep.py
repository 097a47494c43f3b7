"""DeepSeek-V2-Lite's MoE layer trained under a ``(data, tp)`` mesh on the
MoE FFN's expert-parallel branches (reduced ``deepseek-v2-lite-16b``,
float32, as ``tests/test_torch_mesh_train_moe.py``):

* the 2-D branch (FSDP and at most 4096 tokens in the whole batch: the
  experts as stored, ``E/tp`` of them x ``F/data`` columns a rank, the
  data ranks' rows gathered, the outputs summed over every rank) at
  (1, 2), (2, 1) and (2, 2);
* the expert-parallel branch (the sum over tp) without FSDP at (1, 2)
  and (2, 2), and with FSDP on a global batch of 8 x 520 = 4160 tokens,
  above the 2-D branch's 4096, at (2, 2), where each layer gathers its
  experts' FSDP shards.

Loss and aux go against the JAX package's mesh step
(``tests/helpers/jax_mesh_train.py``) at 1e-6 relative, and so do the
expert weights' gradients (within 1e-5 of each leaf's max).

**The reference's expert-parallel backward is wrong at tp > 1**, so the
port is not held to its other gradients.  Its loss and aux equal one
device's there (2e-7), its expert weights' gradients are right (1e-6),
but ``jax.grad`` of ``moe_ffn`` gives a wrong dx (67% of its max off at
tp 2, 95% at tp 4 on a (2, 2) / (1, 4) host mesh), the router's
gradient is 82-120% off, and every leaf upstream of the MoE layer
37-60%; at tp 1, and on the baseline branch at every tp, it is right.
``test_reference_expert_parallel_backward_trap`` pins it here.  Every
gradient of the port goes instead against the true gradient of the loss
the reference computes: the single-device JAX gradient wherever that
loss equals one device's (data 1, or the 2-D branch, whose load-balance
loss is taken over every token), else (the expert-parallel branch at
data 2, whose load-balance loss is the mean of the batch shards') the
single-device JAX gradient of that loss, written out shard by shard."""
import numpy as np
import pytest

from test_torch_mesh_train import check_slices
from test_torch_mesh_train_moe import (PCFG, check_grads, check_loss,
                                       jax_mesh, moe_inputs, run_port,
                                       sharded_grads)

CASES = {
    "ep2d-1x2": dict(mesh=(1, 2), ep=True, fsdp=True, batch="small"),
    "ep2d-2x1": dict(mesh=(2, 1), ep=True, fsdp=True, batch="small"),
    "ep2d-2x2": dict(mesh=(2, 2), ep=True, fsdp=True, batch="small"),
    "ep-1x2-nofsdp": dict(mesh=(1, 2), ep=True, fsdp=False, batch="small"),
    "ep-2x2-nofsdp": dict(mesh=(2, 2), ep=True, fsdp=False, batch="small"),
    "ep-2x2-big": dict(mesh=(2, 2), ep=True, fsdp=True, batch="big"),
}
EXPERTS = (".moe.w_gate", ".moe.w_up", ".moe.w_down")


def shards(case):
    """The batch shards whose mean the case's load-balance loss is: the
    data ranks on the (non-2-D) expert-parallel branch, else one."""
    c = CASES[case]
    two_d = c["fsdp"] and c["batch"] == "small"
    return c["mesh"][0] if not two_d else 1


@pytest.fixture(scope="module")
def results(moe_inputs, tmp_path_factory):
    jp, tree, data = moe_inputs
    ref = jax_mesh(CASES, jp, data, tmp_path_factory.mktemp("jax-mesh-ep"))
    truth = {}
    for case in CASES:
        key = (CASES[case]["batch"], shards(case))
        if key not in truth:
            truth[key] = sharded_grads(jp, data[key[0]], key[1])
    return ref, run_port(CASES, tree, data), \
        {c: truth[(CASES[c]["batch"], shards(c))] for c in CASES}


@pytest.mark.parametrize("case", list(CASES))
def test_expert_parallel_loss_and_aux_match_jax_mesh(results, case):
    ref, port, truth = results
    check_loss(ref[case], port[case])
    np.testing.assert_allclose(port[case][0]["loss"], truth[case][0],
                               rtol=1e-6)
    np.testing.assert_allclose(port[case][0]["aux"], truth[case][1],
                               rtol=1e-6)


@pytest.mark.parametrize("case", list(CASES))
def test_expert_grads_match_jax_mesh(results, case):
    ref, port, _ = results
    want = ref[case]["grads"]
    check_grads(port[case][0]["grads"], want,
                [p for p in want if p.endswith(EXPERTS)])


@pytest.mark.parametrize("case", list(CASES))
def test_every_grad_is_the_true_gradient(results, case):
    _, port, truth = results
    check_grads(port[case][0]["grads"], truth[case][2])


@pytest.mark.parametrize("case", list(CASES))
def test_reference_expert_parallel_backward_trap(results, case):
    """The JAX mesh step's gradients against the true ones: the expert
    weights right, the rest off by far more than any rounding at tp > 1,
    and right at tp 1."""
    ref, _, truth = results
    want, got = truth[case][2], ref[case]["grads"]
    worst = {p: float(np.abs(got[p] - w).max() / np.abs(w).max())
             for p, w in want.items()}
    assert max(v for p, v in worst.items() if p.endswith(EXPERTS)) <= 1e-5
    others = max(v for p, v in worst.items() if not p.endswith(EXPERTS))
    print(f"{case}: the reference's worst non-expert gradient error "
          f"{others:.3g} of its leaf's max")
    if CASES[case]["mesh"][1] > 1:
        assert others > 0.1, worst
    else:
        assert others <= 1e-5, worst


@pytest.mark.parametrize("case", list(CASES))
def test_expert_parallel_slices_and_replicas(results, case):
    check_slices(PCFG, CASES[case]["mesh"], results[1][case],
                 dict(fsdp=CASES[case]["fsdp"], expert_parallel=True))
