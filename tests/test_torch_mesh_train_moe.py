"""DeepSeek-V2-Lite's MoE layer trained under a ``(data, tp)`` mesh (reduced
``deepseek-v2-lite-16b``, float32: MLA on each rank's heads, layer 0 a
dense MLP, layer 1 4 experts top-2 with a shared expert), against the
JAX package's step on a mesh of host devices run in a subprocess
(``tests/helpers/jax_mesh_train.py``), on the MoE FFN's baseline branch
(no expert parallelism: every expert on every rank, the sequence split
over tp, the load-balance loss the mean of the batch shards' and
sequence slices' losses) at (1, 2), (2, 1) and (2, 2) with FSDP, and at
(2, 2) without.  Here the reference's mesh semantics differ from one
device (its aux is a mean over shards: 0.5947 against 0.5311 on one
device at (2, 2) in the measurement that set these cases up), and its
gradients are right, so loss, aux and every gradient go against the JAX
mesh step: loss and aux 1e-6 relative, each gathered gradient within
1e-5 of its leaf's max.  The ranks hold their slices, and after one
step their replicated leaves and moments are bit for bit alike.
``tests/test_torch_mesh_train_moe_ep.py`` holds the expert-parallel
branches."""
import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from helpers import torch_mesh_train_ranks as ranks
from repro.configs import get_reduced
from repro.models import forward_full
from repro.models import init_params as jax_init_params
from repro.train.train_step import AUX_LOSS_WEIGHT
from repro.train.train_step import lm_loss as jax_lm_loss
from repro_torch.configs import get_reduced as port_reduced
from repro_torch.launch.mesh import spawn
from test_torch_mesh_train import check_slices, close

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "deepseek-v2-lite-16b"
REPLACE = dict(dtype="float32")
JCFG = dataclasses.replace(get_reduced(ARCH), **REPLACE)
PCFG = dataclasses.replace(port_reduced(ARCH), **REPLACE)
# the global batches: 160 tokens, and 4160 (above the 2-D branch's 4096)
SHAPES = {"small": (4, 40), "big": (8, 520)}
OPT = dict(lr=1e-3, warmup_steps=1)
CASES = {
    "base-1x2": dict(mesh=(1, 2), ep=False, fsdp=True, batch="small"),
    "base-2x1": dict(mesh=(2, 1), ep=False, fsdp=True, batch="small"),
    "base-2x2": dict(mesh=(2, 2), ep=False, fsdp=True, batch="small"),
    "base-2x2-nofsdp": dict(mesh=(2, 2), ep=False, fsdp=False,
                            batch="small"),
}


def batches():
    rng = np.random.default_rng(0)
    out = {}
    for name, (b, s) in SHAPES.items():
        toks = rng.integers(0, JCFG.vocab_size, (b, s)).astype(np.int32)
        labels = toks.copy()
        labels[0, :3] = -100
        out[name] = {"tokens": toks, "labels": labels}
    return out


@pytest.fixture(scope="module")
def moe_inputs():
    jp = jax.jit(jax_init_params, static_argnums=1)(jax.random.PRNGKey(0),
                                                    JCFG)
    return jp, jax.tree.map(np.asarray, jp), batches()


def jax_mesh(cases, jp, data, tmp, arch=ARCH, replace=REPLACE):
    """The cases' JAX mesh steps, all in one subprocess of 4 host
    devices -> {case: {"loss", "lm_loss", "aux", "grads": {path:
    array}}, and "logits" where a case asks for its forward}."""
    leaves, treedef = jax.tree.flatten(jp)
    src, dst = str(tmp / "in.npz"), str(tmp / "out.npz")
    spec = {"arch": arch, "replace": replace,
            "cases": [dict(c, name=n) for n, c in cases.items()]}
    np.savez(src, spec=json.dumps(spec),
             **{f"p{i}": np.asarray(x) for i, x in enumerate(leaves)},
             **{f"{b}/{k}": v for b, d in data.items() for k, v in d.items()})
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.path.join(ROOT, "src"))
    run = subprocess.run([sys.executable, os.path.join(
        ROOT, "tests", "helpers", "jax_mesh_train.py"), src, dst], env=env,
        capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-4000:]
    out = {}
    with np.load(dst) as z:
        for n in cases:
            grads = jax.tree.unflatten(treedef, [
                z[f"{n}/g{i}"] for i in range(len(leaves))])
            out[n] = {k: float(z[f"{n}/{k}"])
                      for k in ("loss", "lm_loss", "aux")}
            out[n]["grads"] = dict(ranks.named(grads))
            if f"{n}/logits" in z.files:
                out[n]["logits"] = z[f"{n}/logits"]
    return out


def run_port(cases, tree, data):
    """Every case of each mesh shape in one spawn of its ranks: loss and
    gradients on the case's batch, then one train step on it."""
    out = {}
    for shape in dict.fromkeys(c["mesh"] for c in cases.values()):
        names = [n for n, c in cases.items() if c["mesh"] == shape]
        jobs = [dict(cfg=PCFG, tree=tree,
                     batches=[data[cases[n]["batch"]]] * 2, steps=1,
                     opt=OPT, par=dict(fsdp=cases[n]["fsdp"],
                                       expert_parallel=cases[n]["ep"]))
                for n in names]
        got = spawn(ranks.train_suite, shape[1], (jobs,), data=shape[0],
                    device="cpu", threads=1, timeout=180, deadline=600)
        for i, n in enumerate(names):
            out[n] = [got[r][i] for r in range(shape[0] * shape[1])]
    return out


def sharded_grads(jp, batch, shards):
    """(loss, aux, gradients) on one device of the loss the reference
    computes where its MoE load-balance loss is the mean of ``shards``
    batch shards' losses: the token losses summed over every row and
    divided by the valid count, plus the weighted mean of the shards'
    aux.  With one shard it is the single-device ``lm_loss``."""
    toks, labels = jnp.asarray(batch["tokens"]), jnp.asarray(batch["labels"])
    if shards == 1:
        (loss, m), g = jax.jit(jax.value_and_grad(
            lambda p: jax_lm_loss(p, JCFG, toks, labels), has_aux=True))(jp)
        return float(loss), float(m["aux_loss"]), dict(ranks.named(
            jax.tree.map(np.asarray, g)))

    def loss_fn(p):
        n = toks.shape[0] // shards
        total, count, aux = 0.0, 0, 0.0
        for r in range(shards):
            rows = slice(r * n, (r + 1) * n)
            logits, _, a = forward_full(p, JCFG, tokens=toks[rows],
                                        remat=True)
            lg = logits.astype(jnp.float32)
            lab = labels[rows]
            valid = lab >= 0
            target = jnp.take_along_axis(
                lg, jnp.maximum(lab, 0)[..., None], axis=-1)[..., 0]
            nll = jax.nn.logsumexp(lg, axis=-1) - target
            total = total + jnp.sum(jnp.where(valid, nll, 0.0))
            count = count + jnp.sum(valid)
            aux = aux + a / shards
        return total / jnp.maximum(count, 1) + AUX_LOSS_WEIGHT * aux, aux

    (loss, aux), g = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(jp)
    return float(loss), float(aux), dict(ranks.named(
        jax.tree.map(np.asarray, g)))


@pytest.fixture(scope="module")
def results(moe_inputs, tmp_path_factory):
    jp, tree, data = moe_inputs
    ref = jax_mesh(CASES, jp, data, tmp_path_factory.mktemp("jax-mesh"))
    return ref, run_port(CASES, tree, data)


def check_loss(ref, res):
    for r in res:
        np.testing.assert_allclose(r["loss"], ref["loss"], rtol=1e-6)
        np.testing.assert_allclose(r["aux"], ref["aux"], rtol=1e-6)
        assert (r["loss"], r["aux"]) == (res[0]["loss"], res[0]["aux"])


def check_grads(got, want, paths=None):
    for path in paths or want:
        assert got[path].shape == want[path].shape, path
        close(got[path], want[path], 1e-5, path)


@pytest.mark.parametrize("case", list(CASES))
def test_baseline_loss_and_aux_match_jax_mesh(results, case):
    check_loss(results[0][case], results[1][case])


@pytest.mark.parametrize("case", list(CASES))
def test_baseline_grads_match_jax_mesh(results, case):
    check_grads(results[1][case][0]["grads"], results[0][case]["grads"])


@pytest.mark.parametrize("case", list(CASES))
def test_moe_slices_and_replicas(results, case):
    check_slices(PCFG, CASES[case]["mesh"], results[1][case],
                 dict(fsdp=CASES[case]["fsdp"], expert_parallel=False))
