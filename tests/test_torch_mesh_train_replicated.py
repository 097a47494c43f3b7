"""Training on a batch the data axis does not divide: at (data 2, tp 1)
with FSDP, a global batch of 3 rows is taken whole by both data ranks
(``sharding.shard_batch``), as the reference replicates it
(``input_sharding`` gives None), on reduced ``qwen3-1.7b`` and
DeepSeek-V2-Lite's baseline MoE branch, float32.

Against the JAX mesh step with the batch replicated on a host mesh of
the same shape (``tests/helpers/jax_mesh_train.py`` in a subprocess):
loss, ``lm_loss`` and the load-balance aux 1e-6 relative, every gathered
gradient within 1e-5 of its leaf's max (PR 30's bounds).  The replicated
step's gradients are the batch's own: within 1e-5 of the single-device
JAX gradients, not ``data`` times them, on every leaf, FSDP shards (the
reduce-scatter of ``fsdp_gather``'s backward) and leaves whole over data
(``data_all_reduce``'s bucket sum) alike.  Qwen3's params after 3 steps
go against 3 single-device JAX steps at the 2-lr bounds of
``test_torch_mesh_train.py``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from helpers import torch_mesh_train_ranks as ranks
from repro.configs import get_reduced
from repro.models import init_params as jax_init_params
from repro.train import optimizer as jax_opt
from repro.train.train_step import lm_loss as jax_lm_loss
from repro.train.train_step import train_step as jax_train_step
from repro_torch.configs import get_reduced as port_reduced
from repro_torch.distributed import sharding as psh
from repro_torch.launch.mesh import Mesh, spawn
from test_torch_mesh_train import check_slices, check_steps, close
from test_torch_mesh_train_moe import jax_mesh

B, S, STEPS = 3, 40, 3
OPT = dict(lr=1e-3, warmup_steps=2)
ARCHS = ("qwen3-1.7b", "deepseek-v2-lite-16b")
PAR = dict(fsdp=True)


def configs(arch):
    return (dataclasses.replace(get_reduced(arch), dtype="float32"),
            dataclasses.replace(port_reduced(arch), dtype="float32"))


def batches(cfg, n):
    rng = np.random.default_rng(0)
    out = []
    for _ in range(n):
        toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
        labels = toks.copy()
        labels[0, :3] = -100
        out.append({"tokens": toks, "labels": labels})
    return out


def single_device(arch, data):
    """The JAX single-device ``lm_loss`` gradients on the first batch, and
    the params and metrics after a train step on each of the others."""
    jcfg, _ = configs(arch)
    jp = jax.jit(jax_init_params, static_argnums=1)(jax.random.PRNGKey(0),
                                                    jcfg)
    b0 = {k: jnp.asarray(v) for k, v in data[0].items()}
    (_, m), grads = jax.jit(jax.value_and_grad(
        lambda p: jax_lm_loss(p, jcfg, b0["tokens"], b0["labels"]),
        has_aux=True))(jp)
    ocfg = jax_opt.AdamWConfig(**OPT)
    step = jax.jit(lambda p, s, b: jax_train_step(jcfg, ocfg, p, s, b))
    p, s, metrics = jp, jax_opt.init(jp), []
    for b in data[1:]:
        p, s, jm = step(p, s, {k: jnp.asarray(v) for k, v in b.items()})
        metrics.append({k: float(v) for k, v in jm.items()})
    to_np = lambda t: dict(ranks.named(jax.tree.map(np.asarray, t)))
    return jp, {"lm_loss": float(m["lm_loss"]), "grads": to_np(grads),
                "params": to_np(p), "metrics": metrics}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    out, jobs = {}, []
    for arch in ARCHS:
        data = batches(configs(arch)[0], 1 + STEPS if arch == ARCHS[0]
                       else 2)
        jp, one = single_device(arch, data)
        mesh = jax_mesh({"2x1": dict(mesh=(2, 1), ep=False, fsdp=True,
                                     batch="b0")}, jp, {"b0": data[0]},
                        tmp_path_factory.mktemp(f"jax-{arch}"), arch=arch,
                        replace=dict(dtype="float32"))["2x1"]
        out[arch] = {"one": one, "mesh": mesh}
        jobs.append(dict(cfg=configs(arch)[1],
                         tree=jax.tree.map(np.asarray, jp), batches=data,
                         steps=len(data) - 1, opt=OPT, par=PAR))
    got = spawn(ranks.train_suite, 1, (jobs,), data=2, device="cpu",
                threads=1, timeout=120, deadline=400)
    for i, arch in enumerate(ARCHS):
        out[arch]["port"] = [got[r][i] for r in range(2)]
    return out


def test_shard_batch_replicates_what_data_does_not_divide():
    """Every data rank gets all 3 rows; 4 rows split 2 and 2."""
    import torch
    cfg = configs("qwen3-1.7b")[1]
    par = psh.ParallelismConfig(**PAR)
    rows = torch.arange(12).reshape(3, 4)
    for r in range(2):
        mesh = Mesh({"data": 2, "model": 1}, rank=r)
        got = psh.shard_batch({"tokens": rows}, cfg, mesh, par)["tokens"]
        assert torch.equal(got, rows)
        four = torch.arange(16).reshape(4, 4)
        got = psh.shard_batch({"tokens": four}, cfg, mesh, par)["tokens"]
        assert torch.equal(got, four[2 * r:2 * r + 2])


@pytest.mark.parametrize("arch", ARCHS)
def test_replicated_loss_and_aux_match_jax_mesh(results, arch):
    want = results[arch]["mesh"]
    res = results[arch]["port"]
    for r in res:
        np.testing.assert_allclose(r["loss"], want["loss"], rtol=1e-6)
        np.testing.assert_allclose(r["lm_loss"], want["lm_loss"],
                                   rtol=1e-6)
        np.testing.assert_allclose(r["aux"], want["aux"], rtol=1e-6)
        assert (r["loss"], r["aux"]) == (res[0]["loss"], res[0]["aux"])
    np.testing.assert_allclose(res[0]["lm_loss"],
                               results[arch]["one"]["lm_loss"], rtol=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_replicated_grads_match_jax_mesh(results, arch):
    got = results[arch]["port"][0]["grads"]
    want = results[arch]["mesh"]["grads"]
    assert sorted(got) == sorted(want)
    for path in want:
        assert got[path].shape == want[path].shape, path
        close(got[path], want[path], 1e-5, path)


@pytest.mark.parametrize("arch", ARCHS)
def test_replicated_grads_are_not_counted_data_times(results, arch):
    """The gathered gradients equal the single-device ones (1e-5 of each
    leaf's max), FSDP shards and whole leaves alike: their norm ratio is
    1, not 2."""
    got = results[arch]["port"][0]["grads"]
    want = results[arch]["one"]["grads"]
    cfg = configs(arch)[1]
    dims = dict(ranks.named(psh.fsdp_dims(
        psh.rank_specs(cfg, Mesh({"data": 2, "model": 1}),
                       psh.ParallelismConfig(**PAR)),
        psh.ParallelismConfig(**PAR))))
    assert {d is None for d in dims.values()} == {True, False}
    for path in want:
        close(got[path], want[path], 1e-5, path)
    ratio = np.sqrt(sum(float((g ** 2).sum()) for g in got.values())
                    / sum(float((w ** 2).sum()) for w in want.values()))
    assert abs(ratio - 1.0) < 1e-5, ratio


def test_replicated_three_steps_match_jax(results):
    arch = ARCHS[0]
    check_steps(results[arch]["one"], results[arch]["port"])


@pytest.mark.parametrize("arch", ARCHS)
def test_replicated_slices_and_replicas(results, arch):
    check_slices(configs(arch)[1], (2, 1), results[arch]["port"], PAR)
