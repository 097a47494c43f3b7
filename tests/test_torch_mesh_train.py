"""The port's training step under a ``(data, tp)`` mesh with FSDP (ranks
spawned on the CPU over gloo) against the JAX package's single-device
step, float32, from bridged parameters and the same global numpy batches:
reduced ``qwen3-1.7b`` (4 q / 2 kv heads: the heads split at tp 2, the
vocabulary too), ``qwen2-vl-7b`` on float32 ``embeds`` with M-RoPE (1 kv
head, so its attention runs whole on every tp rank) and a 6 q / 3 kv
model (whole attention with FSDP), at (data 2, tp 1) and (1, 2), Qwen3
and the 6 / 3 model also at (2, 2).  ``tests/test_torch_mesh_train_archs.py``
holds Mamba2, Zamba2 and MusicGen the same way; DeepSeek's MoE branches
are in ``tests/test_torch_mesh_train_moe.py``.

On a mesh the reference's result is the single-device one (the JAX mesh
step gives the single-device loss to 1e-7 relative and the same gradient
norm on these archs), so that is what the ranks are held to, with the
bounds of ``tests/test_torch_train.py``:
  * ``lm_loss`` 1e-6 relative;
  * every gradient, gathered from the ranks' slices, within 1e-5 of its
    leaf's largest |gradient| (f32 sums in another order; 5e-5 for an
    SSM block's ``A_log`` / ``dt_bias``, as ``test_torch_train_archs.py``
    holds them);
  * after 3 steps the params within 1e-6 on all but 1e-3 of each leaf's
    elements, within half a learning rate on all but max(8, 1e-3 numel)
    of them and within 2 learning rates everywhere (``chip_smoke.py``'s
    train parity bound).  Where a gradient is within rounding of 0, AdamW
    may move its element the other way by up to the step's lr: after 3
    steps from the same params, one element of Zamba2's ``embed`` is
    0.73 lr off JAX's on one device too, so half an lr cannot hold on
    every element.
And on the ranks themselves: each holds exactly its slice of every leaf
(the shapes the placement specs give), every leaf and moment a rank
holds whole over an axis is bit for bit alike on the ranks of that axis,
every rank reports the same loss, and a checkpoint saved under the mesh
is the single-device file of the gathered params and restores each
rank's slices bit for bit."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from helpers import torch_mesh_train_ranks as ranks
from repro.configs import get_reduced
from repro.models import ModelConfig as JaxConfig
from repro.models import init_params as jax_init_params
from repro.models.config import ATTN, SSM
from repro.train import optimizer as jax_opt
from repro.train.train_step import lm_loss as jax_lm_loss
from repro.train.train_step import train_step as jax_train_step
from repro_torch.configs import get_reduced as port_reduced
from repro_torch.distributed import sharding as psh
from repro_torch.launch.mesh import Mesh, spawn
from repro_torch.models.config import ModelConfig as PortConfig
from repro_torch.models.model import init_params

B, S, STEPS = 4, 40, 3
OPT = dict(lr=1e-3, warmup_steps=2)
# leaves whose gradient sums dt·da over every row (test_torch_train_archs)
DECAY_LEAVES = ("A_log", "dt_bias")
KV3 = dict(name="t-kv3", family="dense", num_layers=2, d_model=48,
           num_heads=6, num_kv_heads=3, head_dim=8, d_ff=96, vocab_size=128,
           dtype="float32")
ARCHS = ("qwen3-1.7b", "qwen2-vl-7b", "kv3")
MESHES = {"2x1": (2, 1), "1x2": (1, 2), "2x2": (2, 2)}
# (arch, mesh) cases: every arch at (2, 1) and (1, 2), two at (2, 2)
CASES = [(a, m) for m in ("2x1", "1x2") for a in ARCHS] + \
    [(a, "2x2") for a in ARCHS if a in ("qwen3-1.7b", "kv3")]


def configs(arch):
    """(JAX cfg, port cfg) of ``arch``, reduced, float32 (Zamba2 at 4
    layers, its shared block used twice)."""
    if arch == "kv3":
        return JaxConfig(**KV3), PortConfig(**KV3)
    kw = dict(dtype="float32")
    if arch == "zamba2-1.2b":
        kw.update(num_layers=4, layer_pattern=(SSM, ATTN, SSM, ATTN))
    return (dataclasses.replace(get_reduced(arch), **kw),
            dataclasses.replace(port_reduced(arch), **kw))


def batch_np(cfg, rng):
    """A global batch of the JAX launcher's kind (float32 embeds for a
    VLM, [B, S, K] tokens for K codebooks), the first row's first three
    labels ignored."""
    if cfg.uses_extra_embeds:
        out = {"embeds": rng.normal(0, 1, (B, S, cfg.d_model))
               .astype(np.float32),
               "labels": rng.integers(0, cfg.vocab_size, (B, S))
               .astype(np.int32)}
    else:
        shape = (B, S, cfg.num_codebooks) if cfg.num_codebooks > 1 \
            else (B, S)
        toks = rng.integers(0, cfg.vocab_size, shape).astype(np.int32)
        out = {"tokens": toks, "labels": toks.copy()}
    out["labels"][0, :3] = -100
    return out


def jax_reference(arch):
    """The single-device JAX reference of ``arch``: its params, the
    global batches, ``lm_loss`` and its gradients on the first batch,
    and the params and metrics after STEPS train steps on the next."""
    jcfg, pcfg = configs(arch)
    jp = jax.jit(jax_init_params, static_argnums=1)(jax.random.PRNGKey(0),
                                                    jcfg)
    rng = np.random.default_rng(0)
    batches = [batch_np(jcfg, rng) for _ in range(1 + STEPS)]
    jb = lambda b: {k: jnp.asarray(v) for k, v in b.items()}
    b0 = jb(batches[0])
    (loss, m), grads = jax.jit(jax.value_and_grad(
        lambda p: jax_lm_loss(p, jcfg, b0.get("tokens"), b0["labels"],
                              embeds=b0.get("embeds")), has_aux=True))(jp)
    ocfg = jax_opt.AdamWConfig(**OPT)
    step = jax.jit(lambda p, s, b: jax_train_step(jcfg, ocfg, p, s, b))
    p, s, metrics = jp, jax_opt.init(jp), []
    for b in batches[1:]:
        p, s, jm = step(p, s, jb(b))
        metrics.append({k: float(v) for k, v in jm.items()})
    to_np = lambda t: jax.tree.map(np.asarray, t)
    return {"cfg": pcfg, "tree": to_np(jp), "batches": batches,
            "loss": float(loss), "lm_loss": float(m["lm_loss"]),
            "grads": dict(ranks.named(to_np(grads))),
            "params": dict(ranks.named(to_np(p))), "metrics": metrics}


def run_port(refs, cases, meshes, tmp, par=None):
    """Every case of each mesh in one spawn of that mesh's ranks ->
    {(arch, mesh): [each rank's result]}."""
    out = {}
    for name in meshes:
        arches = [a for a, m in cases if m == name]
        if not arches:
            continue
        data, tp = meshes[name]
        jobs = [dict(cfg=refs[a]["cfg"], tree=refs[a]["tree"],
                     batches=refs[a]["batches"], steps=STEPS, opt=OPT,
                     par=dict(fsdp=True, **(par or {})),
                     ckpt=str(tmp / f"{a}-{name}"))
                for a in arches]
        got = spawn(ranks.train_suite, tp, (jobs,), data=data, device="cpu",
                    threads=1, timeout=120, deadline=400)
        for i, a in enumerate(arches):
            out[(a, name)] = [got[r][i] for r in range(data * tp)]
    return out


@pytest.fixture(scope="module")
def refs():
    return {a: jax_reference(a) for a in ARCHS}


@pytest.fixture(scope="module")
def port(refs, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh-train")
    return run_port(refs, CASES, MESHES, tmp), tmp


def close(got, want, rel, what):
    err = float(np.abs(got - want).max())
    assert err <= rel * float(np.abs(want).max()), (what, err)


def check_loss_and_grads(ref, res):
    for r in res:
        np.testing.assert_allclose(r["lm_loss"], ref["lm_loss"], rtol=1e-6)
        np.testing.assert_allclose(r["loss"], ref["loss"], rtol=1e-6)
        assert r["loss"] == res[0]["loss"]          # alike on every rank
    got = res[0]["grads"]
    assert sorted(got) == sorted(ref["grads"])
    for path, want in ref["grads"].items():
        assert got[path].shape == want.shape, path
        close(got[path], want,
              5e-5 if path.endswith(DECAY_LEAVES) else 1e-5, path)


def check_steps(ref, res):
    lr = ref["metrics"][-1]["lr"]
    for r in res:
        for got, want in zip(r["steps"], ref["metrics"]):
            for key in ("loss", "lm_loss", "grad_norm", "lr"):
                np.testing.assert_allclose(got[key], want[key], rtol=1e-6)
    got = res[0]["params"]
    for path, want in ref["params"].items():
        d = np.abs(got[path] - want)
        assert float((d > 1e-6).mean()) <= 1e-3, path
        assert int((d > 0.5 * lr).sum()) <= max(8, 1e-3 * d.size), path
        assert float(d.max()) <= 2 * lr, (path, float(d.max()))


def check_slices(cfg, mesh_shape, res, par=None):
    """Each rank's leaf shapes are its slices under the placement specs
    (``par``: the ``ParallelismConfig`` fields, default FSDP), and ranks
    holding the same slice of a leaf hold the same bits of it and of its
    moments."""
    par = psh.ParallelismConfig(**(par or dict(fsdp=True)))
    full = dict(ranks.named(init_params(cfg, device="meta")))
    for r in res:
        mesh = Mesh(dict(zip(("data", "model"), mesh_shape)), rank=r["rank"])
        specs = dict(ranks.named(psh.rank_specs(cfg, mesh, par)))
        for path, shape in r["shapes"].items():
            assert shape == psh.local_shape(full[path].shape, specs[path],
                                            mesh), path
    for path in res[0]["digests"]:
        held = {}
        for r in res:
            held.setdefault(r["slices"][path], set()).add(r["digests"][path])
        assert all(len(d) == 1 for d in held.values()), path


def check_checkpoint(res, tmp, name):
    """The file rank 0 wrote under the mesh is the single-device file of
    the gathered params and moments, key by key and bit for bit, and
    every rank restored its slices from it bit for bit."""
    assert all(r["restored"] for r in res)
    base = str(tmp / name)
    with np.load(base + ".npz") as z, np.load(base + "-single.npz") as w:
        assert sorted(z.files) == sorted(w.files)
        assert any(k.startswith("mu//") for k in z.files)
        for k in w.files:
            assert z[k].dtype == w[k].dtype and np.array_equal(z[k], w[k]), k
    with open(base + ".json") as f, open(base + "-single.json") as g:
        assert f.read() == g.read()


@pytest.mark.parametrize("arch,mesh", CASES)
def test_mesh_loss_and_grads_match_jax(refs, port, arch, mesh):
    check_loss_and_grads(refs[arch], port[0][(arch, mesh)])


@pytest.mark.parametrize("arch,mesh", CASES)
def test_mesh_three_steps_match_jax(refs, port, arch, mesh):
    check_steps(refs[arch], port[0][(arch, mesh)])


@pytest.mark.parametrize("arch,mesh", CASES)
def test_mesh_slices_and_replicas(refs, port, arch, mesh):
    check_slices(refs[arch]["cfg"], MESHES[mesh], port[0][(arch, mesh)])


@pytest.mark.parametrize("arch,mesh", CASES)
def test_mesh_checkpoint_round_trip(port, arch, mesh):
    check_checkpoint(port[0][(arch, mesh)], port[1], f"{arch}-{mesh}")
