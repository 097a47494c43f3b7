"""Sequence-parallel attention (``attn_sharding="auto"``) under a ``(data,
tp)`` mesh of spawned ranks (gloo on the CPU), float32, against the JAX
package under ``"auto"`` on a mesh of host devices of the same shape
(``tests/helpers/jax_mesh_train.py``, run in a subprocess): reduced
``qwen3-1.7b`` (4 q / 2 kv heads: heads split at tp 2 under ``"none"``,
not at tp 4; qk-norm), ``qwen2.5-7b`` (1 kv head, never split; an MLP
whose width 1353 tp does not divide) and ``h2o-danube-1.8b`` (a window of
64 that crosses the rank boundary at 128 tokens), at (1, 2) and Qwen3 at
(2, 2).  ``tests/test_torch_mesh_seqpar_moe.py`` holds DBRX, DeepSeek
and Zamba2, ``tests/test_torch_mesh_seqpar_tp4.py`` tp 4.

Under ``"auto"`` each rank keeps its 64 of the 128 rows between the
blocks and attends them at its offset against the gathered k / v; the
GQA projections are whole on every rank (``placement_specs``).  Bounds:
  * the forward's logits, put back together, within 1e-5 of the largest
    |logit| of the JAX ``"auto"`` forward on the same mesh (an absolute
    1e-5, ``test_torch_mesh_model.py``'s bound at its smaller logits,
    does not hold at these: DBRX's are 1.12e-5 off one device's at a
    largest |logit| of 4.9 under ``"none"`` as under ``"auto"``, the
    reference's ``"auto"`` equal to one device's there);
  * ``loss`` and ``lm_loss`` 1e-6 relative of the JAX mesh step;
  * every gradient, gathered, within 1e-5 of its leaf's max of the JAX
    mesh step's (5e-5 for an SSM block's ``A_log`` / ``dt_bias``);
  * after 3 train steps, metrics 1e-6 relative and params within PR
    30's bounds (``test_torch_mesh_train.check_steps``) of the JAX
    steps on one device, which the reference's ``"auto"`` equals on
    these archs to rounding;
  * each rank holds its slices under the ``"auto"`` placement (the GQA
    weights whole), and ranks holding the same slice hold the same bits.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from helpers import torch_mesh_train_ranks as ranks
from repro.models import init_params as jax_init_params
from repro.train import optimizer as jax_opt
from repro.train.train_step import lm_loss as jax_lm_loss
from repro.train.train_step import train_step as jax_train_step
from repro_torch.launch.mesh import spawn
from test_torch_mesh_train import (DECAY_LEAVES, check_slices, check_steps,
                                   close, configs)
from test_torch_mesh_train_moe import jax_mesh as moe_jax_mesh

B, S, STEPS = 4, 128, 3
OPT = dict(lr=1e-3, warmup_steps=2)
MESHES = {"1x2": (1, 2), "2x2": (2, 2), "1x4": (1, 4)}
ARCHS = ("qwen3-1.7b", "qwen2.5-7b", "h2o-danube-1.8b")
CASES = [(a, "1x2") for a in ARCHS] + [("qwen3-1.7b", "2x2")]
AUTO = dict(fsdp=True, attn_sharding="auto")


def replace_of(arch):
    """The config fields the tests replace (as ``configs`` does)."""
    kw = dict(dtype="float32")
    if arch == "zamba2-1.2b":
        kw.update(num_layers=4, layer_pattern=["ssm", "attn", "ssm", "attn"])
    return kw


def batches(cfg, n, seq=S):
    rng = np.random.default_rng(0)
    out = []
    for _ in range(n):
        toks = rng.integers(0, cfg.vocab_size, (B, seq)).astype(np.int32)
        labels = toks.copy()
        labels[0, :3] = -100
        out.append({"tokens": toks, "labels": labels})
    return out


def single_device(arch, data, steps=STEPS):
    """The JAX package on one device: its params, ``lm_loss`` and the
    gradients on the first batch, the params and metrics after
    ``steps`` train steps on the next ones."""
    jcfg, pcfg = configs(arch)
    jp = jax.jit(jax_init_params, static_argnums=1)(jax.random.PRNGKey(0),
                                                    jcfg)
    jb = lambda b: {k: jnp.asarray(v) for k, v in b.items()}
    b0 = jb(data[0])
    (loss, m), grads = jax.jit(jax.value_and_grad(
        lambda p: jax_lm_loss(p, jcfg, b0["tokens"], b0["labels"]),
        has_aux=True))(jp)
    ocfg = jax_opt.AdamWConfig(**OPT)
    step = jax.jit(lambda p, s, b: jax_train_step(jcfg, ocfg, p, s, b))
    p, s, metrics = jp, jax_opt.init(jp), []
    for b in data[1:1 + steps]:
        p, s, jm = step(p, s, jb(b))
        metrics.append({k: float(v) for k, v in jm.items()})
    to_np = lambda t: jax.tree.map(np.asarray, t)
    return {"cfg": pcfg, "jp": jp, "tree": to_np(jp), "batches": data,
            "loss": float(loss), "lm_loss": float(m["lm_loss"]),
            "grads": dict(ranks.named(to_np(grads))),
            "params": dict(ranks.named(to_np(p))), "metrics": metrics}


def jax_mesh(arch, cases, jp, data, tmp):
    """The JAX mesh steps (and forwards) of ``cases`` ({name: dict(mesh,
    ep, fsdp, attn, logits)}) on the first batch, in one subprocess of 4
    host devices -> {name: {"loss", "lm_loss", "aux", "grads",
    "logits"}}."""
    return moe_jax_mesh({n: dict(c, batch="b0") for n, c in cases.items()},
                        jp, {"b0": data[0]}, tmp, arch=arch,
                        replace=replace_of(arch))


def run_port(refs, cases, tmp, par=AUTO, steps=STEPS, pars=None):
    """Every (arch, mesh) case of each mesh in one spawn of its ranks:
    the forward's logits, loss and gradients on the first batch, then
    ``steps`` train steps -> {(arch, mesh): [each rank's result]}.
    ``pars``: a case's own parallelism fields (default ``par``); a case
    may be a tuple (arch, mesh, tag) whose ``refs`` are under its
    arch."""
    out = {}
    for name, (data, tp) in MESHES.items():
        mine = [c for c in cases if c[1] == name]
        if not mine:
            continue
        jobs = [dict(cfg=refs[c[0]]["cfg"], tree=refs[c[0]]["tree"],
                     batches=refs[c[0]]["batches"], steps=steps, opt=OPT,
                     par=dict((pars or {}).get(c, par)), logits=True)
                for c in mine]
        got = spawn(ranks.train_suite, tp, (jobs,), data=data, device="cpu",
                    threads=1, timeout=180, deadline=600)
        for i, c in enumerate(mine):
            out[c] = [got[r][i] for r in range(data * tp)]
    return out


def gathered_logits(res, mesh):
    """The data ranks' logits rows in batch order (tp rank 0 of each)."""
    data, tp = MESHES[mesh]
    return np.concatenate([res[d * tp]["logits"] for d in range(data)])


def check_logits(ref, res, mesh):
    data, tp = MESHES[mesh]
    got = gathered_logits(res, mesh)
    assert got.shape == ref.shape
    err = float(np.abs(got - ref).max())
    assert err <= 1e-5 * float(np.abs(ref).max()), err
    # every tp rank put the same whole logits together
    for r in res:
        d = r["coords"]["data"]
        assert np.array_equal(r["logits"], res[d * tp]["logits"])


def check_loss_and_grads(ref, res, paths=None):
    for r in res:
        np.testing.assert_allclose(r["lm_loss"], ref["lm_loss"], rtol=1e-6)
        np.testing.assert_allclose(r["loss"], ref["loss"], rtol=1e-6)
        assert r["loss"] == res[0]["loss"]
    got = res[0]["grads"]
    assert sorted(got) == sorted(ref["grads"])
    for path in paths or ref["grads"]:
        want = ref["grads"][path]
        assert got[path].shape == want.shape, path
        close(got[path], want,
              5e-5 if path.endswith(DECAY_LEAVES) else 1e-5, path)


def check_attention_rows(cfg, res, mesh, seq=S):
    """Every attention layer of each rank's forward called the flash
    kernels' entry on its own s/tp query rows at offset rank * s/tp
    against all s keys."""
    tp = MESHES[mesh][1]
    n = seq // tp
    for r in res:
        # MLA runs no flash kernel (nor does the reference's)
        want = [] if cfg.mla is not None else \
            [(n, seq, r["coords"]["model"] * n)] * len(cfg.attn_layers)
        assert r["attention_calls"] == want, (r["rank"],
                                              r["attention_calls"])


def check_whole_attention(cfg, res):
    """Every rank holds the GQA projections whole (every head)."""
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    for r in res:
        for path, shape in r["shapes"].items():
            if path.endswith(".attn.wq"):
                assert shape[1] == h * hd, (path, shape)
            if path.endswith((".attn.wk", ".attn.wv")):
                assert shape[1] == kv * hd, (path, shape)


def jax_cases(cases, ep=()):
    """{arch: {case name: the JAX case}} for the JAX subprocesses; the
    cases in ``ep`` on the expert-parallel branch."""
    out = {}
    for c in cases:
        out.setdefault(c[0], {})["-".join(c[1:])] = dict(
            mesh=list(MESHES[c[1]]), ep=c in ep, fsdp=True, attn="auto",
            logits=True)
    return out


def mesh_results(refs, cases, tmp, ep=(), steps=STEPS, pars=None):
    """(the JAX mesh results {case: ...}, the port's {case: ranks})."""
    jax_res = {}
    for a, cs in jax_cases(cases, ep).items():
        got = jax_mesh(a, cs, refs[a]["jp"], refs[a]["batches"], tmp)
        jax_res.update({(a,) + tuple(n.split("-")): v
                        for n, v in got.items()})
    return jax_res, run_port(refs, cases, tmp, steps=steps, pars=pars)


@pytest.fixture(scope="module")
def refs():
    return {a: single_device(a, batches(configs(a)[1], 1 + STEPS))
            for a in ARCHS}


@pytest.fixture(scope="module")
def results(refs, tmp_path_factory):
    return mesh_results(refs, CASES, tmp_path_factory.mktemp("seqpar"))


@pytest.mark.parametrize("arch,mesh", CASES)
def test_auto_logits_match_jax_auto(refs, results, arch, mesh):
    check_logits(results[0][(arch, mesh)]["logits"],
                 results[1][(arch, mesh)], mesh)
    check_attention_rows(refs[arch]["cfg"], results[1][(arch, mesh)], mesh)


@pytest.mark.parametrize("arch,mesh", CASES)
def test_auto_loss_and_grads_match_jax_auto(results, arch, mesh):
    check_loss_and_grads(results[0][(arch, mesh)], results[1][(arch, mesh)])


@pytest.mark.parametrize("arch,mesh", CASES)
def test_auto_three_steps_match_jax(refs, results, arch, mesh):
    check_steps(refs[arch], results[1][(arch, mesh)])


@pytest.mark.parametrize("arch,mesh", CASES)
def test_auto_slices_and_replicas(refs, results, arch, mesh):
    res = results[1][(arch, mesh)]
    check_slices(refs[arch]["cfg"], MESHES[mesh], res, AUTO)
    check_whole_attention(refs[arch]["cfg"], res)
