"""The port's training path against the JAX package's on every arch the
JAX launcher trains beyond the dense decoders (``tests/test_torch_train.py``
holds reduced ``qwen3-1.7b``; ``tests/test_torch_moe.py`` DeepSeek's loss
and gradients): reduced ``mamba2-780m`` (SSM layers through the
differentiable SSD scan), ``zamba2-1.2b`` at four layers (SSM, ATTN, SSM,
ATTN), so the shared attention block's gradient is the sum over its two
uses, ``qwen2-vl-7b`` on float32 ``embeds`` with M-RoPE, and
``musicgen-medium`` on ``[B, S, 4]`` tokens and labels.  Float32, from
bridged parameters and the same numpy batches.  S = 40: the SSD scan
pads a ragged 32-row chunk and attention takes the flash path.

Bounds, those of ``tests/test_torch_train.py``: ``lm_loss`` 1e-6
relative; every leaf's gradient within 1e-5 of that leaf's largest
|gradient| (f32 sums in another order), but for an SSM block's
``A_log`` and ``dt_bias``, 5e-5: their gradients sum dt·da (and da)
over every row, terms that cancel, and JAX's own float32 gradient of
``A_log`` is up to 3.4e-5 of its max off a float64 run of the same
model, the port's up to 1.6e-5 (``test_ssm_decay_grads_against_float64``
measures both and holds the port to 2e-5); one ``train_step``: loss and
grad norm 1e-6 relative, params within half a learning rate everywhere
and within 1e-6 on all but max(8, 1e-3 numel) elements of each leaf
(the count of ``chip_smoke.py``'s train parity: the first AdamW step
moves an element by lr·g/(|g| + eps), so an element whose gradient is
within rounding of 0 may move another way; a leaf of fewer than 8000
elements, a norm scale, is allowed that many and not 1e-3 of them).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced
from repro.models import init_params as jax_init_params
from repro.models.config import ATTN, SSM
from repro.train import optimizer as jax_opt
from repro.train.train_step import lm_loss as jax_lm_loss
from repro.train.train_step import train_step as jax_train_step
from repro_torch.bridge import from_jax_opt_state, from_jax_params
from repro_torch.train import optimizer as opt
from repro_torch.train.train_step import loss_and_grads, make_train_step

torch.set_num_threads(2)
B, S = 2, 40
# leaves whose gradient sums dt·da over every row (see above)
DECAY_LEAVES = ("A_log", "dt_bias")
ARCHS = ("mamba2-780m", "zamba2-1.2b", "qwen2-vl-7b", "musicgen-medium")


def arch_cfg(arch):
    cfg = dataclasses.replace(get_reduced(arch), dtype="float32")
    if arch == "zamba2-1.2b":
        cfg = dataclasses.replace(cfg, num_layers=4,
                                  layer_pattern=(SSM, ATTN, SSM, ATTN))
    return cfg


def batch_np(cfg, rng):
    """The JAX launcher's batch kinds: float32 embeds + labels for a
    VLM, [B, S, K] tokens for K codebooks, else [B, S] tokens; some
    labels set to -100 (ignored)."""
    if cfg.uses_extra_embeds:
        out = {"embeds": rng.normal(0, 1, (B, S, cfg.d_model))
               .astype(np.float32),
               "labels": rng.integers(0, cfg.vocab_size, (B, S))
               .astype(np.int32)}
    else:
        shape = (B, S, cfg.num_codebooks) if cfg.num_codebooks else (B, S)
        toks = rng.integers(0, cfg.vocab_size, shape).astype(np.int32)
        out = {"tokens": toks, "labels": toks.copy()}
    out["labels"][0, :3] = -100
    return out


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def jax_params():
    cache = {}

    def get(arch):
        if arch not in cache:
            cfg = arch_cfg(arch)
            cache[arch] = (cfg, jax.jit(jax_init_params, static_argnums=1)(
                jax.random.PRNGKey(0), cfg))
        return cache[arch]
    return get


@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_and_grads_match_jax(jax_params, arch, remat):
    cfg, jp = jax_params(arch)
    b = batch_np(cfg, np.random.default_rng(0))
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    (want, want_m), want_g = jax.jit(jax.value_and_grad(
        lambda p: jax_lm_loss(p, cfg, jb.get("tokens"), jb["labels"],
                              embeds=jb.get("embeds"), remat=remat),
        has_aux=True))(jp)
    params = from_jax_params(_np(jp), "cpu")
    loss, metrics, grads = loss_and_grads(
        cfg, params, {k: torch.from_numpy(v) for k, v in b.items()},
        remat=remat)
    np.testing.assert_allclose(float(loss), float(want), rtol=1e-6)
    np.testing.assert_allclose(float(metrics["lm_loss"]),
                               float(want_m["lm_loss"]), rtol=1e-6)
    for (path, g), (_, w) in zip(_named(grads),
                                 _named(from_jax_params(_np(want_g), "cpu"))):
        assert g.shape == w.shape
        err = float((g - w).abs().max())
        rel = 5e-5 if path.endswith(DECAY_LEAVES) else 1e-5
        assert err <= rel * float(w.abs().max()), (arch, path, err)
    # every leaf the loss reaches has a gradient (a VLM's token table is
    # not reached under an embeds batch: zeros, as in JAX)
    for (path, g) in _named(grads):
        reached = not (cfg.uses_extra_embeds and path == "embed")
        assert bool(g.abs().max() > 0) == reached, path


def _named(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _named(v, f"{prefix}.{k}" if prefix else k)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _named(v, f"{prefix}[{i}]")
    else:
        yield prefix, tree


@pytest.mark.parametrize("arch", ARCHS)
def test_one_train_step_matches_jax(jax_params, arch):
    cfg, jp = jax_params(arch)
    ocfg = jax_opt.AdamWConfig(lr=1e-3, warmup_steps=1)
    js = jax_opt.init(jp)
    b = batch_np(cfg, np.random.default_rng(1))
    jp2, _, jm = jax.jit(lambda p, s, bb: jax_train_step(cfg, ocfg, p, s,
                                                         bb))(
        jp, js, {k: jnp.asarray(v) for k, v in b.items()})
    params = from_jax_params(_np(jp), "cpu")
    state = from_jax_opt_state(_np(js), "cpu")
    step = make_train_step(cfg, opt.AdamWConfig(lr=1e-3, warmup_steps=1))
    params, state, m = step(params, state,
                            {k: torch.from_numpy(v) for k, v in b.items()})
    for key in ("loss", "lm_loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=1e-6)
    for (path, g), (_, w) in zip(_named(params),
                                 _named(from_jax_params(_np(jp2), "cpu"))):
        d = (g - w).abs()
        assert float(d.max()) <= 0.5 * float(jm["lr"]), path
        assert int((d > 1e-6).sum()) <= max(8, 1e-3 * d.numel()), (
            path, int((d > 1e-6).sum()), float(d.max()))
    assert int(state.step) == 1


def float64_report(arch):
    """Worst gradient error per leaf, as a share of its max, of JAX's and
    the port's float32 gradients against the port run in float64: the
    parameters and the batch cast to float64, which every norm, rotation,
    attention, scan and loss of the port keeps (``device.upcast``)."""
    cfg = arch_cfg(arch)
    jp = jax.jit(jax_init_params, static_argnums=1)(jax.random.PRNGKey(0),
                                                     cfg)
    b = batch_np(cfg, np.random.default_rng(0))
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    _, want_g = jax.jit(jax.value_and_grad(
        lambda p: jax_lm_loss(p, cfg, jb.get("tokens"), jb["labels"],
                              embeds=jb.get("embeds")), has_aux=True))(jp)
    params = from_jax_params(_np(jp), "cpu")
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    got = {"jax": from_jax_params(_np(want_g), "cpu"),
           "port": loss_and_grads(cfg, params, tb)[2]}
    truth = loss_and_grads(
        cfg, opt.tree_map(torch.Tensor.double, params),
        {k: v.double() if v.is_floating_point() else v
         for k, v in tb.items()})[2]
    assert all(t.dtype == torch.float64 for t in opt.leaves(truth))
    return {who: {path: float((g.double() - t).abs().max())
                  / max(float(t.abs().max()), 1e-300)
                  for (path, g), (_, t) in zip(_named(tree), _named(truth))}
            for who, tree in got.items()}


@pytest.mark.parametrize("arch", ["mamba2-780m", "zamba2-1.2b"])
def test_ssm_decay_grads_against_float64(arch):
    """The port's float32 gradients against its own float64 run: every
    leaf within 1e-5 of its max but ``A_log`` / ``dt_bias`` within 2e-5
    (measured up to 1.6e-5); JAX's errors are printed beside."""
    rep = float64_report(arch)
    for path, err in rep["port"].items():
        rel = 2e-5 if path.endswith(DECAY_LEAVES) else 1e-5
        assert err <= rel, (arch, path, err, rep["jax"][path])
    worst = {who: max(r.items(), key=lambda kv: kv[1])
             for who, r in rep.items()}
    print(f"{arch}: worst gradient error against float64: {worst}")
