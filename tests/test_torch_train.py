"""The port's training path against the JAX package's on reduced
``qwen3-1.7b`` in float32, from bridged parameters and the same numpy
batches.

Attention runs the port's differentiable flash path (S = 32 qualifies
for the kernel; on CPU tensors that is ``FlashAttentionFn`` with the
plain forward and backward); the JAX side runs its einsum attention.

Bounds, each with its reason:
  * ``lm_loss``: 1e-6 relative (measured 7e-8); every leaf's gradient
    within 1e-5 of that leaf's largest |gradient| (measured 2e-6: f32
    sums taken in another order by the two frameworks);
  * ``optimizer.apply`` from the same grads and moments: 1e-6, the
    reference's own optimizer arithmetic in f32;
  * 3 ``train_step``s: losses and grad norms 1e-6 relative; params
    within 1e-6 on all but 1e-3 of the elements and within half a
    learning rate everywhere (measured: at most 1.2e-4 of the elements
    beyond 1e-6, max 0.17 lr).  Adam moves an element by about lr ×
    m̂ / √v̂; where successive gradients nearly cancel, m̂ is a small
    difference and the 2e-6 gradient differences decide its size.
"""
import dataclasses
import json
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced
from repro.models import init_params as jax_init_params
from repro.train import optimizer as jax_opt
from repro.train.train_step import lm_loss as jax_lm_loss
from repro.train.train_step import train_step as jax_train_step
from repro_torch.bridge import from_jax_opt_state, from_jax_params
from repro_torch.models.model import forward_full, init_params
from repro_torch.train import optimizer as opt
from repro_torch.train.train_step import (lm_loss, loss_and_grads,
                                          make_train_step)

torch.set_num_threads(2)
SRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src")
CFG = dataclasses.replace(get_reduced("qwen3-1.7b"), dtype="float32")
B, S = 2, 32


@pytest.fixture(scope="module")
def jax_params():
    return jax.jit(jax_init_params, static_argnums=1)(jax.random.PRNGKey(0),
                                                      CFG)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _tokens(rng):
    return rng.integers(0, CFG.vocab_size, (B, S)).astype(np.int32)


def _pairs(a, b):
    """Leaves of two trees paired by key path."""
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            yield from _pairs(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            yield from _pairs(x, y)
    else:
        yield a, b


def _leaf_close(got_tree, want_tree, rel):
    for g, w in _pairs(got_tree, want_tree):
        assert g.shape == w.shape
        err = float((g - w).abs().max())
        assert err <= rel * float(w.abs().max()), (tuple(g.shape), err)


def test_lm_loss_and_grads_match_jax(jax_params):
    rng = np.random.default_rng(0)
    toks = _tokens(rng)
    labels = _tokens(rng)
    labels[0, :3] = -100                        # ignored positions
    mask = np.ones((B, S), np.int32)
    mask[1, -5:] = 0
    (want, want_m), want_g = jax.jit(jax.value_and_grad(
        lambda p: jax_lm_loss(p, CFG, jnp.asarray(toks), jnp.asarray(labels),
                              mask=jnp.asarray(mask)), has_aux=True))(
        jax_params)
    params = from_jax_params(_np(jax_params), "cpu")
    batch = {"tokens": torch.from_numpy(toks),
             "labels": torch.from_numpy(labels),
             "mask": torch.from_numpy(mask)}
    loss, metrics, grads = loss_and_grads(CFG, params, batch)
    np.testing.assert_allclose(float(loss), float(want), rtol=1e-6)
    np.testing.assert_allclose(float(metrics["lm_loss"]),
                               float(want_m["lm_loss"]), rtol=1e-6)
    assert float(metrics["aux_loss"]) == 0.0
    _leaf_close(grads, from_jax_params(_np(want_g), "cpu"), 1e-5)
    # every param leaf is back to not requiring grad
    assert not any(t.requires_grad for t in opt.leaves(params))


def test_remat_gives_the_same_gradients(jax_params):
    """Checkpointed layers recompute the same ops on the same inputs."""
    params = from_jax_params(_np(jax_params), "cpu")
    toks = torch.from_numpy(_tokens(np.random.default_rng(1)))
    batch = {"tokens": toks, "labels": toks}
    l0, _, g0 = loss_and_grads(CFG, params, batch, remat=False)
    l1, _, g1 = loss_and_grads(CFG, params, batch, remat=True)
    assert float(l0) == float(l1)
    for a, b in _pairs(g0, g1):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="remat"):
        forward_full(params, CFG, tokens=toks, cache={}, remat=True)


def test_optimizer_apply_matches_jax(jax_params):
    rng = np.random.default_rng(2)
    leaves, treedef = jax.tree.flatten(_np(jax_params))
    grads = [rng.standard_normal(x.shape).astype(np.float32) for x in leaves]
    mu = [0.1 * rng.standard_normal(x.shape).astype(np.float32)
          for x in leaves]
    nu = [0.01 + rng.random(x.shape).astype(np.float32) for x in leaves]
    unflat = lambda xs: jax.tree.unflatten(treedef, xs)
    cfg = jax_opt.AdamWConfig(warmup_steps=10)
    state = jax_opt.AdamWState(step=jnp.asarray(4, jnp.int32),
                               mu=unflat(mu), nu=unflat(nu))
    want_p, want_s, want_m = jax.jit(jax_opt.apply, static_argnums=0)(
        cfg, jax_params, unflat(grads), state)
    params = from_jax_params(_np(jax_params), "cpu")
    tstate = from_jax_opt_state(_np(state), "cpu")
    got_p, got_s, got_m = opt.apply(
        opt.AdamWConfig(warmup_steps=10), params,
        from_jax_params(unflat(grads), "cpu"), tstate)
    assert got_p is params and got_s is tstate      # updated in place
    assert int(got_s.step) == int(want_s.step) == 5
    tol = dict(rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(float(got_m["grad_norm"]),
                               float(want_m["grad_norm"]), **tol)
    np.testing.assert_allclose(float(got_m["lr"]), float(want_m["lr"]), **tol)
    for got, want in ((got_p, want_p), (got_s.mu, want_s.mu),
                      (got_s.nu, want_s.nu)):
        for g, w in _pairs(got, _np(want)):
            np.testing.assert_allclose(g.numpy(), w, **tol)


def test_three_train_steps_match_jax(jax_params):
    ocfg = jax_opt.AdamWConfig(lr=1e-3, warmup_steps=2)
    jstep = jax.jit(lambda p, s, b: jax_train_step(CFG, ocfg, p, s, b))
    jp, js = jax_params, jax_opt.init(jax_params)
    params = from_jax_params(_np(jp), "cpu")
    state = from_jax_opt_state(_np(js), "cpu")
    step = make_train_step(CFG, opt.AdamWConfig(lr=1e-3, warmup_steps=2))
    rng = np.random.default_rng(3)
    for _ in range(3):
        toks = _tokens(rng)
        jp, js, jm = jstep(jp, js, {"tokens": jnp.asarray(toks),
                                    "labels": jnp.asarray(toks)})
        t = torch.from_numpy(toks)
        params, state, m = step(params, state, {"tokens": t, "labels": t})
        assert set(m) == set(jm)
        for key in ("loss", "lm_loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(m[key]), float(jm[key]),
                                       rtol=1e-6)
        want = from_jax_params(_np(jp), "cpu")
        for g, w in _pairs(params, want):
            d = (g - w).abs()
            assert float(d.max()) <= 0.5 * float(jm["lr"])
            assert float((d > 1e-6).float().mean()) <= 1e-3
    assert int(state.step) == 3


def test_bf16_step_keeps_dtypes_and_unported_batches_raise():
    cfg = get_reduced("qwen3-1.7b")                 # bfloat16
    params = init_params(cfg, seed=0, device="cpu")
    state = opt.init(params)
    toks = torch.from_numpy(_tokens(np.random.default_rng(4)))
    step = make_train_step(cfg, opt.AdamWConfig(warmup_steps=1))
    params, state, m = step(params, state, {"tokens": toks, "labels": toks})
    assert np.isfinite(float(m["loss"]))
    assert params["layers"][0]["attn"]["wq"].dtype == torch.bfloat16
    assert params["layers"][0]["attn"]["q_norm"].dtype == torch.float32
    assert all(t.dtype == torch.float32 for t in opt.leaves(state.mu))
    with pytest.raises(NotImplementedError, match="M10"):
        lm_loss(params, cfg, None, toks, embeds=torch.zeros(1))
    with pytest.raises(NotImplementedError, match="M10"):
        lm_loss(params, cfg, toks, toks[..., None])


def test_train_cli_on_cpu(tmp_path):
    ckpt = str(tmp_path / "ck")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "qwen3-1.7b", "--reduced", "--steps", "3", "--batch", "2",
         "--seq", "32", "--ckpt", ckpt, "--save-every", "3", "--device",
         "cpu"], env=dict(os.environ, PYTHONPATH=SRC), capture_output=True,
        text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    losses = [float(x) for x in re.findall(r"^step +\d+ loss (\S+) ",
                                           out.stdout, re.M)]
    assert len(losses) == 2 and all(np.isfinite(losses)), out.stdout
    with open(ckpt + ".json") as f:
        assert json.load(f)["step"] == 3
