"""Checkpoints: the port's save/restore round trip (params, AdamW state,
step, manifest) is bit-exact in float32 and bfloat16, and the file layout
is the JAX package's: a float32 checkpoint written by either package is
restored bit for bit by the other.  A bfloat16 checkpoint written by the
JAX package (raw 2-byte words on disk) is restored by the port too."""
import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_reduced
from repro.models import init_params as jax_init_params
from repro.train import optimizer as jax_opt
from repro.train.checkpoint import restore as jax_restore
from repro.train.checkpoint import save as jax_save
from repro_torch.bridge import from_jax_opt_state, from_jax_params
from repro_torch.models.model import init_params
from repro_torch.train import optimizer as opt
from repro_torch.train.checkpoint import restore, save

CFG = get_reduced("qwen3-1.7b", num_layers=1, d_model=128, vocab_size=64)
CFG32 = dataclasses.replace(CFG, dtype="float32")


def _state(params, seed):
    """An AdamW state with nonzero moments and step."""
    g = torch.Generator().manual_seed(seed)
    return opt.AdamWState(
        step=torch.tensor(7, dtype=torch.int32),
        mu=opt.tree_map(lambda p: torch.randn(p.shape, generator=g), params),
        nu=opt.tree_map(lambda p: torch.rand(p.shape, generator=g), params))


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


def _same(a, b):
    for x, y in _pairs(a, b):
        assert x.dtype == y.dtype and torch.equal(x, y)


def _same_np(torch_tree, jax_tree):
    for x, y in _pairs(torch_tree, jax.tree.map(np.asarray, jax_tree)):
        assert x.shape == y.shape
        np.testing.assert_array_equal(x.numpy(), y)


@pytest.mark.parametrize("cfg", [CFG32, CFG], ids=["float32", "bfloat16"])
def test_roundtrip_bit_exact(tmp_path, cfg):
    params = init_params(cfg, seed=0, device="cpu")
    state = _state(params, 1)
    path = os.path.join(tmp_path, "ckpt")
    save(path, params, state, step=12, meta={"arch": cfg.name})
    with open(path + ".json") as f:
        assert json.load(f) == {"step": 12, "meta": {"arch": cfg.name},
                                "has_opt": True}
    if cfg.dtype == "bfloat16":
        with np.load(path + ".npz") as z:
            assert z["params//embed"].dtype == np.dtype("V2")
    template = init_params(cfg, seed=5, device="cpu")    # other values
    p2, s2, step = restore(path, template, opt.init(template))
    assert step == 12
    _same(params, p2)
    _same(state.mu, s2.mu)
    _same(state.nu, s2.nu)
    assert s2.step.dtype == torch.int32 and int(s2.step) == 7
    # params only: no optimizer state comes back
    save(path + "p.npz", params)
    p3, s3, step = restore(path + "p.npz", template, opt.init(template))
    assert s3 is None and step == 0
    _same(params, p3)


def test_jax_checkpoint_restores_into_the_port(tmp_path):
    jp = jax_init_params(jax.random.PRNGKey(0), CFG32)
    js = jax_opt.init(jp)
    js = js._replace(step=js.step + 3,
                     mu=jax.tree.map(lambda x: x + 0.5, jp),
                     nu=jax.tree.map(lambda x: x * x, jp))
    path = os.path.join(tmp_path, "jax.npz")
    jax_save(path, jp, js, step=3, meta={"arch": CFG32.name})
    template = init_params(CFG32, seed=1, device="cpu")
    p, s, step = restore(path, template, opt.init(template))
    assert step == 3 and int(s.step) == 3
    _same_np(p, jp)
    _same_np(s.mu, js.mu)
    _same_np(s.nu, js.nu)


def test_jax_bf16_checkpoint_restores_into_the_port(tmp_path):
    jp = jax_init_params(jax.random.PRNGKey(0), CFG)      # bfloat16 leaves
    path = os.path.join(tmp_path, "jax16.npz")
    jax_save(path, jp)
    p, _, _ = restore(path, init_params(CFG, seed=1, device="cpu"))
    want = from_jax_params(jax.tree.map(np.asarray, jp), "cpu")
    _same(p, want)


def test_port_checkpoint_restores_into_jax(tmp_path):
    params = init_params(CFG32, seed=2, device="cpu")
    state = _state(params, 3)
    path = os.path.join(tmp_path, "port")
    save(path, params, state, step=9)
    jt = jax_init_params(jax.random.PRNGKey(4), CFG32)
    jp, js, step = jax_restore(path, jt, jax_opt.init(jt))
    assert step == 9 and int(js.step) == 7
    _same_np(params, jp)
    _same_np(state.mu, js.mu)
    _same_np(state.nu, js.nu)
    # and back through the bridge, as the training tests start
    back = from_jax_opt_state(jax.tree.map(np.asarray, js), "cpu")
    _same(state.mu, back.mu)
    assert back.step.dtype == torch.int32
