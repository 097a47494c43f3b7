"""Each layer primitive of the port against its JAX twin on the same
numpy inputs, in float32 (atol = rtol = 1e-6)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jl
from repro.models.config import ModelConfig
from repro_torch.models import layers as tl

torch.set_num_threads(2)
CFG = ModelConfig(name="t", family="dense", num_layers=1, d_model=64,
                  num_heads=4, num_kv_heads=2, d_ff=96, vocab_size=32,
                  dtype="float32")


def _inputs():
    rng = np.random.default_rng(0)
    f = lambda *s, scale=1.0: (rng.standard_normal(s) * scale).astype(
        np.float32)
    return {
        "x": f(2, 5, 64), "w": f(64) + 1.0, "b": f(64),
        "qk": f(2, 7, 4, 64),
        "pos": rng.integers(0, 300, (2, 7)).astype(np.int32),
        "pos3": rng.integers(0, 300, (2, 7, 3)).astype(np.int32),
        "w_gate": f(64, 96, scale=64 ** -0.5),
        "w_up": f(64, 96, scale=64 ** -0.5),
        "w_down": f(96, 64, scale=96 ** -0.5),
    }


def _both(fn_name, args, **kw):
    """The same function of both packages on the same numpy inputs."""
    want = getattr(jl, fn_name)(*[jnp.asarray(a) if isinstance(a, np.ndarray)
                                  else a for a in args], **kw)
    got = getattr(tl, fn_name)(*[torch.from_numpy(a)
                                 if isinstance(a, np.ndarray) else a
                                 for a in args], **kw)
    return got, want


def _mlp_params(i, names):
    return {n: i[n] for n in names}


CASES = {
    "rmsnorm": lambda i: _both("rmsnorm", (i["x"], i["w"], 1e-6)),
    "layernorm": lambda i: _both("layernorm", (i["x"], i["w"], i["b"])),
    "rope_freqs-64": lambda i: _both("rope_freqs", (64, 1e4)),
    "rope_freqs-128": lambda i: _both("rope_freqs", (128, 1e6)),
    "rope_cos_sin": lambda i: _both("rope_cos_sin", (i["pos"], 64, 1e4)),
    "rope_cos_sin-mrope": lambda i: _both(
        "rope_cos_sin", (i["pos3"], 64, 1e6), mrope_sections=(16, 8, 8)),
    "apply_rope": lambda i: _both("apply_rope", (
        i["qk"], *(np.array(a) for a in jl.rope_cos_sin(
            jnp.asarray(i["pos"]), 64, 1e4)))),
    "swiglu": lambda i: _both("swiglu", (i["x"], i["w_gate"], i["w_up"],
                                         i["w_down"])),
    "gelu_mlp": lambda i: _both("gelu_mlp", (i["x"], i["w_up"],
                                             i["w_down"])),
}


def _pairwise(got, want):
    if isinstance(want, tuple):
        for g, w in zip(got, want):
            _pairwise(g, w)
        return
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=1e-6)


@pytest.mark.parametrize("case", sorted(CASES))
def test_layer_matches_jax(case):
    got, want = CASES[case](_inputs())
    _pairwise(got, want)


@pytest.mark.parametrize("norm_type,mlp_type", [("rmsnorm", "swiglu"),
                                                ("layernorm", "gelu")])
def test_apply_norm_and_mlp_match_jax(norm_type, mlp_type):
    cfg = dataclasses.replace(CFG, norm_type=norm_type, mlp_type=mlp_type)
    i = _inputs()
    norm = {"scale": i["w"], "bias": i["b"]}
    mlp = _mlp_params(i, ("w_gate", "w_up", "w_down") if mlp_type == "swiglu"
                      else ("w_up", "w_down"))
    to_j = lambda d: {k: jnp.asarray(v) for k, v in d.items()}
    to_t = lambda d: {k: torch.from_numpy(v) for k, v in d.items()}
    want = jl.apply_mlp(jl.apply_norm(jnp.asarray(i["x"]), to_j(norm), cfg),
                        to_j(mlp), cfg)
    got = tl.apply_mlp(tl.apply_norm(torch.from_numpy(i["x"]), to_t(norm),
                                     cfg), to_t(mlp), cfg)
    _pairwise(got, want)
