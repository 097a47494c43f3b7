"""Port vs JAX reference: the dense paged forward passes on bridged
parameters, compared on logits (and on the written pages) in float32.

Covers whole-prompt prefill through a padded bucket (the port serves it
with the flash-attention plain version), a chunk continuation from a
nonzero ``pos`` with a padded bucket, and decode steps, on reduced
``qwen3-1.7b`` (qk-norm), ``qwen2.5-7b``, ``starcoder2-3b`` (layernorm,
gelu), ``phi4-mini-3.8b`` and ``qwen2-vl-7b`` on text (M-RoPE from the
default positions).  Bound: the reference's own 1e-5
(tests/test_paged.py)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced
from repro.models import init_params
from repro.models import model as jax_model
from repro.models.cache import init_paged_cache as jax_init_paged_cache
from repro_torch.bridge import from_jax_params
from repro_torch.models.cache import init_paged_cache, paged_slot_len
from repro_torch.models.model import (forward_chunk_paged,
                                      forward_decode_paged,
                                      forward_prefill_paged)

torch.set_num_threads(2)
TOL = dict(atol=1e-5, rtol=1e-5)
B, MSL, P = 2, 128, 16
# jitted reference functions: eager JAX compiles every op on first use
jax_init = jax.jit(init_params, static_argnums=1)
jax_prefill = jax.jit(jax_model.forward_prefill_paged,
                      static_argnames=("cfg", "slot", "length"))
jax_chunk = jax.jit(jax_model.forward_chunk_paged,
                    static_argnames=("cfg", "slot", "length"))
jax_decode = jax.jit(jax_model.forward_decode_paged,
                     static_argnames=("cfg",))


def _cfg(arch):
    return dataclasses.replace(get_reduced(arch), dtype="float32")


def _caches(cfg):
    npg = paged_slot_len(cfg, MSL, P) // P
    bt = np.arange(1, 1 + B * npg, dtype=np.int32).reshape(B, npg)
    jc = jax_init_paged_cache(cfg, B, MSL, 1 + B * npg, P)
    jc["block_tables"] = jnp.asarray(bt)
    tc = init_paged_cache(cfg, B, MSL, 1 + B * npg, P, device="cpu")
    tc["block_tables"] = torch.from_numpy(bt)
    return jc, tc


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "qwen2.5-7b", "starcoder2-3b",
                                  "phi4-mini-3.8b", "qwen2-vl-7b"])
def test_paged_forward_matches_jax(arch):
    cfg = _cfg(arch)
    jp = jax_init(jax.random.PRNGKey(0), cfg)
    tp = from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    jc, tc = _caches(cfg)
    rng = np.random.default_rng(0)
    # slot 0: 37 tokens padded to the 64 bucket; slot 1: exactly 16
    for slot, n, pad in ((0, 37, 64), (1, 16, 16)):
        toks = np.zeros((1, pad), np.int32)
        toks[0, :n] = rng.integers(0, cfg.vocab_size, n)
        jl, jc = jax_prefill(jp, cfg, tokens=jnp.asarray(toks), cache=jc,
                             slot=slot, length=n)
        tl, tc = forward_prefill_paged(tp, cfg, tokens=torch.from_numpy(toks),
                                       cache=tc, slot=slot, length=n)
        _close(tl, jl)
    # chunk continuation of slot 0 from pos 37: 10 valid rows in a 16 bucket
    toks = np.zeros((1, 16), np.int32)
    toks[0, :10] = rng.integers(0, cfg.vocab_size, 10)
    jl, jc = jax_chunk(jp, cfg, tokens=jnp.asarray(toks), cache=jc, slot=0,
                       length=10)
    tl, tc = forward_chunk_paged(tp, cfg, tokens=torch.from_numpy(toks),
                                 cache=tc, slot=0, length=10)
    _close(tl, jl)
    assert tc["pos"].tolist() == np.asarray(jc["pos"]).tolist() == [47, 16]
    nxt = rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
    for _ in range(3):
        jl, jc = jax_decode(jp, cfg, tokens=jnp.asarray(nxt), cache=jc)
        tl, tc = forward_decode_paged(tp, cfg, tokens=torch.from_numpy(nxt),
                                      cache=tc)
        _close(tl, jl)
        nxt = np.asarray(jnp.argmax(jl[:, -1], -1))[:, None].astype(np.int32)
    for jl_, tl_ in zip(jc["layers"], tc["layers"]):
        for name in ("k", "v"):
            _close(tl_[name], jl_[name])
