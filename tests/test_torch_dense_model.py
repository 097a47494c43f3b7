"""Port vs JAX reference: the dense-layout forwards (``forward_full``
with a cache, ``forward_decode``, ``forward_chunk``) and the int8 paged
forwards, on bridged parameters, compared on logits in float32 at the
reference's own 1e-5 (tests/test_paged.py).

Archs: reduced ``qwen3-1.7b`` (qk-norm), reduced ``qwen2.5-7b``,
reduced ``h2o-danube-1.8b`` with a 24-token window, so the ring wraps
in prefill, decode and chunk, and reduced ``qwen3-1.7b`` with a logit
softcap (the decode paths' einsum branches).  Caches: float and int8.  The dense
decode runs the dense flash-decode kernels' plain versions (the JAX
package's dense decode is an einsum in the model dtype: in float32 the
two agree to ~1e-6).  ``forward_chunk`` runs on float caches only: the
JAX package's dense chunk path has no int8 branch (ROADMAP §3), and the
port's refuses an int8 cache.

int8 caches: torch and XLA round float32 matmuls differently (~1e-7),
so a K/V value within that distance of a rounding tie quantizes one
int8 step apart (a handful per prefill).  The int8 tests assert that
the caches agree within one step, and exactly on all but 0.1% of the
values, then start each step from the JAX cache, so the 1e-5 logit
bound holds the attention math and not the tie noise.  A decode step
quantizes its new token before attending to it, so a tie there can
still move one slot's logits: such a slot (its new row differs) is
held to the reference's own int8 bound, 5% of the logit scale
(tests/test_arch_smoke.py), every other slot to 1e-5.  Dequantization
is float32 on both sides: the port's everywhere; the JAX dense decode
under ``jit`` (XLA keeps the product in float32), and the JAX paged
decode through its Pallas kernel in interpret mode (its jitted
reference route rounds the dequantized pool to bf16, ROADMAP §3)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced
from repro.kernels import ops as jax_ops
from repro.models import init_params
from repro.models import model as jax_model
from repro.models.cache import init_cache as jax_init_cache
from repro.models.cache import init_paged_cache as jax_init_paged_cache
from repro_torch.bridge import from_jax_params
from repro_torch.models.cache import (init_cache, init_paged_cache,
                                      paged_slot_len)
from repro_torch.models.model import (forward_chunk, forward_chunk_paged,
                                      forward_decode, forward_decode_paged,
                                      forward_full, forward_prefill_paged)

torch.set_num_threads(2)
TOL = dict(atol=1e-5, rtol=1e-5)
jax_init = jax.jit(init_params, static_argnums=1)
jax_full = jax.jit(jax_model.forward_full, static_argnames=("cfg",))
jax_decode = jax.jit(jax_model.forward_decode, static_argnames=("cfg",))
jax_chunk = jax.jit(jax_model.forward_chunk, static_argnames=("cfg",))
jax_prefill_paged = jax.jit(jax_model.forward_prefill_paged,
                            static_argnames=("cfg", "slot", "length"))
jax_chunk_paged = jax.jit(jax_model.forward_chunk_paged,
                          static_argnames=("cfg", "slot", "length"))
jax_decode_paged = jax.jit(jax_model.forward_decode_paged,
                           static_argnames=("cfg",))


def _cfg(arch):
    """Reduced ``arch`` in float32; "+softcap" adds a 30.0 attention
    logit softcap (the einsum decode branches)."""
    arch, _, softcap = arch.partition("+")
    cfg = dataclasses.replace(get_reduced(arch), dtype="float32")
    if cfg.sliding_window:
        cfg = dataclasses.replace(cfg, sliding_window=24)
    if softcap:
        cfg = dataclasses.replace(cfg, attn_logit_softcap=30.0)
    return cfg


def _params(cfg):
    jp = jax_init(jax.random.PRNGKey(0), cfg)
    return jp, from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


def _sync_int8(tc, jc):
    """Assert the port's int8 cache is the JAX one up to tie noise, then
    copy the JAX cache into the port."""
    flips = total = 0
    for gl, wl in zip(tc["layers"], jc["layers"]):
        for name, w in wl.items():
            w = np.array(w)
            if name.endswith("scale"):
                w = w.astype(np.float32)
                np.testing.assert_allclose(gl[name].float().numpy(), w,
                                           rtol=2 ** -7, atol=0)
            else:
                d = np.abs(gl[name].numpy().astype(np.int32) - w)
                assert d.max() <= 1
                flips += int((d > 0).sum())
                total += d.size
            gl[name].copy_(torch.from_numpy(w))
    assert flips <= 1e-3 * total, (flips, total)


def _close_int8_step(tl, jl, tc, jc, slot_rows):
    """Compare one int8 decode step's logits per slot: 1e-5 unless the
    step's new quantized token of that slot differs between the two
    caches (a rounding tie), then the reference's int8 bound.
    ``slot_rows(buf)`` maps a cache buffer's per-row difference mask to
    [B] bools (dense: row b; paged: the slot's pages)."""
    got, want = tl.detach().numpy(), np.asarray(jl)
    tied = np.zeros(got.shape[0], bool)
    for gl, wl in zip(tc["layers"], jc["layers"]):
        for name in ("k", "v"):
            tied |= slot_rows(gl[name].numpy() != np.asarray(wl[name]))
    for b in range(got.shape[0]):
        if tied[b]:
            scale = max(float(np.abs(want[b]).max()), 1.0)
            assert float(np.abs(got[b] - want[b]).max()) < 0.05 * scale
        else:
            np.testing.assert_allclose(got[b], want[b], **TOL)
    assert tied.sum() <= 1, tied


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("arch", ["qwen3-1.7b", "qwen2.5-7b",
                                  "h2o-danube-1.8b", "qwen3-1.7b+softcap"])
def test_dense_forwards_match_jax(arch, quantized):
    """forward_full writes a 28-token prompt into a 32-slot ring (24 for
    the windowed arch: it wraps), then decode steps (wrapping the
    window ring), then — float caches — a 6-token chunk across the
    32-slot ring's end and one more decode step."""
    cfg = _cfg(arch)
    jp, tp = _params(cfg)
    B, msl, S = 2, 32, 28
    rng = np.random.default_rng(0)
    jc = jax_init_cache(cfg, B, msl, quantized=quantized)
    tc = init_cache(cfg, B, msl, quantized=quantized, device="cpu")
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    jl, jc, _ = jax_full(jp, cfg, tokens=jnp.asarray(toks), cache=jc)
    tl, tc, _ = forward_full(tp, cfg, tokens=torch.from_numpy(toks),
                             cache=tc)
    _close(tl, jl)
    assert tc["pos"].tolist() == np.asarray(jc["pos"]).tolist() == [S, S]
    nxt = np.asarray(jnp.argmax(jl[:, -1], -1))[:, None].astype(np.int32)
    for _ in range(3):
        if quantized:
            _sync_int8(tc, jc)
        jl, jc = jax_decode(jp, cfg, tokens=jnp.asarray(nxt), cache=jc)
        tl, tc = forward_decode(tp, cfg, tokens=torch.from_numpy(nxt),
                                cache=tc)
        if quantized:
            _close_int8_step(tl, jl, tc, jc,
                             lambda d: d.reshape(d.shape[0], -1).any(1))
        else:
            _close(tl, jl)
        nxt = np.asarray(jnp.argmax(jl[:, -1], -1))[:, None].astype(np.int32)
    if quantized:
        _sync_int8(tc, jc)
        with pytest.raises(NotImplementedError):
            forward_chunk(tp, cfg, tokens=torch.from_numpy(toks[:, :6]),
                          cache=tc)
        return
    for gl, wl in zip(tc["layers"], jc["layers"]):
        for name in ("k", "v"):
            _close(gl[name], wl[name])
    chunk = rng.integers(0, cfg.vocab_size, (B, 6)).astype(np.int32)
    jl, jc = jax_chunk(jp, cfg, tokens=jnp.asarray(chunk), cache=jc)
    tl, tc = forward_chunk(tp, cfg, tokens=torch.from_numpy(chunk), cache=tc)
    _close(tl, jl)
    assert tc["pos"].tolist() == np.asarray(jc["pos"]).tolist()
    nxt = np.asarray(jnp.argmax(jl[:, -1], -1))[:, None].astype(np.int32)
    jl, jc = jax_decode(jp, cfg, tokens=jnp.asarray(nxt), cache=jc)
    tl, tc = forward_decode(tp, cfg, tokens=torch.from_numpy(nxt), cache=tc)
    _close(tl, jl)


def test_forward_full_last_only_matches_jax():
    cfg = _cfg("qwen3-1.7b")
    jp, tp = _params(cfg)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 20))
    jl, _, _ = jax_full(jp, cfg, tokens=jnp.asarray(toks, jnp.int32))
    tl, cache, aux = forward_full(tp, cfg, tokens=torch.from_numpy(toks),
                                  last_only=True)
    assert cache is None and aux == 0.0 and tl.shape == (2, 1,
                                                         cfg.vocab_size)
    _close(tl, np.asarray(jl)[:, -1:])


@pytest.fixture
def pallas_interpret():
    """Route the JAX package's kernel calls through the Pallas kernels in
    interpret mode for one test."""
    jax_ops.set_kernel_mode("interpret")
    try:
        yield
    finally:
        jax_ops.set_kernel_mode("auto")


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "h2o-danube-1.8b",
                                  "qwen3-1.7b+softcap"])
def test_int8_paged_forwards_match_jax(arch, pallas_interpret):
    """int8 pages: whole-prompt prefill of mixed lengths through a padded
    bucket, a chunk continuation (dequantized prefix gather), then decode
    steps on the q8 paged kernel's plain version — logits at 1e-5 against
    the JAX paged forwards on the same int8 pool (the mirror of
    tests/test_paged.py::test_paged_decode_matches_dense_logits
    [quantized])."""
    cfg = _cfg(arch)
    jp, tp = _params(cfg)
    B, msl, P = 3, 128, 16
    npg = paged_slot_len(cfg, msl, P) // P
    bt = np.arange(1, 1 + B * npg, dtype=np.int32).reshape(B, npg)
    jc = jax_init_paged_cache(cfg, B, msl, 1 + B * npg, P, quantized=True)
    jc["block_tables"] = jnp.asarray(bt)
    tc = init_paged_cache(cfg, B, msl, 1 + B * npg, P, quantized=True,
                          device="cpu")
    tc["block_tables"] = torch.from_numpy(bt)
    rng = np.random.default_rng(0)
    for slot, n in enumerate([9, 24, 57]):
        pad = max(16, 1 << (n - 1).bit_length())
        toks = np.zeros((1, pad), np.int32)
        toks[0, :n] = rng.integers(0, cfg.vocab_size, n)
        jl, jc = jax_prefill_paged(jp, cfg, tokens=jnp.asarray(toks),
                                   cache=jc, slot=slot, length=n)
        tl, tc = forward_prefill_paged(tp, cfg, tokens=torch.from_numpy(toks),
                                       cache=tc, slot=slot, length=n)
        _close(tl, jl)
    toks = np.zeros((1, 16), np.int32)
    toks[0, :10] = rng.integers(0, cfg.vocab_size, 10)
    _sync_int8(tc, jc)
    jl, jc = jax_chunk_paged(jp, cfg, tokens=jnp.asarray(toks), cache=jc,
                             slot=1, length=10)
    tl, tc = forward_chunk_paged(tp, cfg, tokens=torch.from_numpy(toks),
                                 cache=tc, slot=1, length=10)
    _close(tl, jl)
    nxt = rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
    for _ in range(3):
        _sync_int8(tc, jc)
        jl, jc = jax_decode_paged(jp, cfg, tokens=jnp.asarray(nxt), cache=jc)
        tl, tc = forward_decode_paged(tp, cfg, tokens=torch.from_numpy(nxt),
                                      cache=tc)
        _close_int8_step(tl, jl, tc, jc, lambda d: d.reshape(
            d.shape[0], -1).any(1)[bt].any(1))
        nxt = np.asarray(jnp.argmax(jl[:, -1], -1))[:, None].astype(np.int32)
