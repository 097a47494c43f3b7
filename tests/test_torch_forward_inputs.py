"""The forwards' other inputs against the JAX package, on bridged
parameters in float32 at the reference's own 1e-5 (tests/test_paged.py):
a VLM's ``embeds`` with M-RoPE ``positions`` that differ per component
(a text run, then a temporal x height x width grid of patches) through
every forward that takes them (reduced ``qwen2-vl-7b``), and a
K-codebook model's ``[B, S, K]`` tokens and ``[.., K, V]`` logits
(reduced ``musicgen-medium``, four codebooks, untied and tied heads).
A bf16 model fed float32 ``embeds`` promotes as JAX does: the residual
and the logits come out float32 on both sides.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced
from repro.models import init_params
from repro.models import layers as jax_layers
from repro.models import model as jax_model
from repro.models.cache import init_cache as jax_init_cache
from repro.models.cache import init_paged_cache as jax_init_paged_cache
from repro_torch.bridge import from_jax_params
from repro_torch.models import layers
from repro_torch.models import model as torch_model
from repro_torch.models.cache import (init_cache, init_paged_cache,
                                      paged_slot_len)

torch.set_num_threads(2)
TOL = dict(atol=1e-5, rtol=1e-5)
B, S, MSL, P = 2, 32, 64, 16
jax_init = jax.jit(init_params, static_argnums=1)
jax_full = jax.jit(jax_model.forward_full,
                   static_argnames=("cfg", "remat", "last_only"))
jax_decode = jax.jit(jax_model.forward_decode, static_argnames=("cfg",))
jax_chunk = jax.jit(jax_model.forward_chunk, static_argnames=("cfg",))
jax_prefill_paged = jax.jit(jax_model.forward_prefill_paged,
                            static_argnames=("cfg", "slot", "length"))
jax_chunk_paged = jax.jit(jax_model.forward_chunk_paged,
                          static_argnames=("cfg", "slot", "length"))
jax_decode_paged = jax.jit(jax_model.forward_decode_paged,
                           static_argnames=("cfg",))


def _cfg(arch, dtype="float32", **kw):
    return dataclasses.replace(get_reduced(arch), dtype=dtype, **kw)


def _params(cfg):
    jp = jax_init(jax.random.PRNGKey(0), cfg)
    return jp, from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")


def _close(got, want):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), **TOL)


def mrope_positions(b, s, offset=0, text=8, grid=(2, 3, 4)):
    """[b, s, 3] M-RoPE ids: ``text`` text tokens (t = h = w = i), then a
    t x h x w patch grid starting after them (t, h, w = start + the
    patch's grid index), then text again from past the grid's largest
    id; ``offset`` shifts every id.  Rows differ: row r adds r."""
    ids = [(i, i, i) for i in range(text)]
    gt, gh, gw = grid
    ids += [(text + t, text + h, text + w) for t in range(gt)
            for h in range(gh) for w in range(gw)]
    nxt = text + max(grid)
    while len(ids) < s:
        ids.append((nxt, nxt, nxt))
        nxt += 1
    pos = np.asarray(ids[:s], np.int32)[None] + offset
    return np.stack([pos[0] + r for r in range(b)]).astype(np.int32)


def test_rope_cos_sin_mrope_grid_matches_jax():
    cfg = get_reduced("qwen2-vl-7b")
    pos = mrope_positions(B, S, offset=5)
    assert not (pos[..., 0] == pos[..., 1]).all()       # not a broadcast
    for theta, hd, sections in ((cfg.rope_theta, cfg.head_dim,
                                 cfg.mrope_sections),
                                (1e6, 128, (16, 24, 24))):
        jc, js = jax_layers.rope_cos_sin(jnp.asarray(pos), hd, theta,
                                         sections)
        tc, ts = layers.rope_cos_sin(torch.from_numpy(pos), hd, theta,
                                     sections)
        _close(tc, jc)
        _close(ts, js)


def _embeds(rng, cfg, s):
    return rng.normal(0, 1, (B, s, cfg.d_model)).astype(np.float32)


def test_vlm_embeds_and_mrope_dense_forwards_match_jax():
    """forward_full (writing a dense cache), forward_decode and
    forward_chunk on embeds, the first two with grid positions."""
    cfg = _cfg("qwen2-vl-7b")
    jp, tp = _params(cfg)
    rng = np.random.default_rng(0)
    emb = _embeds(rng, cfg, S)
    pos = mrope_positions(B, S)
    jl, _, _ = jax_full(jp, cfg, embeds=jnp.asarray(emb),
                        positions=jnp.asarray(pos))
    tl, _, _ = torch_model.forward_full(tp, cfg, embeds=torch.from_numpy(emb),
                                        positions=torch.from_numpy(pos))
    _close(tl, jl)
    # prefill 24 rows into a dense cache, then two decode steps on embeds
    # at the grid's next ids, then an 8-row chunk on embeds
    jc, tc = jax_init_cache(cfg, B, MSL), init_cache(cfg, B, MSL,
                                                     device="cpu")
    jl, jc, _ = jax_full(jp, cfg, embeds=jnp.asarray(emb[:, :24]),
                         positions=jnp.asarray(pos[:, :24]), cache=jc)
    tl, tc, _ = torch_model.forward_full(
        tp, cfg, embeds=torch.from_numpy(emb[:, :24]),
        positions=torch.from_numpy(pos[:, :24]), cache=tc)
    _close(tl, jl)
    for step in range(2):
        e = _embeds(rng, cfg, 1)
        p = pos[:, 24 + step:25 + step]
        jl, jc = jax_decode(jp, cfg, embeds=jnp.asarray(e),
                            positions=jnp.asarray(p), cache=jc)
        tl, tc = torch_model.forward_decode(
            tp, cfg, embeds=torch.from_numpy(e), positions=torch.from_numpy(p),
            cache=tc)
        _close(tl, jl)
    e = _embeds(rng, cfg, 8)
    jl, jc = jax_chunk(jp, cfg, embeds=jnp.asarray(e), cache=jc)
    tl, tc = torch_model.forward_chunk(tp, cfg, embeds=torch.from_numpy(e),
                                       cache=tc)
    _close(tl, jl)
    for jl_, tl_ in zip(jc["layers"], tc["layers"]):
        for name in ("k", "v"):
            _close(tl_[name], jl_[name])


def test_vlm_embeds_and_mrope_paged_forwards_match_jax():
    """forward_prefill_paged with embeds and grid positions per slot,
    forward_chunk_paged and forward_decode_paged on embeds."""
    cfg = _cfg("qwen2-vl-7b")
    jp, tp = _params(cfg)
    npg = paged_slot_len(cfg, MSL, P) // P
    bt = np.arange(1, 1 + B * npg, dtype=np.int32).reshape(B, npg)
    jc = jax_init_paged_cache(cfg, B, MSL, 1 + B * npg, P)
    jc["block_tables"] = jnp.asarray(bt)
    tc = init_paged_cache(cfg, B, MSL, 1 + B * npg, P, device="cpu")
    tc["block_tables"] = torch.from_numpy(bt)
    rng = np.random.default_rng(1)
    pos = mrope_positions(1, S)
    for slot, n in ((0, 29), (1, 32)):
        e = rng.normal(0, 1, (1, 32, cfg.d_model)).astype(np.float32)
        jl, jc = jax_prefill_paged(jp, cfg, embeds=jnp.asarray(e),
                                   positions=jnp.asarray(pos), cache=jc,
                                   slot=slot, length=n)
        tl, tc = torch_model.forward_prefill_paged(
            tp, cfg, embeds=torch.from_numpy(e),
            positions=torch.from_numpy(pos), cache=tc, slot=slot, length=n)
        _close(tl, jl)
    e = rng.normal(0, 1, (1, 16, cfg.d_model)).astype(np.float32)
    jl, jc = jax_chunk_paged(jp, cfg, embeds=jnp.asarray(e), cache=jc,
                             slot=0, length=10)
    tl, tc = torch_model.forward_chunk_paged(
        tp, cfg, embeds=torch.from_numpy(e), cache=tc, slot=0, length=10)
    _close(tl, jl)
    e = _embeds(rng, cfg, 1)
    p = np.stack([mrope_positions(1, 40)[0, 39:40],
                  mrope_positions(1, 33)[0, 32:33]]).astype(np.int32)
    jl, jc = jax_decode_paged(jp, cfg, embeds=jnp.asarray(e),
                              positions=jnp.asarray(p), cache=jc)
    tl, tc = torch_model.forward_decode_paged(
        tp, cfg, embeds=torch.from_numpy(e), positions=torch.from_numpy(p),
        cache=tc)
    _close(tl, jl)


def test_bf16_model_on_float32_embeds_promotes_as_jax():
    """A bf16 model fed float32 embeds (the JAX launcher's VLM batch):
    each block's output, the residual, and the logits are float32 on
    both sides, and agree (every product runs in float32 on bf16 values
    widened exactly)."""
    cfg = _cfg("qwen2-vl-7b", dtype="bfloat16")
    jp, tp = _params(cfg)
    assert tp["layers"][0]["attn"]["wq"].dtype == torch.bfloat16
    emb = _embeds(np.random.default_rng(2), cfg, S)
    pos = mrope_positions(B, S)
    jpos = jnp.asarray(pos)
    jx, _, _ = jax.jit(jax_model._attn_block_full, static_argnums=1)(
        jp["layers"][0], cfg, jnp.asarray(emb), jpos, None)
    tx, _, _ = torch_model._attn_block_full(
        tp["layers"][0], cfg, torch.from_numpy(emb), torch.from_numpy(pos))
    assert jx.dtype == jnp.float32 and tx.dtype == torch.float32
    _close(tx, jx)
    jl, _, _ = jax_full(jp, cfg, embeds=jnp.asarray(emb), positions=jpos)
    tl, _, _ = torch_model.forward_full(tp, cfg, embeds=torch.from_numpy(emb),
                                        positions=torch.from_numpy(pos))
    assert jl.dtype == jnp.float32 and tl.dtype == torch.float32
    _close(tl, jl)
    # token ids keep the model's dtype
    toks = np.zeros((B, 4), np.int32)
    tl, _, _ = torch_model.forward_full(tp, cfg,
                                        tokens=torch.from_numpy(toks))
    assert tl.dtype == torch.bfloat16


@pytest.mark.parametrize("tie", [False, True])
def test_codebook_forwards_match_jax(tie):
    """[B, S, 4] tokens: the parameter tree (embed [4, V, d], lm_head [4,
    d, V]), forward_full logits [B, S, 4, V], then a dense cache's
    prefill and two decode steps on [B, 1, 4] tokens."""
    cfg = _cfg("musicgen-medium", tie_embeddings=tie)
    jp, tp = _params(cfg)
    assert cfg.num_codebooks == 4
    assert tuple(tp["embed"].shape) == (4, cfg.vocab_size, cfg.d_model)
    assert ("lm_head" in tp) == (not tie)
    if not tie:
        assert tuple(tp["lm_head"].shape) == (4, cfg.d_model, cfg.vocab_size)
    mine = torch_model.init_params(cfg, seed=0, device="cpu")
    heads = ("embed", "lm_head")
    assert {k: tuple(v.shape) for k, v in mine.items() if k in heads} \
        == {k: tuple(v.shape) for k, v in tp.items() if k in heads}
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab_size, (B, S, 4)).astype(np.int32)
    jl, _, _ = jax_full(jp, cfg, tokens=jnp.asarray(toks))
    tl, _, _ = torch_model.forward_full(tp, cfg,
                                        tokens=torch.from_numpy(toks))
    assert tuple(tl.shape) == (B, S, 4, cfg.vocab_size)
    _close(tl, jl)
    jc, tc = jax_init_cache(cfg, B, MSL), init_cache(cfg, B, MSL,
                                                     device="cpu")
    jl, jc, _ = jax_full(jp, cfg, tokens=jnp.asarray(toks[:, :20]), cache=jc,
                         last_only=True)
    tl, tc, _ = torch_model.forward_full(
        tp, cfg, tokens=torch.from_numpy(toks[:, :20]), cache=tc,
        last_only=True)
    _close(tl, jl)
    for _ in range(2):
        nxt = np.asarray(jnp.argmax(jl[:, -1], -1))[:, None].astype(np.int32)
        jl, jc = jax_decode(jp, cfg, tokens=jnp.asarray(nxt), cache=jc)
        tl, tc = torch_model.forward_decode(tp, cfg,
                                            tokens=torch.from_numpy(nxt),
                                            cache=tc)
        assert tuple(tl.shape) == (B, 1, 4, cfg.vocab_size)
        _close(tl, jl)
