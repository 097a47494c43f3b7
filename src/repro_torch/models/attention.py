"""Attention on the dense and paged KV caches (counterpart of
``src/repro/models/attention.py``): GQA and MLA.

GQA execution paths:
  * ``gqa_full`` — whole-sequence prefill or training with a causal
    (optionally sliding-window) mask; the flash-attention kernel serves
    every sequence of at least 16 tokens without a logit softcap (its
    ragged last tile is masked, so no length is padded for it; under
    grad, the differentiable training kernels), the einsum path
    otherwise;
  * ``gqa_continue`` / ``gqa_continue_paged`` — a chunk (or prefix-hit
    suffix) attending to the slot's dense ring or gathered pages plus
    itself;
  * ``gqa_decode`` / ``gqa_decode_paged`` — one new token per slot, on
    the dense or paged flash-decode kernel (float or int8 caches;
    softcap archs take the einsum form).

Every projection promotes as ``jnp.dot`` does (``layers.dot``): float32
activations (a VLM's float32 ``embeds``) through bf16 weights run in
float32, attention inputs included.

int8 caches (``k_scale`` in the layer dict) store each new token
quantized per (token, kv head) and dequantize inside attention.  Kernel
calls go through :mod:`repro_torch.kernels.ops`, which picks the CUDA
kernel or its plain version by the tensors' device.

Under ``attn_sharding="auto"`` (``layers.seq_parallel``: a tp axis that
divides the sequence) ``gqa_full`` is sequence-parallel, as the
reference's is: each rank projects its ``s/tp`` rows of the sequence
with every head (the GQA weights whole on every rank,
``sharding.placement_specs``, entering the rows through ``tp_enter``),
gathers k and v over tp (the only gathers of the attention) and attends
its rows at ``q_offset = rank * s/tp`` through ``ops.flash_attention``
(K2, or K5a-c under grad, with that offset; a softcap arch through the
einsum path with the offset mask).  It returns its rows of the output,
and the whole sequence's k and v.  ``mla_full``, which the reference
keeps off the sequence path, gathers the rows and hands back its rows
of the output.

Under a mesh (``ctx``, a ``ShardingCtx``) the paged paths and ``gqa_full``
work on this rank's heads: where both the q and the kv heads divide the
tp axis, ``nh/tp`` q heads over ``kv/tp`` kv heads (the contiguous
column shards of ``wq``/``wk``/``wv`` make rank r's q heads the groups of
its kv heads, checked in :func:`_local_heads`), so the kernels see whole
kv heads of the rank's pages and run unchanged, and the row-parallel
``wo`` product is summed over the ranks; elsewhere the rank holds every
head and the block runs replicated (``sharding.placement_specs``).  In
training (``gqa_full``, ``mla_full``) the block's input (and the
qk-norm scales, whole on every rank) enters the rank's heads through
``layers.tp_enter``, whose backward sums the ranks' gradients of it.

MLA (multi-head latent attention, DeepSeek-V2) follows the JAX package's
arithmetic in plain PyTorch, as the JAX package runs it in jnp with no
Pallas kernel: ``mla_full`` expands the latent and attends over q·k of
width nope + rope (192 at the published width, which the flash kernel
does not take); ``mla_decode`` / ``mla_decode_paged`` attend in the
latent space with ``w_uk`` absorbed into q, in float32 over the dense
ring or the gathered live pages.  Under a mesh every rank projects and
writes the same whole latent (``w_dkv``, ``w_krope`` and the latent
pages are whole on every rank), and computes ``nh/tp`` heads where the
heads divide the tp axis (:func:`_mla_heads`): its columns of ``wq``,
``w_uk`` and ``w_uv`` and its rows of ``wo``, summed over the ranks;
elsewhere the block runs replicated.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.models.cache import (dequantize_kv, gather_pages,
                                      paged_prefill_write, paged_token_write,
                                      quantize_kv)
from repro_torch.models.layers import (apply_rope, dot, heads_split, normal,
                                       rmsnorm, rope_cos_sin, seq_gather,
                                       seq_parallel, seq_rows,
                                       tp_all_gather, tp_all_reduce,
                                       tp_enter, tp_enter_tree, tp_rank,
                                       tp_size)

NEG_INF = -1e30


def _use_attn_kernel(cfg, s: int) -> bool:
    """The flash kernel (K2, or K5 under grad) serves every sequence of at
    least 16 tokens: its ragged last tile is masked, so the exact-length
    prompts of SSM and hybrid archs take it too (the Pallas kernel needs
    whole 16-row tiles, so the JAX package routes those to jnp)."""
    if cfg.attn_logit_softcap:
        return False
    return s >= 16


def init_gqa(cfg, dtype: torch.dtype, device: torch.device,
             generator: torch.Generator):
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    s = d ** -0.5
    p = {
        "wq": normal((d, h * hd), s, dtype, device, generator),
        "wk": normal((d, kv * hd), s, dtype, device, generator),
        "wv": normal((d, kv * hd), s, dtype, device, generator),
        "wo": normal((h * hd, d), (h * hd) ** -0.5, dtype, device, generator),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.ones(hd, dtype=torch.float32, device=device)
        p["k_norm"] = torch.ones(hd, dtype=torch.float32, device=device)
    return p


def _causal_mask(q_len: int, kv_len: int, q_offset, window: int,
                 device) -> torch.Tensor:
    """[q_len, kv_len] bool; True = attend. q position i sits at
    q_offset+i."""
    qpos = q_offset + torch.arange(q_len, device=device)[:, None]
    kpos = torch.arange(kv_len, device=device)[None, :]
    m = kpos <= qpos
    if window > 0:
        m &= kpos > qpos - window
    return m


def _local_heads(params, cfg, ctx):
    """(q heads, kv heads, split) this rank computes: ``1/tp`` of each
    where both divide the tp axis (``split``), else all of them.  Checks
    that the rank's weights hold exactly those heads and that its q
    heads are the whole GQA groups of its kv heads.  Without a mesh,
    every head, unchecked."""
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    if ctx is None:
        return h, kv, False
    tp = tp_size(ctx)
    # under "auto" the rank holds every head (sequence-parallel
    # attention); a length the tp axis does not divide runs replicated
    split = heads_split(cfg, tp) and ctx.attn_sharding != "auto"
    if split:
        r, group = tp_rank(ctx), h // kv
        h, kv = h // tp, kv // tp
        q_heads = range(r * h, (r + 1) * h)
        if sorted({i // group for i in q_heads}) != \
                list(range(r * kv, (r + 1) * kv)):
            raise AssertionError(f"rank {r}'s q heads {q_heads} are not "
                                 f"the groups of its kv heads")
    shapes = (params["wq"].shape[1], params["wk"].shape[1],
              params["wo"].shape[0])
    if shapes != (h * hd, kv * hd, h * hd):
        raise ValueError(f"attention weights {shapes} do not hold {h} q / "
                         f"{kv} kv heads of {hd} (tp {tp})")
    return h, kv, split


def _out_proj(params, out, ctx, split: bool):
    """``wo`` over this rank's heads, summed over the ranks when the
    heads are split (a row-parallel product)."""
    y = dot(out, params["wo"])
    return tp_all_reduce(y, ctx) if split else y


def _project_qkv(params, cfg, x, positions, heads=None, ctx=None):
    """Q/K/V projections, optional qk-norm, RoPE, over ``heads`` (q, kv)
    heads: this rank's (:func:`_local_heads`), default all of them.
    x: [B, S, D].  ``ctx``: the rank's heads are a split of them, which
    ``x`` and the qk-norm scales (whole on every rank) enter through
    ``tp_enter``."""
    b, s, _ = x.shape
    h, kv = heads or (cfg.num_heads, cfg.num_kv_heads)
    hd = cfg.head_dim
    x = tp_enter(x, ctx)
    q = dot(x, params["wq"]).reshape(b, s, h, hd)
    k = dot(x, params["wk"]).reshape(b, s, kv, hd)
    v = dot(x, params["wv"]).reshape(b, s, kv, hd)
    if cfg.qk_norm:
        q = rmsnorm(q, tp_enter(params["q_norm"], ctx), cfg.norm_eps)
        k = rmsnorm(k, tp_enter(params["k_norm"], ctx), cfg.norm_eps)
    cos, sin = rope_cos_sin(positions, hd, cfg.rope_theta, cfg.mrope_sections)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def gqa_full(params, cfg, x, positions, ctx=None, rows: bool = False):
    """Full-sequence attention.

    x: [B, S, D]; positions: [B, S] (or [B, S, 3] for M-RoPE).
    Returns (out [B,S,D], (k, v) [B,S,kv,hd] for cache writing; under a
    mesh the rank's kv heads).  Sequence-parallel where
    ``layers.seq_parallel`` holds (module docstring): ``rows`` says
    that ``x`` is already this rank's rows (``positions`` stay whole)
    and so is the output; else ``x`` and the output are whole."""
    if rows or seq_parallel(ctx, positions.shape[1]):
        return _gqa_seq_parallel(params, cfg, x, positions, ctx, rows)
    b, s, _ = x.shape
    h, kv, split = _local_heads(params, cfg, ctx)
    hd = cfg.head_dim
    q, k, v = _project_qkv(params, cfg, x, positions, (h, kv),
                           ctx if split else None)
    if _use_attn_kernel(cfg, s):
        out = ops.flash_attention(q.contiguous(), k.contiguous(),
                                  v.contiguous(), causal=True,
                                  window=cfg.sliding_window)
        return _out_proj(params, out.reshape(b, s, h * hd), ctx, split), \
            (k, v)
    rep = h // kv
    qg = q.reshape(b, s, kv, rep, hd)
    mask = _causal_mask(s, s, 0, cfg.sliding_window, x.device)
    scores = torch.einsum("bqgrd,bkgd->bgrqk", qg, k) / hd ** 0.5
    if cfg.attn_logit_softcap:
        c = cfg.attn_logit_softcap
        scores = c * torch.tanh(scores / c)
    scores = scores.float().masked_fill(~mask, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    out = torch.einsum("bgrqk,bkgd->bqgrd", probs, v).reshape(b, s, h * hd)
    return _out_proj(params, out, ctx, split), (k, v)


def _gqa_seq_parallel(params, cfg, x, positions, ctx, rows: bool):
    """``gqa_full`` on this rank's ``n = s/tp`` rows of the sequence at
    offset ``rank * n``: every head, the weights whole on every rank
    (entering the rows: their gradients are summed over tp), k and v
    gathered over tp (backward: the rank's rows of their summed
    gradients), the rank's query rows attending all s keys through the
    flash kernels at that offset.  ``rows``: ``x`` is the rank's rows and
    so is the output; else both are whole (a hybrid's residual)."""
    s = positions.shape[1]
    tp = tp_size(ctx)
    n = s // tp
    off = tp_rank(ctx) * n
    h, kv, _ = _local_heads(params, cfg, ctx)     # every head, checked
    hd = cfg.head_dim
    if not rows:
        x = seq_rows(x, ctx)
    b = x.shape[0]
    params = tp_enter_tree(params, ctx)
    q, k, v = _project_qkv(params, cfg, x, positions[:, off:off + n],
                           (h, kv))
    k = seq_gather(k, ctx, summed=True)
    v = seq_gather(v, ctx, summed=True)
    if _use_attn_kernel(cfg, s):
        out = ops.flash_attention(q.contiguous(), k.contiguous(),
                                  v.contiguous(), causal=True,
                                  window=cfg.sliding_window, q_offset=off)
    else:
        qg = q.reshape(b, n, kv, h // kv, hd)
        mask = _causal_mask(n, s, off, cfg.sliding_window, x.device)
        scores = torch.einsum("bqgrd,bkgd->bgrqk", qg, k) / hd ** 0.5
        if cfg.attn_logit_softcap:
            c = cfg.attn_logit_softcap
            scores = c * torch.tanh(scores / c)
        scores = scores.float().masked_fill(~mask, NEG_INF)
        probs = torch.softmax(scores, dim=-1).to(x.dtype)
        out = torch.einsum("bgrqk,bkgd->bqgrd", probs, v)
    y = dot(out.reshape(b, n, h * hd), params["wo"])
    return (y if rows else tp_all_gather(y, ctx, dim=1)), (k, v)


def _chunk_attend(params, cfg, x, positions, k_prefix, v_prefix, start_pos,
                  ctx=None):
    """Chunk-continuation attention over a materialized prefix.

    A chunk of C tokens at absolute positions [start_pos, start_pos+C)
    attends to the cached prefix (ring, token-id masked) plus itself
    (intra-chunk causal).  The caller writes the chunk's K/V into the
    pages afterwards, so in-chunk evictions cannot clobber keys still
    needed by earlier queries.

    x: [B, C, D]; k_prefix/v_prefix: [B, L, kv, hd]; start_pos: int or
    0-d tensor.  Returns (out [B,C,D], k_chunk, v_chunk [B,C,kv,hd]).
    """
    b, c, _ = x.shape
    h, kv, split = _local_heads(params, cfg, ctx)
    hd = cfg.head_dim
    L = k_prefix.shape[1]
    assert c <= L, "chunk larger than the cache ring"
    q, k, v = _project_qkv(params, cfg, x, positions, (h, kv))
    dev = x.device
    sp = torch.as_tensor(start_pos, device=dev).long()
    window = cfg.sliding_window
    rep = h // kv
    qg = q.reshape(b, c, kv, rep, hd)
    scale = hd ** -0.5
    qpos = sp + torch.arange(c, device=dev)[:, None]             # [c,1]

    # ---- part 1: cached prefix (tokens < sp), ring token-id masking
    slots = torch.arange(L, device=dev)[None, :]                # [1,L]
    # largest token id t == slot (mod L) with t < sp (floor mod)
    t_slot = sp - 1 - torch.remainder(sp - 1 - slots, L)        # [1,L]
    m_pre = (t_slot >= 0) & (t_slot <= qpos)
    if window > 0:
        m_pre &= t_slot > qpos - window
    s_pre = torch.einsum("bqgrd,blgd->bgrql", qg,
                         k_prefix.to(qg.dtype)) * scale
    s_pre = s_pre.float().masked_fill(~m_pre, NEG_INF)

    # ---- part 2: the fresh chunk, intra-chunk causal
    cpos = sp + torch.arange(c, device=dev)[None, :]            # [1,c]
    m_chk = cpos <= qpos
    if window > 0:
        m_chk &= cpos > qpos - window
    s_chk = torch.einsum("bqgrd,bcgd->bgrqc", qg, k) * scale
    s_chk = s_chk.float().masked_fill(~m_chk, NEG_INF)

    scores = torch.cat([s_pre, s_chk], dim=-1)                  # [b,g,r,q,L+c]
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    out = torch.einsum("bgrql,blgd->bqgrd", probs[..., :L],
                       v_prefix.to(probs.dtype)) + \
        torch.einsum("bgrqc,bcgd->bqgrd", probs[..., L:], v)
    return _out_proj(params, out.reshape(b, c, h * hd), ctx, split), k, v


def _masked_softmax_attend(qg, k_eff, v_eff, valid, softcap, dtype):
    """The einsum form of one-token decode: scores in ``dtype`` scaled by
    1/sqrt(hd) (optional softcap), masked in float32, probabilities cast
    back before PV.  qg: [B,kv,rep,hd]; k/v_eff: [B,L,kv,hd]; valid:
    [B,L].  Returns [B, kv*rep, hd]."""
    b, kv, rep, hd = qg.shape
    scores = torch.einsum("bgrd,blgd->bgrl", qg,
                          k_eff.to(qg.dtype)) / hd ** 0.5
    if softcap:
        scores = softcap * torch.tanh(scores / softcap)
    scores = scores.float().masked_fill(~valid[:, None, None, :], NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(dtype)
    return torch.einsum("bgrl,blgd->bgrd", probs,
                        v_eff.to(probs.dtype)).reshape(b, kv * rep, hd)


def _write_token(layer_cache, vals, index, active):
    """Write one token per slot into each named buffer of ``layer_cache``
    in place.  ``index`` addresses the [B] target rows; with ``active``
    ([B] bool) an inactive slot's row is written back unchanged."""
    for name, val in vals.items():
        buf = layer_cache[name]
        val = val.to(buf.dtype)
        if active is not None:
            keep = active.reshape((-1,) + (1,) * (val.dim() - 1))
            val = torch.where(keep, val, buf[index])
        buf[index] = val


def _kv_vals(layer_cache, k, v):
    """The new token's buffer entries ([B, ...] each): quantized with
    fresh per-token scales for int8 caches."""
    if "k_scale" in layer_cache:
        kq, ks = quantize_kv(k)
        vq, vs = quantize_kv(v)
        return {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
    return {"k": k, "v": v}


def gqa_decode(params, cfg, x, positions, layer_cache, cache_pos,
               active=None):
    """One-token decode against the dense cache.

    x: [B, 1, D]; layer_cache: {"k","v"[,"k_scale","v_scale"]} rings
    [B, L, kv, hd]; cache_pos: [B] int32 — tokens already in the cache.
    The new token is written in place at ring slot ``pos % L`` (only for
    ``active`` slots when given: an inactive slot's rows stay as they
    were), then attends to the first ``min(pos+1, L)`` slots — the dense
    flash-decode kernel (int8 caches: its q8 variant), or for softcap
    archs the einsum form.  Returns (out [B,1,D], layer_cache)."""
    b = x.shape[0]
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    L = layer_cache["k"].shape[1]
    q, k, v = _project_qkv(params, cfg, x, positions)
    widx = torch.remainder(cache_pos.long(), L)
    rows = torch.arange(b, device=x.device)
    _write_token(layer_cache, _kv_vals(layer_cache, k[:, 0], v[:, 0]),
                 (rows, widx), active)
    n_valid = torch.clamp(cache_pos + 1, max=L).to(torch.int32)
    quant = "k_scale" in layer_cache
    if cfg.attn_logit_softcap:
        k_eff, v_eff = layer_cache["k"], layer_cache["v"]
        if quant:
            k_eff = dequantize_kv(k_eff, layer_cache["k_scale"], x.dtype)
            v_eff = dequantize_kv(v_eff, layer_cache["v_scale"], x.dtype)
        valid = torch.arange(L, device=x.device)[None, :] \
            < n_valid.long()[:, None]
        o = _masked_softmax_attend(q.reshape(b, kv, h // kv, hd), k_eff,
                                   v_eff, valid, cfg.attn_logit_softcap,
                                   x.dtype)
    elif quant:
        o = ops.decode_attention_q8(
            q[:, 0].contiguous(), layer_cache["k"], layer_cache["k_scale"],
            layer_cache["v"], layer_cache["v_scale"], n_valid)
    else:
        o = ops.decode_attention(q[:, 0].contiguous(), layer_cache["k"],
                                 layer_cache["v"], n_valid)
    out = o.to(x.dtype).reshape(b, 1, h * hd)
    return dot(out, params["wo"]), layer_cache


def gqa_continue(params, cfg, x, positions, layer_cache, start_pos):
    """Chunked-prefill continuation (Sarathi-style) on the dense layout.

    Ring-safe: the cache may be a window ring (slot t%L holds token t).
    x: [B, C, D]; layer_cache: {"k","v"} rings [B, L, kv, hd]; start_pos:
    int or 0-d tensor.  The chunk's K/V are written into the ring in
    place after attention.  Returns (out [B,C,D], layer_cache)."""
    if "k_scale" in layer_cache:
        # the JAX package's gqa_continue drops the scales of an int8 ring
        # (reads raw int8 values); there is no reference to port
        raise NotImplementedError("chunked prefill on a dense int8 cache")
    L = layer_cache["k"].shape[1]
    c = x.shape[1]
    out, k, v = _chunk_attend(params, cfg, x, positions, layer_cache["k"],
                              layer_cache["v"], start_pos)
    widx = torch.remainder(start_pos + torch.arange(c, device=x.device), L)
    layer_cache["k"][:, widx] = k.to(layer_cache["k"].dtype)
    layer_cache["v"][:, widx] = v.to(layer_cache["v"].dtype)
    return out, layer_cache


def gqa_continue_paged(params, cfg, x, positions, layer_cache, block_tables,
                       start_pos, n=None, ctx=None):
    """Chunked-prefill continuation on the paged pool (single slot).

    x: [1, C, D]; the prefix is gathered through the block table, the
    chunk's first ``n`` rows (default C) are then scattered into its
    pages in place — padded suffix buckets write only their valid span,
    and padded keys stay causally masked out of every valid query.
    int8 pages are dequantized in the gather and the chunk is written
    quantized with fresh per-token scales.  Returns (out [1,C,D],
    layer_cache)."""
    c = x.shape[1]
    if n is None:
        n = c
    k_prefix = gather_pages(layer_cache["k"], block_tables)
    v_prefix = gather_pages(layer_cache["v"], block_tables)
    if "k_scale" in layer_cache:
        k_prefix = dequantize_kv(k_prefix, gather_pages(
            layer_cache["k_scale"], block_tables), x.dtype)
        v_prefix = dequantize_kv(v_prefix, gather_pages(
            layer_cache["v_scale"], block_tables), x.dtype)
    out, k, v = _chunk_attend(params, cfg, x, positions, k_prefix, v_prefix,
                              start_pos, ctx)
    bt = block_tables[0]
    for name, val in _kv_vals(layer_cache, k[0], v[0]).items():
        paged_prefill_write(layer_cache[name], val, bt, n, start=start_pos)
    return out, layer_cache


def _paged_write_token(layer_cache, k, v, block_tables, cache_pos):
    """Write one new token per sequence into its page, in place (O(B);
    int8 pages get the token quantized and its scales).
    k/v: [B, 1, kv, hd]."""
    P = layer_cache["k"].shape[1]
    L = block_tables.shape[1] * P
    widx = torch.remainder(cache_pos.long(), L)                 # [B]
    page_ids = torch.gather(block_tables.long(), 1,
                            (widx // P)[:, None])[:, 0]
    offs = torch.remainder(widx, P)
    for name, val in _kv_vals(layer_cache, k[:, 0], v[:, 0]).items():
        paged_token_write(layer_cache[name], val, page_ids, offs)
    return layer_cache


def gqa_decode_paged(params, cfg, x, positions, layer_cache, block_tables,
                     cache_pos, ctx=None):
    """One-token decode against the paged KV pool.

    x: [B, 1, D]; layer_cache: {"k","v"[,"k_scale","v_scale"]} pages
    [N, P, kv, hd]; block_tables: [B, pages_per_slot] int32; cache_pos:
    [B] int32.  The new token is written in place into its page, then
    attention runs through the block table — the paged flash-decode
    kernel (int8 pages: its q8 variant), or for softcap archs a gather of
    the live pages.
    Under a mesh the pages hold the rank's kv heads.
    Returns (out [B,1,D], layer_cache)."""
    b = x.shape[0]
    h, kv, split = _local_heads(params, cfg, ctx)
    hd = cfg.head_dim
    q, k, v = _project_qkv(params, cfg, x, positions, (h, kv))
    _paged_write_token(layer_cache, k, v, block_tables, cache_pos)
    lengths = cache_pos + 1
    quant = "k_scale" in layer_cache
    if cfg.attn_logit_softcap:
        # the paged kernels have no logit softcap — gather the live pages
        # (dequantized for int8) and run the einsum path
        P = layer_cache["k"].shape[1]
        L = block_tables.shape[1] * P
        k_eff = gather_pages(layer_cache["k"], block_tables)
        v_eff = gather_pages(layer_cache["v"], block_tables)
        if quant:
            k_eff = dequantize_kv(k_eff, gather_pages(layer_cache["k_scale"],
                                                      block_tables), x.dtype)
            v_eff = dequantize_kv(v_eff, gather_pages(layer_cache["v_scale"],
                                                      block_tables), x.dtype)
        ln = lengths.long()[:, None]
        s_idx = torch.arange(L, device=x.device)[None, :]
        t_s = ln - 1 - torch.remainder(ln - 1 - s_idx, L)
        valid = t_s >= 0
        if cfg.sliding_window > 0:
            valid &= t_s > ln - 1 - cfg.sliding_window
        o = _masked_softmax_attend(q.reshape(b, kv, h // kv, hd), k_eff,
                                   v_eff, valid, cfg.attn_logit_softcap,
                                   x.dtype)
    elif quant:
        o = ops.decode_attention_paged_q8(
            q[:, 0].contiguous(), layer_cache["k"], layer_cache["k_scale"],
            layer_cache["v"], layer_cache["v_scale"], block_tables,
            lengths.to(torch.int32), window=cfg.sliding_window)
    else:
        o = ops.decode_attention_paged(
            q[:, 0].contiguous(), layer_cache["k"], layer_cache["v"],
            block_tables, lengths.to(torch.int32), window=cfg.sliding_window)
    out = o.to(x.dtype).reshape(b, 1, h * hd)
    return _out_proj(params, out, ctx, split), layer_cache


# =================================================================== MLA
def init_mla(cfg, dtype: torch.dtype, device: torch.device,
             generator: torch.Generator):
    m = cfg.mla
    d, h = cfg.d_model, cfg.num_heads
    qk_hd = m.qk_nope_head_dim + m.qk_rope_head_dim
    s, r = d ** -0.5, m.kv_lora_rank ** -0.5
    return {
        "wq": normal((d, h * qk_hd), s, dtype, device, generator),
        "w_dkv": normal((d, m.kv_lora_rank), s, dtype, device, generator),
        "w_krope": normal((d, m.qk_rope_head_dim), s, dtype, device,
                          generator),
        "w_uk": normal((m.kv_lora_rank, h * m.qk_nope_head_dim), r, dtype,
                       device, generator),
        "w_uv": normal((m.kv_lora_rank, h * m.v_head_dim), r, dtype, device,
                       generator),
        "wo": normal((h * m.v_head_dim, d), (h * m.v_head_dim) ** -0.5,
                     dtype, device, generator),
        "kv_norm": torch.ones(m.kv_lora_rank, dtype=torch.float32,
                              device=device)}


def _mla_heads(params, cfg, ctx):
    """(heads, split) this rank computes: ``nh/tp`` where the heads
    divide the tp axis (``split``), else all of them.  Checks that the
    rank's ``wq``, ``w_uk``, ``w_uv`` and ``wo`` hold exactly those
    heads.  Without a mesh, every head, unchecked."""
    h = cfg.num_heads
    if ctx is None:
        return h, False
    m = cfg.mla
    tp = tp_size(ctx)
    split = heads_split(cfg, tp)
    if split:
        h //= tp
    shapes = (params["wq"].shape[1], params["w_uk"].shape[1],
              params["w_uv"].shape[1], params["wo"].shape[0])
    want = (h * (m.qk_nope_head_dim + m.qk_rope_head_dim),
            h * m.qk_nope_head_dim, h * m.v_head_dim, h * m.v_head_dim)
    if shapes != want:
        raise ValueError(f"MLA weights {shapes} do not hold {h} heads "
                         f"(tp {tp}): want {want}")
    return h, split


def _mla_project(params, cfg, x, positions, h=None, ctx=None):
    """q over ``h`` heads (default all of them) split into its no-rope
    and rope parts ([B,S,h,nope] and [B,S,h,rope_d], RoPE applied), the
    normed latent c_kv [B,S,rank] and the shared rope key k_pe
    [B,S,rope_d].  ``ctx``: x enters this rank's columns of ``wq``
    (``tp_enter``)."""
    m = cfg.mla
    b, s, _ = x.shape
    nope, rope_d = m.qk_nope_head_dim, m.qk_rope_head_dim
    q = dot(tp_enter(x, ctx), params["wq"]).reshape(
        b, s, h or cfg.num_heads, nope + rope_d)
    c_kv = rmsnorm(dot(x, params["w_dkv"]), params["kv_norm"], cfg.norm_eps)
    k_pe = dot(x, params["w_krope"]).reshape(b, s, 1, rope_d)
    cos, sin = rope_cos_sin(positions, rope_d, cfg.rope_theta)
    return (q[..., :nope], apply_rope(q[..., nope:], cos, sin), c_kv,
            apply_rope(k_pe, cos, sin)[:, :, 0])


def mla_full(params, cfg, x, positions, ctx=None, rows: bool = False):
    """MLA prefill / train: expand the latent and run causal attention
    (under a mesh over this rank's heads).  Returns (out [B,S,D], (c_kv
    [B,S,rank], k_pe [B,S,rope_d])) for cache writing.  ``rows``: ``x``
    is this rank's rows of a sequence-parallel residual: they are
    gathered (MLA runs off the sequence path, as in the reference) and
    the rank's rows of the output returned."""
    if rows:
        out, kv_out = mla_full(params, cfg, seq_gather(x, ctx), positions,
                               ctx)
        return seq_rows(out, ctx), kv_out
    m = cfg.mla
    b, s, _ = x.shape
    h, split = _mla_heads(params, cfg, ctx)
    nope, rope_d, vhd = m.qk_nope_head_dim, m.qk_rope_head_dim, m.v_head_dim
    ent = ctx if split else None
    q_nope, q_pe, c_kv, k_pe = _mla_project(params, cfg, x, positions, h,
                                            ent)
    # the whole latent and rope key enter this rank's heads
    c_in, pe_in = tp_enter(c_kv, ent), tp_enter(k_pe, ent)
    k_nope = dot(c_in, params["w_uk"]).reshape(b, s, h, nope)
    v = dot(c_in, params["w_uv"]).reshape(b, s, h, vhd)
    # 1/sqrt(nope + rope_d) with the root rounded to x's dtype, as the
    # JAX package scales (a 0-d CPU tensor: a scalar to the device op)
    scale = 1.0 / torch.tensor(float(nope + rope_d)).sqrt().to(x.dtype)
    scores = (torch.einsum("bqhd,bkhd->bhqk", q_nope, k_nope)
              + torch.einsum("bqhd,bkd->bhqk", q_pe, pe_in)) * scale
    mask = _causal_mask(s, s, 0, 0, x.device)
    probs = torch.softmax(scores.float().masked_fill(~mask, NEG_INF),
                          dim=-1).to(x.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(b, s, h * vhd)
    return _out_proj(params, out, ctx, split), (c_kv, k_pe)


def _mla_attend(params, cfg, q_nope, q_pe, ckv, kpe, n_valid, dtype,
                ctx=None, split=False):
    """Absorbed one-token MLA attention over a latent view.

    q_nope [B,h,nope], q_pe [B,h,rope_d] (h: this rank's heads); ckv
    [B,L,rank], kpe [B,L,rope_d]; the first ``n_valid`` [B] slots attend.
    score_l = (q_nope · W_uk) · c_l + q_pe · kpe_l, in float32;
    out = (Σ p_l c_l) · W_uv, then ``wo`` (summed over the ranks when
    the heads are ``split``).  Returns [B, 1, D]."""
    m = cfg.mla
    b, h = q_nope.shape[:2]
    nope, rope_d, vhd = m.qk_nope_head_dim, m.qk_rope_head_dim, m.v_head_dim
    rank = m.kv_lora_rank
    L = ckv.shape[1]
    q_abs = torch.einsum("bhd,rhd->bhr", q_nope,
                         params["w_uk"].reshape(rank, h, nope))
    ckv = ckv.float()
    scores = (torch.einsum("bhr,blr->bhl", q_abs.float(), ckv)
              + torch.einsum("bhd,bld->bhl", q_pe.float(), kpe.float())) \
        * (nope + rope_d) ** -0.5
    valid = torch.arange(L, device=ckv.device)[None, :] \
        < n_valid.long()[:, None]
    probs = torch.softmax(scores.masked_fill(~valid[:, None, :], NEG_INF),
                          dim=-1)
    lat = torch.einsum("bhl,blr->bhr", probs, ckv).to(dtype)
    out = torch.einsum("bhr,rhd->bhd", lat,
                       params["w_uv"].reshape(rank, h, vhd))
    return _out_proj(params, out.reshape(b, 1, h * vhd), ctx, split)


def mla_decode(params, cfg, x, positions, layer_cache, cache_pos,
               active=None, ctx=None):
    """Absorbed MLA decode against the dense latent ring.

    x: [B, 1, D]; layer_cache: {"ckv": [B, L, rank], "kpe": [B, L,
    rope_d]}; cache_pos: [B].  The new latent token is written in place
    at slot ``pos % L`` (for ``active`` slots only when given), then
    attends to the first ``min(pos+1, L)`` slots.  ``ctx``: one rank
    of a mesh (module docstring).  Returns (out [B,1,D], layer_cache)."""
    b = x.shape[0]
    L = layer_cache["ckv"].shape[1]
    h, split = _mla_heads(params, cfg, ctx)
    q_nope, q_pe, c_kv, k_pe = _mla_project(params, cfg, x, positions, h)
    rows = torch.arange(b, device=x.device)
    _write_token(layer_cache, {"ckv": c_kv[:, 0], "kpe": k_pe[:, 0]},
                 (rows, torch.remainder(cache_pos.long(), L)), active)
    n_valid = torch.clamp(cache_pos + 1, max=L)
    return _mla_attend(params, cfg, q_nope[:, 0], q_pe[:, 0],
                       layer_cache["ckv"], layer_cache["kpe"], n_valid,
                       x.dtype, ctx, split), layer_cache


def mla_decode_paged(params, cfg, x, positions, layer_cache, block_tables,
                     cache_pos, ctx=None):
    """Absorbed MLA decode against the paged latent pool.

    layer_cache: {"ckv": [N, P, rank], "kpe": [N, P, rope_d]} pages.  The
    new latent token is written in place into its page, then the slot's
    whole logical ring is gathered (``[B, slot_len, rank + rope_d]``)
    and the dense absorbed math runs on it, as the JAX package does (the
    latent is too narrow for a per-kv-head kernel tile; paging buys MLA
    capacity, not decode reads).  Under a mesh the pages hold the whole
    latent on every rank.  Returns (out [B,1,D], layer_cache)."""
    P = layer_cache["ckv"].shape[1]
    L = block_tables.shape[1] * P
    h, split = _mla_heads(params, cfg, ctx)
    q_nope, q_pe, c_kv, k_pe = _mla_project(params, cfg, x, positions, h)
    widx = torch.remainder(cache_pos.long(), L)
    page_ids = torch.gather(block_tables.long(), 1,
                            (widx // P)[:, None])[:, 0]
    offs = torch.remainder(widx, P)
    paged_token_write(layer_cache["ckv"], c_kv[:, 0], page_ids, offs)
    paged_token_write(layer_cache["kpe"], k_pe[:, 0], page_ids, offs)
    n_valid = torch.clamp(cache_pos + 1, max=L)
    return _mla_attend(params, cfg, q_nope[:, 0], q_pe[:, 0],
                       gather_pages(layer_cache["ckv"], block_tables),
                       gather_pages(layer_cache["kpe"], block_tables),
                       n_valid, x.dtype, ctx, split), layer_cache
