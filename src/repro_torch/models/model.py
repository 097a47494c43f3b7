"""Dense GQA decoder over the dense and paged KV caches (the dense-model
paths of ``src/repro/models/model.py``).

Parameters are a plain dict of tensors with the JAX package's layout
(``x @ w``, ``w: [d_in, d_out]``; norm scales float32), so
:func:`repro_torch.bridge.from_jax_params` is a straight copy.  The
forward functions take a cache dict of :mod:`repro_torch.models.cache`
(dense: ``forward_full``/``forward_decode``/``forward_chunk``; paged:
the ``*_paged`` forwards), float or int8, and update it in place.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.device import resolve_device, torch_dtype
from repro_torch.models import attention as attn
from repro_torch.models.cache import (require_dense_gqa, write_prefill,
                                      write_prefill_paged)
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import apply_mlp, apply_norm, init_mlp, \
    init_norm, normal


def init_params(cfg: ModelConfig, *, seed: int = 0, device=None,
                generator: Optional[torch.Generator] = None):
    """Random parameters at ``cfg``'s shapes, drawn on ``device`` (default
    ``cuda``) in ``cfg.dtype`` from a seeded generator on that device."""
    require_dense_gqa(cfg)
    if cfg.num_codebooks > 1:
        raise NotImplementedError("multi-codebook heads: ROADMAP M10")
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev)
        generator.manual_seed(seed)
    dtype = torch_dtype(cfg.dtype)
    s = cfg.d_model ** -0.5
    params = {"embed": normal((cfg.vocab_size, cfg.d_model), s, dtype, dev,
                              generator),
              "final_norm": init_norm(cfg, cfg.d_model, dev),
              "layers": []}
    if not cfg.tie_embeddings:
        params["lm_head"] = normal((cfg.d_model, cfg.vocab_size), s, dtype,
                                   dev, generator)
    for _ in range(cfg.num_layers):
        params["layers"].append({
            "attn_norm": init_norm(cfg, cfg.d_model, dev),
            "mlp_norm": init_norm(cfg, cfg.d_model, dev),
            "attn": attn.init_gqa(cfg, dtype, dev, generator),
            "mlp": init_mlp(cfg, cfg.d_model, cfg.d_ff, dtype, dev,
                            generator)})
    return params


def embed_tokens(params, cfg, tokens):
    return params["embed"][tokens.long()]


def lm_head(params, cfg, x):
    if cfg.tie_embeddings:
        return x @ params["embed"].T
    return x @ params["lm_head"]


def _mlp_residual(block, cfg, x):
    return x + apply_mlp(apply_norm(x, block["mlp_norm"], cfg), block["mlp"],
                         cfg)


def _attn_block_full(block, cfg, x, positions):
    h, kv_out = attn.gqa_full(block["attn"], cfg,
                              apply_norm(x, block["attn_norm"], cfg),
                              positions)
    return _mlp_residual(block, cfg, x + h), kv_out


def _default_positions(cfg, batch, seq, offset, device):
    pos = offset + torch.arange(seq, dtype=torch.int32, device=device)[None]
    pos = pos.expand(batch, seq)
    if cfg.mrope_sections:
        pos = pos[..., None].expand(batch, seq, 3)
    return pos


def _attn_block_decode(block, cfg, x, positions, layer_cache, cache_pos,
                       active=None):
    h, _ = attn.gqa_decode(block["attn"], cfg,
                           apply_norm(x, block["attn_norm"], cfg), positions,
                           layer_cache, cache_pos, active=active)
    return _mlp_residual(block, cfg, x + h)


def forward_full(params, cfg: ModelConfig, *, tokens, cache=None,
                 last_only: bool = False):
    """Prefill pass over a whole sequence. tokens: [B, S].

    With ``cache`` (a dense cache of :func:`init_cache`), each layer's
    K/V are ring-written into it in place and ``pos`` advances by S.
    ``last_only`` applies the LM head to the final position only.
    Returns (logits [B, S or 1, V], cache_or_None, aux) — ``aux`` is the
    MoE load-balance loss of the JAX signature, 0 for dense models."""
    x = embed_tokens(params, cfg, tokens)
    b, s = x.shape[0], x.shape[1]
    positions = _default_positions(cfg, b, s, 0, x.device)
    for i, block in enumerate(params["layers"]):
        x, kv_out = _attn_block_full(block, cfg, x, positions)
        if cache is not None:
            write_prefill(cache, i, kv_out, cfg)
    if last_only:
        x = x[:, -1:]
    x = apply_norm(x, params["final_norm"], cfg)
    logits = lm_head(params, cfg, x)
    if cache is not None:
        cache["pos"] += s
    return logits, cache, 0.0


def forward_decode(params, cfg: ModelConfig, *, tokens, cache, active=None):
    """One-token decode step for every slot of a dense cache.
    tokens: [B, 1].

    New K/V are ring-written in place; ``active`` ([B] bool, optional)
    limits the writes to those slots, so an inactive slot's rows keep
    their values.  Returns (logits [B, 1, V], new_cache) where
    ``new_cache`` shares the layer tensors and carries ``pos + 1`` for
    every slot (the engine keeps the old ``pos`` of inactive slots, as
    the JAX engine does)."""
    x = embed_tokens(params, cfg, tokens)
    b = x.shape[0]
    cache_pos = cache["pos"]
    positions = cache_pos[:, None]
    if cfg.mrope_sections:
        positions = positions[..., None].expand(b, 1, 3)
    for block, layer_cache in zip(params["layers"], cache["layers"]):
        x = _attn_block_decode(block, cfg, x, positions, layer_cache,
                               cache_pos, active)
    x = apply_norm(x, params["final_norm"], cfg)
    return lm_head(params, cfg, x), {"pos": cache_pos + 1,
                                     "layers": cache["layers"]}


def forward_chunk(params, cfg: ModelConfig, *, tokens, cache):
    """Chunked-prefill step (Sarathi-style): a chunk of C tokens against
    a dense cache already holding ``cache["pos"]`` tokens (uniform across
    the batch).  The chunk's K/V are ring-written in place and ``pos``
    advances by C.  Returns (logits of the chunk's last position
    [B,1,V], cache)."""
    x = embed_tokens(params, cfg, tokens)
    b, c = x.shape[0], x.shape[1]
    pos0 = cache["pos"][0].clone()
    positions = (pos0 + torch.arange(c, device=x.device,
                                     dtype=torch.int32))[None].expand(b, c)
    if cfg.mrope_sections:
        positions = positions[..., None].expand(b, c, 3)
    for block, layer_cache in zip(params["layers"], cache["layers"]):
        xin = apply_norm(x, block["attn_norm"], cfg)
        h, _ = attn.gqa_continue(block["attn"], cfg, xin, positions,
                                 layer_cache, pos0)
        x = _mlp_residual(block, cfg, x + h)
    x = apply_norm(x[:, -1:], params["final_norm"], cfg)
    logits = lm_head(params, cfg, x)
    cache["pos"] += c
    return logits, cache


def forward_decode_paged(params, cfg: ModelConfig, *, tokens, cache):
    """One-token decode step for every slot. tokens: [B, 1].

    New K/V are written in place into the pages; returns
    (logits [B, 1, V], new_cache) where ``new_cache`` shares the page
    tensors and carries ``pos + 1`` for every slot (the engine keeps the
    old ``pos`` of inactive slots, as the JAX engine does)."""
    x = embed_tokens(params, cfg, tokens)
    b = x.shape[0]
    cache_pos = cache["pos"]
    block_tables = cache["block_tables"]
    positions = cache_pos[:, None]
    if cfg.mrope_sections:
        positions = positions[..., None].expand(b, 1, 3)
    for block, layer_cache in zip(params["layers"], cache["layers"]):
        xin = apply_norm(x, block["attn_norm"], cfg)
        h, _ = attn.gqa_decode_paged(block["attn"], cfg, xin, positions,
                                     layer_cache, block_tables, cache_pos)
        x = _mlp_residual(block, cfg, x + h)
    x = apply_norm(x, params["final_norm"], cfg)
    return lm_head(params, cfg, x), {"pos": cache_pos + 1,
                                     "block_tables": block_tables,
                                     "layers": cache["layers"]}


def forward_prefill_paged(params, cfg: ModelConfig, *, tokens, cache,
                          slot: int = 0, length: Optional[int] = None):
    """Whole-prompt prefill of ONE request written in place into
    ``slot``'s pages (an O(prompt) scatter per layer through the slot's
    block table; padded positions land on the null page).

    tokens: [1, Lpad]; ``length``: actual prompt length.  Returns
    (last-token logits [V], cache)."""
    x = embed_tokens(params, cfg, tokens)
    b, s = x.shape[0], x.shape[1]
    if length is None:
        length = s
    positions = _default_positions(cfg, b, s, 0, x.device)
    for i, block in enumerate(params["layers"]):
        x, kv_out = _attn_block_full(block, cfg, x, positions)
        write_prefill_paged(cache, i, kv_out, cfg, slot, length)
    x = apply_norm(x[:, length - 1:length], params["final_norm"], cfg)
    logits = lm_head(params, cfg, x)
    cache["pos"][slot] = length
    return logits[0, 0], cache


def forward_chunk_paged(params, cfg: ModelConfig, *, tokens, cache,
                        slot: int = 0, length: Optional[int] = None):
    """Chunked-prefill step for ONE slot against the paged pool
    (Sarathi-style): the chunk attends to the slot's gathered pages plus
    itself, then is scattered into its pages in place.

    The chunk starts at ``cache["pos"][slot]``, which need not be 0: a
    request aliasing a cached prefix presets ``pos`` to the cached length
    and prefills only its unique suffix here.  tokens: [1, C];
    ``length`` (default C) is the number of valid rows of a padded pow-2
    bucket — padded rows are never written to pages and never attended
    by valid queries.  Returns (valid-final logits [1,1,V], cache)."""
    x = embed_tokens(params, cfg, tokens)
    b, c = x.shape[0], x.shape[1]
    if length is None:
        length = c
    pos0 = cache["pos"][slot].clone()      # the chunk's first position
    bt = cache["block_tables"][slot:slot + 1]
    positions = (pos0 + torch.arange(c, device=x.device,
                                     dtype=torch.int32))[None].expand(b, c)
    if cfg.mrope_sections:
        positions = positions[..., None].expand(b, c, 3)
    for block, layer_cache in zip(params["layers"], cache["layers"]):
        xin = apply_norm(x, block["attn_norm"], cfg)
        h, _ = attn.gqa_continue_paged(block["attn"], cfg, xin, positions,
                                       layer_cache, bt, pos0, n=length)
        x = _mlp_residual(block, cfg, x + h)
    x = apply_norm(x[:, length - 1:length], params["final_norm"], cfg)
    logits = lm_head(params, cfg, x)
    cache["pos"][slot] += length
    return logits, cache
