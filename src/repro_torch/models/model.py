"""Decoders over the dense and paged KV caches (counterpart of
``src/repro/models/model.py``): GQA or MLA attention blocks whose FFN is
an MLP or, on the MoE layers of an MoE config, a mixture of experts
(``moe_ffn``); attention-free Mamba2 (SSM) stacks over the dense cache;
hybrid stacks of Mamba2 blocks and one shared attention+MLP block
(zamba2) over either.  Audio (musicgen) models embed K codebooks, summed,
and emit K logit heads; VLM backbones take precomputed ``embeds`` (and
M-RoPE ``positions``) in place of token ids.

Parameters are a plain dict of tensors with the JAX package's layout
(``x @ w``, ``w: [d_in, d_out]``; norm scales and the MoE router
float32), so
:func:`repro_torch.bridge.from_jax_params` is a straight copy.  The
forward functions take a cache dict of :mod:`repro_torch.models.cache`
(dense: ``forward_full``/``forward_decode``/``forward_chunk``; paged:
the ``*_paged`` forwards), float or int8, and update it in place.

With ``cfg.shared_attn_weights`` the attention layers share one block,
``params["shared_block"]``, and hold ``{}`` at their own positions of
``params["layers"]``, as in the JAX package; every forward resolves
``params["layers"][i] or params.get("shared_block")``.  Each attention
layer keeps its own K/V in the cache.

MLA archs have no chunked path (``forward_chunk`` / ``forward_chunk_paged``
refuse them, as the JAX package asserts): the engine prefills them whole.

``forward_full`` and the three paged forwards take a ``ctx``
(``ShardingCtx``) to run as one rank of a mesh on that rank's slice of
the params (``distributed.sharding.shard_params``; under FSDP each
layer gathers its shards first, ``layers.fsdp_gather``) and pages: GQA
or MLA attention over its heads (a hybrid's shared block too; MLA's latent
whole on every rank), the MLP's and MoE's splits
(:mod:`repro_torch.models.layers`, :mod:`repro_torch.models.moe`), a
vocabulary-parallel embedding (rows outside the rank's slice masked, then
summed; K codebooks' tables alike) and head (each rank's vocabulary
slice of the logits, put back together on every rank, so every rank
samples the same token, unless ``forward_full`` is asked for the slice).
SSM layers run whole on every tp rank, on the same residual stream, so
every rank holds the same per-slot state.  ``forward_full`` also trains
under a ``(data, tp)`` mesh: each data rank runs its rows of the batch,
and under FSDP (``ctx.fsdp_axes``) each layer gathers the weights the
data axis shards (``layers.fsdp_gather``) inside its checkpointed
function, so the re-forward gathers them again and no whole layer
outlives its use.

Under ``attn_sharding="auto"`` where the reference keeps the residual
stream sequence-parallel (``layers.seq_parallel`` of the length, no SSM
layers), ``forward_full`` keeps each tp rank's ``s/tp`` rows between the
blocks: every rank embeds the whole sequence and keeps its rows; norms,
MLPs and the baseline MoE run on the rows (their weights whole on every
rank entering the rows, a split MLP gathering the rows and
reduce-scattering its output); attention is sequence-parallel
(:mod:`repro_torch.models.attention`); MLA and the expert-parallel MoE
branches gather the rows and hand back the rank's.  After the last
block the rows are put back together, and the final norm, the head and
the loss run on the whole sequence as without ``"auto"``: the
vocabulary-parallel head and loss stay as they are, and the logits come
out whole, as the reference's do.  Zamba2's residual stays whole (its
SSM layers run on the whole sequence); its shared attention block takes
its rows inside ``gqa_full``.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device, torch_dtype
from repro_torch.models import attention as attn
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.cache import write_prefill, write_prefill_paged
from repro_torch.models.config import SSM, ModelConfig
from repro_torch.models.layers import apply_mlp, apply_norm, dot, dp_size, \
    fsdp_gather_tree, init_mlp, init_norm, normal, seq_parallel, seq_rows, \
    tp_all_gather, tp_all_reduce, tp_enter, tp_enter_tree, tp_rank, \
    tp_split
from repro_torch.models.moe import init_moe, moe_ffn


def init_params(cfg: ModelConfig, *, seed: int = 0, device=None,
                generator: Optional[torch.Generator] = None):
    """Random parameters at ``cfg``'s shapes, drawn on ``device`` (default
    ``cuda``) in ``cfg.dtype`` from a seeded generator on that device
    (norm scales and the SSM blocks' ``A_log``/``dt_bias``/``D``/``norm``
    float32, as in the JAX package; with ``cfg.num_codebooks`` K > 1,
    ``embed [K, V, d]`` and ``lm_head [K, d, V]``).  An attention block
    takes MLA where
    ``cfg.mla`` is set, and an MoE FFN in place of its MLP on the MoE
    layers (those not in ``cfg.moe.dense_layers``; the dense ones are
    ``cfg.moe.d_ff_dense`` wide when it is set).  With
    ``cfg.shared_attn_weights``
    one attention block is drawn at the first attention layer and stored
    as ``params["shared_block"]``, with ``{}`` at every attention
    position of ``params["layers"]`` (the JAX tree).  ``device="meta"``
    gives the tree's shapes and dtypes with nothing allocated (the
    sharding rules read them)."""
    meta = device is not None and torch.device(device).type == "meta"
    dev = torch.device("meta") if meta else resolve_device(device)
    if generator is None and not meta:
        generator = torch.Generator(device=dev)
        generator.manual_seed(seed)
    dtype = torch_dtype(cfg.dtype)
    s = cfg.d_model ** -0.5
    # K codebooks (musicgen): one table and one head per codebook
    lead = (cfg.num_codebooks,) if cfg.num_codebooks > 1 else ()
    params = {"embed": normal(lead + (cfg.vocab_size, cfg.d_model), s, dtype,
                              dev, generator),
              "final_norm": init_norm(cfg, cfg.d_model, dev),
              "layers": []}
    if not cfg.tie_embeddings:
        params["lm_head"] = normal(lead + (cfg.d_model, cfg.vocab_size), s,
                                   dtype, dev, generator)
    for i, kind in enumerate(cfg.layer_pattern):
        if kind == SSM:
            params["layers"].append({
                "norm": init_norm(cfg, cfg.d_model, dev),
                "mamba": ssm_mod.init_mamba2(cfg, dtype, dev, generator)})
            continue
        if cfg.shared_attn_weights and "shared_block" in params:
            params["layers"].append({})    # weights live in shared_block
            continue
        block = {
            "attn_norm": init_norm(cfg, cfg.d_model, dev),
            "mlp_norm": init_norm(cfg, cfg.d_model, dev),
            "attn": (attn.init_mla if cfg.mla is not None else
                     attn.init_gqa)(cfg, dtype, dev, generator)}
        if cfg.moe is not None and i not in cfg.moe.dense_layers:
            block["moe"] = init_moe(cfg, dtype, dev, generator)
        else:
            ff = cfg.moe.d_ff_dense if cfg.moe is not None \
                and cfg.moe.d_ff_dense else cfg.d_ff
            block["mlp"] = init_mlp(cfg, cfg.d_model, ff, dtype, dev,
                                    generator)
        if cfg.shared_attn_weights:
            params["shared_block"] = block
            block = {}
        params["layers"].append(block)
    return params


def _blocks(params):
    """Each layer's block: its own, or the shared attention block where
    the layer holds the ``{}`` marker."""
    shared = params.get("shared_block")
    return [block or shared for block in params["layers"]]


def _vocab_rows(table, ids, ctx, split: bool):
    """Rows ``ids`` of an embedding table; where the tp axis splits the
    vocabulary, the rows of ids outside this rank's slice are zero."""
    if not split:
        return table[ids]
    n = table.shape[0]
    ids = ids - tp_rank(ctx) * n
    mine = (ids >= 0) & (ids < n)
    rows = table[torch.where(mine, ids, torch.zeros_like(ids))]
    return torch.where(mine[..., None], rows, torch.zeros_like(rows))


def embed_tokens(params, cfg, tokens, ctx=None):
    """tokens [B, S] -> [B, S, d]; with K codebooks tokens [B, S, K] and
    the K embeddings summed in codebook order, as the JAX package sums
    them.  Under a mesh whose tp axis splits the vocabulary, each rank
    looks up the ids in its slice of rows, zeros the others, and the
    ranks' rows are summed."""
    emb = params["embed"]
    k = cfg.num_codebooks
    split = ctx is not None and tp_split(
        cfg.vocab_size, emb.shape[-2], ctx, "vocabulary")
    if k > 1:
        x = sum(_vocab_rows(emb[i], tokens[..., i].long(), ctx, split)
                for i in range(k))
    else:
        x = _vocab_rows(emb, tokens.long(), ctx, split)
    return tp_all_reduce(x, ctx, "vocab") if split else x


def lm_head(params, cfg, x, ctx=None, gather: bool = True):
    """[B, S, d] -> logits [B, S, V] (K codebooks: [B, S, K, V]).  Under
    a mesh whose tp axis splits the vocabulary each rank computes its
    slice of the logits (tied embeddings: its rows of ``embed``), and
    the whole logits are put back together on every rank (``gather``;
    else this rank's slice is returned)."""
    if cfg.num_codebooks > 1:
        w = params["embed"].transpose(1, 2) if cfg.tie_embeddings \
            else params["lm_head"]
    else:
        w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    split = ctx is not None and tp_split(cfg.vocab_size, w.shape[-1], ctx,
                                         "vocabulary")
    if split:
        x = tp_enter(x, ctx, "vocab")
    if cfg.num_codebooks > 1:
        logits = torch.stack([dot(x, w[i])
                              for i in range(cfg.num_codebooks)], dim=2)
    else:
        logits = dot(x, w)
    if split and gather:
        logits = tp_all_gather(logits, ctx, dim=-1, kind="vocab")
    return logits


def _mlp_width(cfg) -> int:
    """The width of an attention layer's MLP (as ``init_params`` draws
    it)."""
    return cfg.moe.d_ff_dense if cfg.moe is not None \
        and cfg.moe.d_ff_dense else cfg.d_ff


def _norm(x, params, cfg, ctx, rows: bool):
    """``apply_norm``; on a sequence-parallel rank's rows its weights
    enter the rows (their gradients summed over tp)."""
    return apply_norm(x, tp_enter_tree(params, ctx) if rows else params,
                      cfg)


def _ffn_residual(block, cfg, x, ctx=None, dims=None, rows: bool = False):
    """(x + the block's FFN of its normed input, the MoE load-balance
    loss).  The FFN is the MLP, or the MoE on an MoE layer; the loss is
    0.0 on an MLP layer (the decode paths drop it, as the JAX package
    does).  ``dims``: the block's FSDP dims (:func:`_gathered`);
    ``rows``: ``x`` is a sequence-parallel rank's rows."""
    y = _norm(x, block["mlp_norm"], cfg, ctx, rows)
    if "moe" in block:
        y, loss = moe_ffn(block["moe"], cfg, y, ctx,
                          fsdp_dims=dims["moe"] if dims else None, rows=rows)
    else:
        y, loss = apply_mlp(y, block["mlp"], cfg, ctx, _mlp_width(cfg),
                            rows=rows), 0.0
    return x + y, loss


_EXPERTS = ("w_gate", "w_up", "w_down")


def _layer_dims(cfg, ctx):
    """Each layer's FSDP dims (``sharding.fsdp_dims`` of the placement
    specs; a shared block's at every use), or None a layer where no leaf
    is sharded over the data axis (no ctx, no FSDP, or a data axis of
    one rank)."""
    if ctx is None or not ctx.fsdp_axes or dp_size(ctx) == 1:
        return [None] * len(cfg.layer_pattern)
    from repro_torch.distributed import sharding
    par = sharding.parallelism_of(ctx)
    return _blocks(sharding.fsdp_dims(sharding.rank_specs(cfg, ctx.mesh,
                                                          par), par))


def _gathered(block, dims, ctx):
    """The block with its FSDP-sharded weights whole (``dims``: their
    FSDP dims; None: nothing to gather), but for the MoE's expert
    weights, which ``moe_ffn`` gathers where its branch needs them
    whole."""
    if dims is None:
        return block
    out = {}
    for k, v in block.items():
        if k == "moe":
            out[k] = {n: w if n in _EXPERTS else
                      fsdp_gather_tree(w, dims[k][n], ctx)
                      for n, w in v.items()}
        else:
            out[k] = fsdp_gather_tree(v, dims[k], ctx)
    return out


def _attn_block_full(block, cfg, x, positions, ctx=None, dims=None,
                     rows: bool = False):
    """Returns (x, the layer's cache entries, the MoE load-balance loss or
    0.0).  ``dims``: the block's FSDP dims, its shards gathered here.
    ``rows``: ``x`` is a sequence-parallel rank's rows (``positions``
    whole)."""
    block = _gathered(block, dims, ctx)
    xin = _norm(x, block["attn_norm"], cfg, ctx, rows)
    full = attn.mla_full if cfg.mla is not None else attn.gqa_full
    h, kv_out = full(block["attn"], cfg, xin, positions, ctx, rows=rows)
    x, loss = _ffn_residual(block, cfg, x + h, ctx, dims, rows)
    return x, kv_out, loss


def _default_positions(cfg, batch, seq, offset, device):
    pos = offset + torch.arange(seq, dtype=torch.int32, device=device)[None]
    pos = pos.expand(batch, seq)
    if cfg.mrope_sections:
        pos = pos[..., None].expand(batch, seq, 3)
    return pos


def _decode_positions(cfg, cache_pos, batch):
    pos = cache_pos[:, None]
    if cfg.mrope_sections:
        pos = pos[..., None].expand(batch, 1, 3)
    return pos


def _attn_block_decode(block, cfg, x, positions, layer_cache, cache_pos,
                       active=None):
    h, _ = (attn.mla_decode if cfg.mla is not None else attn.gqa_decode)(
        block["attn"], cfg, apply_norm(x, block["attn_norm"], cfg),
        positions, layer_cache, cache_pos, active=active)
    return _ffn_residual(block, cfg, x + h)[0]


def _ssm_block_full(block, cfg, x, layer_cache=None, ctx=None, dims=None):
    """Residual Mamba2 block from the cache's (conv, ssm) state when
    given (else zeros).  Returns (x, (conv, ssm)).  ``dims``: the block's
    FSDP dims, its shards gathered here."""
    block = _gathered(block, dims, ctx)
    conv = ssm = None
    if layer_cache is not None:
        conv, ssm = layer_cache["conv"].to(x.dtype), layer_cache["ssm"]
    h, state = ssm_mod.mamba2_full(block["mamba"], cfg,
                                   apply_norm(x, block["norm"], cfg),
                                   conv_state=conv, ssm_state=ssm)
    return x + h, state


def _remat_layer(block, cfg, x, positions, ctx, dims, rows):
    x, _, loss = _attn_block_full(block, cfg, x, positions, ctx, dims, rows)
    return x, loss


def _remat_ssm(block, cfg, x, ctx, dims):
    return _ssm_block_full(block, cfg, x, ctx=ctx, dims=dims)[0]


def forward_full(params, cfg: ModelConfig, *, tokens=None, embeds=None,
                 positions=None, cache=None, last_only: bool = False,
                 remat: bool = False, ctx=None, gather_logits: bool = True):
    """Train / prefill pass over a whole sequence. tokens: [B, S] ([B, S,
    K] with K codebooks), or ``embeds`` [B, S, d]; ``positions`` [B, S]
    ([B, S, 3] M-RoPE ids), by default 0..S-1.

    With ``cache`` (a dense cache of :func:`init_cache`), each layer's
    K/V (SSM layers: the final conv and recurrent state) are written
    into it in place and ``pos`` advances by S.
    ``last_only`` applies the LM head to the final position only.
    ``remat`` recomputes each layer in the backward pass instead of
    keeping its activations (``torch.utils.checkpoint``, the counterpart
    of the JAX ``jax.checkpoint`` per layer, SSM layers and the shared
    block included); it cannot write a cache.
    Returns (logits [B, S or 1, V] ([B, S or 1, K, V]), cache_or_None,
    aux) — ``aux`` is the
    MoE load-balance loss summed over the layers and divided by the
    number of attention layers, as in the JAX package (0.0 for models
    without MoE layers).  ``ctx``: run as one rank of a mesh (module
    docstring) on this data rank's rows of the batch; under FSDP the
    params are this rank's shards (``sharding.rank_specs``); under
    ``attn_sharding="auto"`` sequence-parallel between the blocks
    (module docstring).  ``gather_logits=False`` returns this rank's
    vocabulary slice of the logits where the tp axis splits the
    vocabulary."""
    if remat and cache is not None:
        raise ValueError("remat recomputes layers in the backward pass and "
                         "cannot write a cache")
    x = embeds if embeds is not None else embed_tokens(params, cfg,
                                                          tokens, ctx)
    b, s = x.shape[0], x.shape[1]
    if positions is None:
        positions = _default_positions(cfg, b, s, 0, x.device)
    dims_of = _layer_dims(cfg, ctx)
    # the residual as this rank's rows of the sequence between the
    # blocks, as the reference constrains it (not with SSM layers)
    rows = seq_parallel(ctx, s) and not cfg.ssm_layers
    if rows:
        x = seq_rows(x, ctx)
    aux_total = 0.0
    for i, (kind, block, dims) in enumerate(zip(cfg.layer_pattern,
                                                _blocks(params), dims_of)):
        if kind == SSM and remat:
            x = checkpoint(_remat_ssm, block, cfg, x, ctx, dims,
                           use_reentrant=False)
            continue
        if kind == SSM:
            x, state = _ssm_block_full(block, cfg, x, ctx=ctx, dims=dims)
            if cache is not None:
                write_prefill(cache, i, state, cfg)
            continue
        if remat:
            x, aux = checkpoint(_remat_layer, block, cfg, x, positions, ctx,
                                dims, rows, use_reentrant=False)
        else:
            x, kv_out, aux = _attn_block_full(block, cfg, x, positions, ctx,
                                              dims, rows)
            if cache is not None:
                write_prefill(cache, i, kv_out, cfg)
        aux_total = aux_total + aux
    if rows:
        # the rows back together: the last position lives on the last
        # rank, and the head and the loss run as without "auto"
        x = tp_all_gather(x, ctx, dim=1)
    if last_only:
        x = x[:, -1:]
    x = apply_norm(x, params["final_norm"], cfg)
    logits = lm_head(params, cfg, x, ctx, gather=gather_logits)
    if cache is not None:
        cache["pos"] += s
    return logits, cache, aux_total / max(1, len(cfg.attn_layers))


def forward_decode(params, cfg: ModelConfig, *, tokens=None, embeds=None,
                   positions=None, cache, active=None):
    """One-token decode step for every slot of a dense cache.
    tokens: [B, 1] ([B, 1, K] with K codebooks), or ``embeds`` [B, 1, d];
    ``positions`` [B, 1] ([B, 1, 3]), by default each slot's ``pos``.

    New K/V are ring-written in place; ``active`` ([B] bool, optional)
    limits the writes to those slots, so an inactive slot's rows keep
    their values (SSM layers: their conv and recurrent state, as the
    JAX engine's ``where`` freeze keeps them).  Returns (logits [B, 1,
    V], new_cache) where ``new_cache`` shares the layer tensors and
    carries ``pos + 1`` for every slot (the engine keeps the old ``pos``
    of inactive slots, as the JAX engine does)."""
    x = embeds if embeds is not None else embed_tokens(params, cfg,
                                                          tokens)
    b = x.shape[0]
    cache_pos = cache["pos"]
    if positions is None:
        positions = _decode_positions(cfg, cache_pos, b)
    for kind, block, layer_cache in zip(cfg.layer_pattern, _blocks(params),
                                        cache["layers"]):
        if kind == SSM:
            x = _ssm_block_decode(block, cfg, x, layer_cache, active)
            continue
        x = _attn_block_decode(block, cfg, x, positions, layer_cache,
                               cache_pos, active)
    x = apply_norm(x, params["final_norm"], cfg)
    return lm_head(params, cfg, x), {"pos": cache_pos + 1,
                                     "layers": cache["layers"]}


def _ssm_block_decode(block, cfg, x, layer_cache, active):
    """Residual Mamba2 decode step; the new conv and recurrent state are
    written in place, for the ``active`` slots only when given."""
    h, conv, st = ssm_mod.mamba2_decode(block["mamba"], cfg,
                                        apply_norm(x, block["norm"], cfg),
                                        layer_cache["conv"],
                                        layer_cache["ssm"])
    for name, new in (("conv", conv), ("ssm", st)):
        old = layer_cache[name]
        if active is not None:
            new = torch.where(active.reshape((-1,) + (1,) * (new.dim() - 1)),
                              new.to(old.dtype), old)
        old.copy_(new)
    return x + h


def _refuse_mla_chunk(cfg):
    if cfg.mla is not None:
        raise NotImplementedError(f"{cfg.name}: chunked prefill has no MLA "
                                  "path (nor has the JAX package's)")


def forward_chunk(params, cfg: ModelConfig, *, tokens=None, embeds=None,
                  cache):
    """Chunked-prefill step (Sarathi-style): a chunk of C tokens against
    a dense cache already holding ``cache["pos"]`` tokens (uniform across
    the batch).  The chunk's K/V are ring-written in place (SSM layers:
    the chunk runs from the cache's conv and recurrent state, which it
    replaces) and ``pos`` advances by C.  Returns (logits of the chunk's
    last position [B,1,V], cache)."""
    _refuse_mla_chunk(cfg)
    x = embeds if embeds is not None else embed_tokens(params, cfg,
                                                          tokens)
    b, c = x.shape[0], x.shape[1]
    pos0 = cache["pos"][0].clone()
    positions = (pos0 + torch.arange(c, device=x.device,
                                     dtype=torch.int32))[None].expand(b, c)
    if cfg.mrope_sections:
        positions = positions[..., None].expand(b, c, 3)
    for i, (kind, block, layer_cache) in enumerate(zip(
            cfg.layer_pattern, _blocks(params), cache["layers"])):
        if kind == SSM:
            x, state = _ssm_block_full(block, cfg, x, layer_cache)
            write_prefill(cache, i, state, cfg)
            continue
        xin = apply_norm(x, block["attn_norm"], cfg)
        h, _ = attn.gqa_continue(block["attn"], cfg, xin, positions,
                                 layer_cache, pos0)
        x = _ffn_residual(block, cfg, x + h)[0]
    x = apply_norm(x[:, -1:], params["final_norm"], cfg)
    logits = lm_head(params, cfg, x)
    cache["pos"] += c
    return logits, cache


def forward_decode_paged(params, cfg: ModelConfig, *, tokens=None,
                         embeds=None, positions=None, cache, active=None,
                         ctx=None):
    """One-token decode step for every slot. tokens: [B, 1].

    New K/V are written in place into the pages (an inactive slot's
    table points at the null page, or its write lands at its frontier,
    which its next chunk overwrites); an SSM layer's per-slot conv and
    recurrent state are written in place, for the ``active`` slots only
    when given ([B] bool: the JAX engine's ``where`` freeze).  Returns
    (logits [B, 1, V], new_cache) where ``new_cache`` shares the page
    tensors and carries ``pos + 1`` for every slot (the engine keeps the
    old ``pos`` of inactive slots, as the JAX engine does).  ``ctx``: one
    rank of a mesh (module docstring)."""
    x = embeds if embeds is not None else embed_tokens(params, cfg,
                                                          tokens, ctx)
    b = x.shape[0]
    cache_pos = cache["pos"]
    block_tables = cache["block_tables"]
    if positions is None:
        positions = _decode_positions(cfg, cache_pos, b)
    for kind, block, layer_cache, dims in zip(
            cfg.layer_pattern, _blocks(params), cache["layers"],
            _layer_dims(cfg, ctx)):
        block = _gathered(block, dims, ctx)
        if kind == SSM:
            x = _ssm_block_decode(block, cfg, x, layer_cache, active)
            continue
        xin = apply_norm(x, block["attn_norm"], cfg)
        if cfg.mla is not None:
            h, _ = attn.mla_decode_paged(block["attn"], cfg, xin, positions,
                                         layer_cache, block_tables,
                                         cache_pos, ctx)
        else:
            h, _ = attn.gqa_decode_paged(block["attn"], cfg, xin, positions,
                                         layer_cache, block_tables,
                                         cache_pos, ctx)
        x = _ffn_residual(block, cfg, x + h, ctx, dims)[0]
    x = apply_norm(x, params["final_norm"], cfg)
    return lm_head(params, cfg, x, ctx), {"pos": cache_pos + 1,
                                     "block_tables": block_tables,
                                     "layers": cache["layers"]}


def forward_prefill_paged(params, cfg: ModelConfig, *, tokens=None,
                          embeds=None, positions=None, cache, slot: int = 0,
                          length: Optional[int] = None, ctx=None):
    """Whole-prompt prefill of ONE request written in place into
    ``slot``'s pages (an O(prompt) scatter per layer through the slot's
    block table; padded positions land on the null page).  An SSM layer
    runs from zero state over all ``Lpad`` rows (the engine prefills SSM
    archs at exact length) and writes its final state into the slot.

    tokens: [1, Lpad]; ``length``: actual prompt length; ``ctx``: one
    rank of a mesh.  Returns (last-token logits [V], cache)."""
    x = embeds if embeds is not None else embed_tokens(params, cfg,
                                                          tokens, ctx)
    b, s = x.shape[0], x.shape[1]
    if length is None:
        length = s
    if positions is None:
        positions = _default_positions(cfg, b, s, 0, x.device)
    for i, (kind, block, dims) in enumerate(zip(
            cfg.layer_pattern, _blocks(params), _layer_dims(cfg, ctx))):
        if kind == SSM:
            x, kv_out = _ssm_block_full(block, cfg, x, ctx=ctx, dims=dims)
        else:
            x, kv_out, _ = _attn_block_full(block, cfg, x, positions, ctx,
                                            dims)
        write_prefill_paged(cache, i, kv_out, cfg, slot, length)
    x = apply_norm(x[:, length - 1:length], params["final_norm"], cfg)
    logits = lm_head(params, cfg, x, ctx)
    cache["pos"][slot] = length
    return logits[0, 0], cache


def forward_chunk_paged(params, cfg: ModelConfig, *, tokens=None,
                        embeds=None, cache, slot: int = 0,
                        length: Optional[int] = None, ctx=None):
    """Chunked-prefill step for ONE slot against the paged pool
    (Sarathi-style): the chunk attends to the slot's gathered pages plus
    itself, then is scattered into its pages in place.

    The chunk starts at ``cache["pos"][slot]``, which need not be 0: a
    request aliasing a cached prefix presets ``pos`` to the cached length
    and prefills only its unique suffix here.  tokens: [1, C];
    ``length`` (default C) is the number of valid rows of a padded pow-2
    bucket — padded rows are never written to pages and never attended
    by valid queries.  An SSM layer runs all C rows, padded ones
    included, from the slot's own conv and recurrent state and writes
    the result back into the slot, as the JAX package does.  ``ctx``:
    one rank of a mesh.  Returns (valid-final logits [1,1,V], cache)."""
    _refuse_mla_chunk(cfg)
    x = embeds if embeds is not None else embed_tokens(params, cfg,
                                                          tokens, ctx)
    b, c = x.shape[0], x.shape[1]
    if length is None:
        length = c
    pos0 = cache["pos"][slot].clone()      # the chunk's first position
    bt = cache["block_tables"][slot:slot + 1]
    positions = (pos0 + torch.arange(c, device=x.device,
                                     dtype=torch.int32))[None].expand(b, c)
    if cfg.mrope_sections:
        positions = positions[..., None].expand(b, c, 3)
    for i, (kind, block, layer_cache, dims) in enumerate(zip(
            cfg.layer_pattern, _blocks(params), cache["layers"],
            _layer_dims(cfg, ctx))):
        block = _gathered(block, dims, ctx)
        if kind == SSM:
            x, state = _ssm_block_full(block, cfg, x, {
                name: layer_cache[name][slot:slot + 1]
                for name in ("conv", "ssm")})
            write_prefill_paged(cache, i, state, cfg, slot, length)
            continue
        xin = apply_norm(x, block["attn_norm"], cfg)
        h, _ = attn.gqa_continue_paged(block["attn"], cfg, xin, positions,
                                       layer_cache, bt, pos0, n=length,
                                       ctx=ctx)
        x = _ffn_residual(block, cfg, x + h, ctx, dims)[0]
    x = apply_norm(x[:, length - 1:length], params["final_norm"], cfg)
    logits = lm_head(params, cfg, x, ctx)
    cache["pos"][slot] += length
    return logits, cache
