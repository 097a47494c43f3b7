"""Decode caches, dense and block-paged (``src/repro/models/cache.py``):
GQA K/V, and the recurrent state of Mamba2 (SSM) layers.

A cache is a plain dict of tensors.  Two layouts:

* **dense** (``init_cache``): one contiguous ``[B, L, kv, hd]`` buffer
  per layer, a ring of ``L`` slots (token ``t`` lives at slot ``t % L``)
  priced by worst-case length per slot::

    {"pos": [B] int32, "layers": [{"k": [B, L, kv, hd], "v": ...}, ...]}

  An SSM layer holds ``{"conv": [B, d_conv-1, d_inner + 2 ds], "ssm":
  [B, nh, hd, ds]}`` (the conv state in the cache dtype, the recurrent
  state float32): O(1) in sequence length, so there is no ring.

* **paged** (``init_paged_cache``): one shared pool of ``N`` pages of
  ``P`` tokens per layer plus per-slot block tables, priced by live
  tokens (vLLM-style PagedAttention)::

    {"pos": [B] int32, "block_tables": [B, pages_per_slot] int32,
     "layers": [{"k": [N, P, kv, hd], "v": [N, P, kv, hd]}, ...]}

  Block 0 is a reserved **null page**: unallocated table entries point
  at it and padded prefill rows scatter into it, so every gather and
  scatter stays in bounds without host-side masking.

Either layout may be **int8** (``quantized=True``): ``k``/``v`` hold int8
values and each layer adds ``k_scale``/``v_scale`` ``[..., kv, 1]``
bf16, one scale per (token, kv head) (:func:`quantize_kv`).

Where the JAX package donates the cache to a jitted step and gets an
updated copy back, the port writes **in place** (O(tokens) scatters);
the functions below mutate and return the same tensors.  SSM layers
live in the dense layout only (an attention-free arch never takes the
paged pool, as in the JAX engine); MLA latents, MoE and hybrid stacks
wait for later slices (ROADMAP.md M9/M10).
"""
from __future__ import annotations

import torch

from repro_torch.device import torch_dtype
from repro_torch.models.config import ATTN, SSM, ModelConfig

NULL_PAGE = 0           # reserved block: scatter/gather target for dead slots


def cache_len(cfg: ModelConfig, max_len: int) -> int:
    """Per-layer KV length: sliding-window archs only keep the window."""
    if cfg.sliding_window:
        return min(max_len, cfg.sliding_window)
    return max_len


def paged_slot_len(cfg: ModelConfig, max_len: int, block_size: int,
                   window: int = 0) -> int:
    """Logical per-slot ring length, rounded up to whole blocks."""
    L = cache_len(cfg, max_len)
    if window:
        L = min(L, window)
    return -(-L // block_size) * block_size


def require_ported(cfg: ModelConfig, paged: bool = False):
    """Raise ``NotImplementedError`` unless the port runs ``cfg`` on the
    given layout: dense GQA decoders on either, attention-free Mamba2
    (SSM) stacks on the dense layout only."""
    if cfg.mla is not None or cfg.moe is not None:
        raise NotImplementedError(f"{cfg.name}: MLA and MoE are not ported "
                                  "(ROADMAP.md M9)")
    kinds = set(cfg.layer_pattern)
    if kinds == {SSM}:
        if paged:
            raise NotImplementedError(
                f"{cfg.name}: SSM state lives in the dense layout only; "
                "the paged pool holds attention K/V (ROADMAP.md M10)")
    elif kinds != {ATTN}:
        raise NotImplementedError(
            f"{cfg.name}: hybrid SSM + attention stacks are not ported "
            "(ROADMAP.md M10)")


def _kv_layer(lead, kv: int, hd: int, dtype, quantized: bool, device):
    """One attention layer's zeroed K/V buffers of shape ``lead + (kv,
    hd)`` (int8 values plus bf16 per-(token, head) scales when
    ``quantized``)."""
    if quantized:
        return {
            "k": torch.zeros(lead + (kv, hd), dtype=torch.int8,
                             device=device),
            "v": torch.zeros(lead + (kv, hd), dtype=torch.int8,
                             device=device),
            "k_scale": torch.zeros(lead + (kv, 1), dtype=torch.bfloat16,
                                   device=device),
            "v_scale": torch.zeros(lead + (kv, 1), dtype=torch.bfloat16,
                                   device=device)}
    return {"k": torch.zeros(lead + (kv, hd), dtype=dtype, device=device),
            "v": torch.zeros(lead + (kv, hd), dtype=dtype, device=device)}


def _ssm_layer(cfg: ModelConfig, batch: int, dtype, device):
    """One SSM layer's zeroed conv state (``dtype``) and float32
    recurrent state."""
    s = cfg.ssm
    di = s.d_inner(cfg.d_model)
    return {"conv": torch.zeros((batch, s.d_conv - 1, di + 2 * s.d_state),
                                dtype=dtype, device=device),
            "ssm": torch.zeros((batch, s.n_heads(cfg.d_model), s.head_dim,
                                s.d_state), dtype=torch.float32,
                               device=device)}


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None,
               window: int = 0, quantized: bool = False, *,
               device: torch.device):
    """Dense per-slot KV rings of length ``cache_len`` (capped by
    ``window`` when > 0), zeroed on ``device``.  ``quantized``: int8 KV
    with per-(token, head) bf16 scales.  SSM layers get their conv and
    recurrent state (``window`` and ``quantized`` do not apply)."""
    require_ported(cfg)
    dtype = torch_dtype(cfg.dtype if dtype is None else dtype)
    L = cache_len(cfg, max_len)
    if window:
        L = min(L, window)
    layers = [_ssm_layer(cfg, batch, dtype, device) if kind == SSM else
              _kv_layer((batch, L), cfg.num_kv_heads, cfg.head_dim, dtype,
                        quantized, device) for kind in cfg.layer_pattern]
    return {"pos": torch.zeros(batch, dtype=torch.int32, device=device),
            "layers": layers}


def quantize_kv(x):
    """x: [..., hd] -> (int8 values, bf16 scale [..., 1]).  The scale is
    computed in float32 and the values rounded half to even against it;
    only the stored scale is rounded to bf16 (bit-exact with the JAX
    package's ``quantize_kv``)."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp(amax / 127.0, min=1e-8)
    q = torch.clamp(torch.round(xf / scale), -127, 127)
    return q.to(torch.int8), scale.to(torch.bfloat16)


def dequantize_kv(q, scale, dtype=torch.bfloat16):
    """int8 values x bf16 scale in ``dtype``.  The default bf16 is the
    JAX package's ``dequantize_kv`` bit for bit (the exact product
    rounded to bf16).  Attention dequantizes in its compute dtype: under
    ``jit`` XLA keeps the product in float32 when the consumer is
    float32 (excess precision), and the TPU and CUDA kernels multiply in
    float32; in float32 the product is exact."""
    return q.to(dtype) * scale.to(dtype)


def _ring_write(buf, vals):
    """Write a prefilled sequence into a ring buffer of length L in
    place, keeping the ring invariant ``token t lives at slot t % L``.

    buf: [B, L, ...]; vals: [B, S, ...] (tokens 0..S-1).  With S < L the
    rows past S keep their values."""
    L = buf.shape[1]
    s = vals.shape[1]
    vals = vals.to(buf.dtype)
    if s < L:
        buf[:, :s] = vals
    else:
        buf.copy_(torch.roll(vals[:, s - L:], shifts=s % L, dims=1))
    return buf


def write_prefill(cache, layer_idx: int, kv_tuple, cfg: ModelConfig):
    """Write full-sequence K/V ([B, S, kv, hd] each) produced by a
    prefill pass into the dense cache at positions [0, S), in place
    (quantized with fresh per-token scales for int8 caches); for an SSM
    layer, its final (conv, ssm) state."""
    layer = cache["layers"][layer_idx]
    if "ssm" in layer:
        conv, ssm = kv_tuple
        layer["conv"].copy_(conv)
        layer["ssm"].copy_(ssm)
        return cache
    k, v = kv_tuple
    if "k_scale" in layer:
        kq, ks = quantize_kv(k)
        vq, vs = quantize_kv(v)
        for name, val in (("k", kq), ("v", vq), ("k_scale", ks),
                          ("v_scale", vs)):
            _ring_write(layer[name], val)
    else:
        _ring_write(layer["k"], k)
        _ring_write(layer["v"], v)
    return cache


def init_paged_cache(cfg: ModelConfig, max_slots: int, max_len: int,
                     num_blocks: int, block_size: int = 16, dtype=None,
                     window: int = 0, quantized: bool = False, *,
                     device: torch.device):
    """Block-paged KV pool shared by ``max_slots`` request slots, zeroed
    on ``device`` (int8 pages with bf16 scale pages when
    ``quantized``).  Attention-only archs: SSM state has no pages."""
    require_ported(cfg, paged=True)
    dtype = torch_dtype(cfg.dtype if dtype is None else dtype)
    if num_blocks < 2:
        raise ValueError("num_blocks must be >= 2 (block 0 is the null page)")
    P = block_size
    layers = [_kv_layer((num_blocks, P), cfg.num_kv_heads, cfg.head_dim,
                        dtype, quantized, device)
              for _ in cfg.layer_pattern]
    pages_per_slot = paged_slot_len(cfg, max_len, P, window) // P
    return {"pos": torch.zeros(max_slots, dtype=torch.int32, device=device),
            "block_tables": torch.zeros((max_slots, pages_per_slot),
                                        dtype=torch.int32, device=device),
            "layers": layers}


def paged_token_write(pages, vals, page_ids, offs):
    """Scatter one token per sequence into the pool, in place.

    pages: [N, P, ...]; vals: [B, ...]; page_ids/offs: [B].  O(B) —
    independent of pool size.  Dead slots all write the null page;
    those duplicate writes are harmless (never read as valid)."""
    pages[page_ids.long(), offs.long()] = vals.to(pages.dtype)
    return pages


def paged_prefill_write(pages, vals, block_table, n, start=0):
    """Scatter a prefilled span of ONE slot into its pages, in place.

    pages: [N, P, ...]; vals: [S, ...] (first ``n`` rows valid — the rest
    are padding); block_table: [pages_per_slot]; positions are
    ``start .. start+S-1`` on the slot's logical ring of length
    ``pages_per_slot * P``.  Padding rows and ring-evicted rows (when the
    span wraps) go to the null page, so valid rows never collide.
    ``start``/``n`` may be ints or 0-d tensors on the pool's device."""
    S = vals.shape[0]
    P = pages.shape[1]
    L = block_table.shape[0] * P
    p = start + torch.arange(S, device=pages.device)
    end = start + n
    keep = (p < end) & (p >= end - L)
    widx = torch.remainder(p, L)
    page_ids = torch.where(keep, block_table.long()[widx // P], NULL_PAGE)
    pages[page_ids, torch.remainder(widx, P)] = vals.to(pages.dtype)
    return pages


def write_prefill_paged(cache, layer_idx: int, kv_tuple, cfg: ModelConfig,
                        slot, n):
    """Write one request's prefill K/V ([1, S, kv, hd] each, S >= n) into
    ``slot``'s pages at positions [0, n), in place (quantized with fresh
    per-token scales for int8 pages)."""
    layer = cache["layers"][layer_idx]
    bt = cache["block_tables"][slot]
    k, v = kv_tuple
    if "k_scale" in layer:
        kq, ks = quantize_kv(k)
        vq, vs = quantize_kv(v)
        for name, val in (("k", kq), ("v", vq), ("k_scale", ks),
                          ("v_scale", vs)):
            paged_prefill_write(layer[name], val[0], bt, n)
    else:
        paged_prefill_write(layer["k"], k[0], bt, n)
        paged_prefill_write(layer["v"], v[0], bt, n)
    return cache


def copy_page(cache, src: int, dst: int):
    """Copy one KV page (and its scale page, for int8 pools) across every
    layer, in place: the device half of copy-on-write (the engine
    allocates ``dst`` and patches the table)."""
    for layer in cache["layers"]:
        for pages in layer.values():
            pages[dst].copy_(pages[src])
    return cache


def gather_pages(pages, block_tables):
    """Materialize the logical [B, L, ...] view of a paged layer.

    pages: [N, P, ...]; block_tables: [B, pages_per_slot]."""
    b, npg = block_tables.shape
    g = pages[block_tables.long()]              # [B, pages, P, ...]
    return g.reshape((b, npg * pages.shape[1]) + tuple(pages.shape[2:]))


def kv_bytes_per_token(cfg: ModelConfig, dtype=None,
                       quantized: bool = False) -> int:
    """Device bytes of KV (or MLA latent) cache per token, across layers.
    SSM layers contribute 0 (their state is O(1) in sequence length)."""
    size = torch_dtype(cfg.dtype if dtype is None else dtype).itemsize
    total = 0
    for kind in cfg.layer_pattern:
        if kind != ATTN:
            continue
        if cfg.mla is not None:
            total += (cfg.mla.kv_lora_rank + cfg.mla.qk_rope_head_dim) * size
        elif quantized:
            # int8 values + one bf16 scale per (token, head) for k and v
            total += 2 * cfg.num_kv_heads * (cfg.head_dim * 1 + 2)
        else:
            total += 2 * cfg.num_kv_heads * cfg.head_dim * size
    return total
