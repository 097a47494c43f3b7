"""Partition rules for params, inputs and caches (counterpart of
``src/repro/distributed/sharding.py``), and each rank's slice of them.

Mesh axes:
  * ``model`` (tp) — shards attention heads, FFN width, experts, vocab.
  * ``data`` / ``pod`` (dp) — shard the batch; in FSDP mode they also
    shard the non-tp dimension of every large weight.

A spec is a :class:`P`: one entry per dim, an axis name, a tuple of axis
names, or None (replicated), as a JAX ``PartitionSpec`` holds them (a
one-name tuple is stored as the name).  :func:`param_specs`,
:func:`cache_specs` and :func:`_paged_cache_specs` are the JAX package's
rules, rule by rule, including the dims where :func:`_div` fails and the
dim stays whole; they read only shapes, so callers build them from
``device="meta"`` tensors and nothing is allocated.

Where the port executes, one process per rank, it holds whole heads,
whole experts or whole pages in a few places where the rules split a
dim that GSPMD can partition but per-rank code cannot
(:func:`placement_specs`): the result equals the reference's, the
bytes a rank holds differ.  :func:`shard_params` then cuts each leaf to
this rank's slice.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Tuple

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import heads_split
from repro_torch.models.moe import ShardingCtx


class P(tuple):
    """A partition spec: one entry per dim (axis name, tuple of axis
    names, or None).  Entries are normalized as in a JAX
    ``PartitionSpec``: a one-name tuple is the name."""

    def __new__(cls, *entries):
        norm = tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else
                     (tuple(e) if isinstance(e, list) else e)
                     for e in entries)
        return super().__new__(cls, norm)

    def __repr__(self):
        return "P(" + ", ".join(map(repr, self)) + ")"


@dataclasses.dataclass(frozen=True)
class ParallelismConfig:
    tp_axis: str = "model"
    dp_axes: Tuple[str, ...] = ("data",)     # ("pod","data") multi-pod
    fsdp: bool = True                         # shard weights over dp too
    # shard the KV-cache sequence dim over tp when heads cannot shard
    seq_sharded_cache: bool = True
    # MoE expert-parallel reduction instead of weight gathering
    expert_parallel: bool = False
    # "auto": sequence-parallel attention activations
    attn_sharding: str = "none"

    @property
    def fsdp_spec(self):
        return self.dp_axes if self.fsdp else None


def _axes(axes):
    return (axes,) if isinstance(axes, str) else tuple(axes)


def _div(n: int, mesh, axes) -> bool:
    """Is n divisible by the product of the named mesh axes?"""
    if axes is None:
        return False
    size = math.prod(mesh.shape[a] for a in _axes(axes))
    return n % size == 0 and n >= size


def _pspec(shape, mesh, par, *wants) -> P:
    """A spec assigning wants[i] to dim i when divisible."""
    return P(*(want if want is not None and _div(dim, mesh, want) else None
               for dim, want in zip(shape, wants)))


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts and lists (and the matching
    leaves of ``rest``), keeping the structure.  A :class:`P` is a
    leaf."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, list) or (isinstance(tree, tuple)
                                  and not isinstance(tree, P)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def _replicated(tree):
    return tree_map(lambda a: P(), tree)


def param_specs(params, cfg: ModelConfig, mesh, par: ParallelismConfig):
    """Spec tree matching the params structure (leaves need ``.shape``
    and ``.ndim`` only: meta tensors do)."""
    tp = par.tp_axis
    fs = par.fsdp_spec

    def mlp(block):
        return {n: _pspec(w.shape, mesh, par,
                          *((fs, tp) if n != "w_down" else (tp, fs)))
                for n, w in block.items()}

    def attn_block(block):
        out = {}
        for k, v in block.items():
            if k in ("attn_norm", "mlp_norm"):
                out[k] = _replicated(v)
            elif k == "attn":
                out[k] = {}
                for name, w in v.items():
                    if name in ("wq", "wk", "wv"):
                        out[k][name] = _pspec(w.shape, mesh, par, fs, tp)
                    elif name == "wo":
                        out[k][name] = _pspec(w.shape, mesh, par, tp, fs)
                    elif name in ("w_dkv", "w_krope"):
                        out[k][name] = _pspec(w.shape, mesh, par, fs, None)
                    elif name in ("w_uk", "w_uv"):
                        out[k][name] = _pspec(w.shape, mesh, par, None, tp)
                    else:               # q_norm, k_norm, kv_norm
                        out[k][name] = P()
            elif k == "mlp":
                out[k] = mlp(v)
            elif k == "moe":
                out[k] = {}
                for n, w in v.items():
                    if n == "router":
                        out[k][n] = _pspec(w.shape, mesh, par, fs, None)
                    elif n == "shared":
                        out[k][n] = mlp(w)
                    elif n == "w_down":   # [E, F, D]
                        out[k][n] = _pspec(w.shape, mesh, par, tp, fs, None)
                    else:                 # w_gate / w_up [E, D, F]
                        out[k][n] = _pspec(w.shape, mesh, par, tp, None, fs)
            else:
                out[k] = _replicated(v)
        return out

    def ssm_block(block):
        out = {"norm": _replicated(block["norm"]), "mamba": {}}
        for n, w in block["mamba"].items():
            out["mamba"][n] = _pspec(w.shape, mesh, par, fs, None) \
                if w.ndim == 2 else P()
        return out

    specs = {}
    emb = params["embed"]
    # embeddings shard on the vocab dim only, never FSDP on d_model
    if emb.ndim == 3:      # audio [K, V, D]
        specs["embed"] = _pspec(emb.shape, mesh, par, None, tp, None)
    else:
        specs["embed"] = _pspec(emb.shape, mesh, par, tp, None)
    if "lm_head" in params:
        lh = params["lm_head"]
        if lh.ndim == 3:
            specs["lm_head"] = _pspec(lh.shape, mesh, par, None, None, tp)
        else:
            specs["lm_head"] = _pspec(lh.shape, mesh, par, None, tp)
    specs["final_norm"] = _replicated(params["final_norm"])
    if "shared_block" in params:
        specs["shared_block"] = attn_block(params["shared_block"])
    specs["layers"] = []
    for layer in params["layers"]:
        if not layer:
            specs["layers"].append({})
        elif "mamba" in layer:
            specs["layers"].append(ssm_block(layer))
        else:
            specs["layers"].append(attn_block(layer))
    return specs


def cache_specs(cache_shapes, cfg: ModelConfig, mesh,
                par: ParallelismConfig, batch: int):
    """Spec tree for a decode cache (from shapes: meta tensors).

    Handles both layouts: dense per-slot ``[B, L, kv, hd]`` caches, and
    block-paged pools (``block_tables`` present): page arrays ``[N, P,
    kv, hd]`` shard on the kv-head axis when the head count divides the
    tp axis; ``pos`` and ``block_tables`` stay replicated, so the
    host-side block pool, prefix reuse and copy-on-write never see a
    sharded array."""
    if "block_tables" in cache_shapes:
        return _paged_cache_specs(cache_shapes, mesh, par)
    tp = par.tp_axis
    bspec = par.dp_axes if _div(batch, mesh, par.dp_axes) else None

    def layer_spec(layer):
        out = {}
        for k, v in layer.items():
            if k in ("k", "v", "k_scale", "v_scale"):  # [B, L, kv, hd|1]
                # prefer kv-head sharding; fall back to sequence sharding
                hspec = tp if _div(v.shape[2], mesh, tp) else None
                seq = tp if (hspec is None and par.seq_sharded_cache and
                             _div(v.shape[1], mesh, tp)) else None
                out[k] = P(bspec, seq, hspec, None)
            elif k in ("ckv", "kpe"):  # [B, L, rank]
                seq = tp if (par.seq_sharded_cache and
                             _div(v.shape[1], mesh, tp)) else None
                out[k] = P(bspec, seq, None)
            elif k == "conv":          # [B, K-1, C]
                out[k] = P(bspec, None, None)
            elif k == "ssm":           # [B, nh, hd, ds]
                out[k] = P(bspec, None, None, None)
        return out

    return {"pos": P(bspec),
            "layers": [layer_spec(lyr) for lyr in cache_shapes["layers"]]}


def _paged_cache_specs(cache_shapes, mesh, par: ParallelismConfig):
    """Specs of the block-paged pool: dim 2 of ``[num_blocks,
    block_size, kv, hd]`` (and of the int8 scale pages) shards on the tp
    axis when the kv heads divide it, so each rank holds whole kv heads;
    latent pages, per-slot SSM state, ``pos`` and ``block_tables`` stay
    replicated."""
    tp = par.tp_axis

    def layer_spec(layer):
        out = {}
        for k, v in layer.items():
            if k in ("k", "v", "k_scale", "v_scale"):   # [N, P, kv, hd|1]
                hspec = tp if _div(v.shape[2], mesh, tp) else None
                out[k] = P(None, None, hspec, None)
            elif k in ("ckv", "kpe"):      # [N, P, rank]
                out[k] = P(None, None, None)
            elif k == "conv":              # [max_slots, K-1, C]
                out[k] = P(None, None, None)
            elif k == "ssm":               # [max_slots, nh, hd, ds]
                out[k] = P(None, None, None, None)
        return out

    return {"pos": P(None),
            "block_tables": P(None, None),
            "layers": [layer_spec(lyr) for lyr in cache_shapes["layers"]]}


def input_sharding(cfg: ModelConfig, mesh, par: ParallelismConfig,
                   batch: int):
    """The spec entry of a batch dim: the data axes where they divide
    ``batch``, else None (whole on every rank)."""
    return par.dp_axes if _div(batch, mesh, par.dp_axes) else None


def make_ctx(mesh, par: ParallelismConfig) -> ShardingCtx:
    return ShardingCtx(mesh=mesh, dp_axes=par.dp_axes, tp_axis=par.tp_axis,
                       expert_parallel=par.expert_parallel,
                       attn_sharding=par.attn_sharding,
                       fsdp_axes=par.dp_axes if par.fsdp else ())


# ------------------------------------------------------ per-rank slices
def placement_specs(specs, cfg: ModelConfig, mesh, par: ParallelismConfig):
    """The specs a rank holds its params by: :func:`param_specs` with
    three departures, each giving the reference's result.

    * Attention: where the kv heads do not divide the tp axis the rules
      may still split ``wk``'s columns (qwen3-1.7b's 8 kv heads at tp 16 cut
      each head in two), which GSPMD partitions and per-rank code cannot;
      the page arrays replicate there (:func:`_paged_cache_specs`).  The
      rank then holds the whole projections (``wq``, ``wk``, ``wv``,
      ``wo``) and the block runs replicated on every rank: splitting the
      q heads alone would leave each rank a few kv heads inside whole
      pages, which the paged kernels take only as a contiguous pool (a
      copy of it a layer).  Where both head counts divide, the rules
      already split whole heads.  MLA likewise: where its heads divide
      the tp axis the rules split ``wq``'s, ``w_uk``'s and ``w_uv``'s
      columns and ``wo``'s rows by whole heads and keep the latent's
      weights (``w_dkv``, ``w_krope``, ``kv_norm``) whole; where they do
      not, the rules may still cut ``h * (nope + rope)`` columns
      mid-head, and the block runs replicated.  A hybrid's
      ``shared_block`` is placed as any GQA block; its SSM blocks are
      FSDP-only in the rules, so whole on every rank without FSDP.
    * Sequence-parallel attention (``par.attn_sharding == "auto"``):
      each rank computes every GQA head for its rows of the sequence,
      so the GQA projections (``wq``, ``wk``, ``wv``, ``wo``, the
      qk-norm scales; a hybrid's ``shared_block`` too) are whole over
      tp on every rank, and their gradients are summed over tp (they
      enter the rows through ``layers.tp_enter``).  The reference's
      rules still split their columns here and GSPMD moves them to the
      rows' ranks.  MLA, which the reference keeps off the sequence
      path, is placed as without ``"auto"``.
    * MoE without expert parallelism: the reference's ``shard_map``
      gathers every expert to every device at each call (``in_specs``
      ``P()``); each rank holds them whole over tp instead, gathered once.

    Each departure drops only the tp entry of a spec: under FSDP the
    data axis still shards the leaf (``fsdp_gather`` puts it together in
    each layer)."""
    tp = mesh.shape[par.tp_axis]
    whole_attn = not heads_split(cfg, tp) or \
        (par.attn_sharding == "auto" and cfg.mla is None)
    ep = cfg.moe is not None and par.expert_parallel \
        and cfg.moe.num_experts % tp == 0
    whole = lambda s: _drop_axis(s, par.tp_axis)

    def block(spec):
        out = dict(spec)
        if whole_attn and "attn" in spec:
            out["attn"] = tree_map(whole, spec["attn"])
        if "moe" in spec and not ep:
            out["moe"] = dict(spec["moe"])
            for n in ("w_gate", "w_up", "w_down"):
                out["moe"][n] = whole(spec["moe"][n])
        return out

    out = dict(specs)
    out["layers"] = [block(s) if s else {} for s in specs["layers"]]
    if "shared_block" in specs:
        out["shared_block"] = block(specs["shared_block"])
    return out


def _drop_axis(spec, axis: str) -> P:
    """``spec`` with ``axis`` taken out of every entry."""
    out = []
    for e in spec:
        names = tuple(a for a in (_axes(e) if e is not None else ())
                      if a != axis)
        out.append(names or None)
    return P(*out)


def _slice(spec, mesh, dim_index):
    """(parts, index) of a dim under ``spec[dim_index]`` on this rank."""
    want = spec[dim_index] if dim_index < len(spec) else None
    if want is None:
        return 1, 0
    parts, idx = 1, 0
    for a in _axes(want):
        parts *= mesh.shape[a]
        idx = idx * mesh.shape[a] + mesh.coords[a] \
            if mesh.coords is not None else 0
    return parts, idx


def local_shape(shape, spec, mesh) -> Tuple[int, ...]:
    """A leaf's per-rank shape under ``spec``."""
    out = []
    for d, n in enumerate(shape):
        parts, _ = _slice(spec, mesh, d)
        if n % parts:
            raise ValueError(f"dim {d} of {tuple(shape)} does not split "
                             f"{parts} ways under {spec}")
        out.append(n // parts)
    return tuple(out)


def leaf_index(shape, spec, mesh) -> Tuple[slice, ...]:
    """This rank's slice of each dim of ``shape`` under ``spec``."""
    out = []
    for d, n in enumerate(shape):
        parts, idx = _slice(spec, mesh, d)
        k = n // parts
        out.append(slice(idx * k, (idx + 1) * k))
    return tuple(out)


def shard_leaf(t, spec, mesh):
    """This rank's slice of the tensor ``t`` under ``spec``: ``t`` itself
    where the spec splits nothing, else a contiguous copy that holds no
    reference to ``t`` (a slice along dim 0 would be a view keeping the
    whole tensor's memory alive)."""
    idx = leaf_index(t.shape, spec, mesh)
    if all(i.stop - i.start == n for i, n in zip(idx, t.shape)):
        return t
    return t[idx].clone().contiguous()


def shard_params(params, specs, mesh):
    """This rank's slice of each leaf of ``params`` (whole, as the JAX
    package lays them out) under ``specs``, structure kept."""
    return tree_map(lambda t, s: shard_leaf(t, s, mesh), params, specs)


# ------------------------------------------------------------- training
def parallelism_of(ctx) -> ParallelismConfig:
    """The :class:`ParallelismConfig` a ctx of :func:`make_ctx` was made
    from."""
    return ParallelismConfig(tp_axis=ctx.tp_axis, dp_axes=tuple(ctx.dp_axes),
                             fsdp=bool(ctx.fsdp_axes),
                             expert_parallel=ctx.expert_parallel,
                             attn_sharding=ctx.attn_sharding)


@functools.lru_cache(maxsize=32)
def _rank_specs(cfg: ModelConfig, shape: Tuple, par: ParallelismConfig):
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models.model import init_params
    mesh = Mesh(dict(shape))
    return placement_specs(param_specs(init_params(cfg, device="meta"), cfg,
                                       mesh, par), cfg, mesh, par)


def rank_specs(cfg: ModelConfig, mesh, par: ParallelismConfig):
    """The placement specs of ``cfg``'s whole parameter tree on ``mesh``
    under ``par`` (:func:`param_specs` of meta tensors, then
    :func:`placement_specs`), cached per config, mesh shape and
    parallelism."""
    return _rank_specs(cfg, tuple(mesh.shape.items()), par)


def fsdp_dim(spec, par: ParallelismConfig):
    """The dim of a leaf that ``spec`` shards over the data axes (its FSDP
    dim), or None where the leaf is whole over them.  The rules put it on
    dim 0 of ``wq``/``wk``/``wv``, an MLP's ``w_gate``/``w_up``, the
    router, ``w_dkv``/``w_krope`` and every 2-D SSM weight, on dim 1 of
    ``wo``/``w_down`` and of the MoE ``w_down`` ``[E, F, D]``, on dim 2
    of the MoE ``w_gate``/``w_up`` ``[E, D, F]``; never on an embedding
    or a head, and only where the data axes divide the dim."""
    dp = set(_axes(par.dp_axes))
    for d, e in enumerate(spec):
        if e is not None and dp & set(_axes(e)):
            return d
    return None


def fsdp_dims(specs, par: ParallelismConfig):
    """:func:`fsdp_dim` of every leaf of a spec tree."""
    return tree_map(lambda s: fsdp_dim(s, par), specs)


def replication(spec, mesh) -> int:
    """How many ranks hold each slice of a leaf under ``spec``: the
    product of the sizes of the mesh axes the spec does not name."""
    named = {a for e in spec if e is not None for a in _axes(e)}
    return math.prod(n for a, n in mesh.shape.items() if a not in named)


def shard_batch(batch, cfg: ModelConfig, mesh, par: ParallelismConfig):
    """This data rank's rows of each array of a global ``batch`` (dim 0,
    under :func:`input_sharding`).  Where the data axes do not divide the
    batch, every data rank takes it whole, as the reference replicates
    it: the training step then runs ``data`` copies of the batch, whose
    loss and gradients are the batch's own (the loss is a mean over the
    tokens of every copy)."""
    b = next(iter(batch.values())).shape[0]
    spec = input_sharding(cfg, mesh, par, b)
    if spec is None:
        return dict(batch)
    return {k: shard_leaf(v, P(spec), mesh) for k, v in batch.items()}


def gather_params(params, specs, mesh):
    """Every leaf whole on every rank, from each rank's slice under
    ``specs`` (the inverse of :func:`shard_params`; for checkpoints and
    tests).  A split leaf is one zero-padded sum over all ranks, to which
    only the ranks at index 0 of the axes its spec leaves out add their
    slice."""
    import torch
    import torch.distributed as dist

    from repro_torch.models.layers import tally
    group = mesh.group(tuple(mesh.axis_names))

    def whole(t, spec):
        named = {a for e in spec if e is not None for a in _axes(e)}
        shape = tuple(n * _slice(spec, mesh, d)[0]
                      for d, n in enumerate(t.shape))
        if shape == tuple(t.shape):
            return t
        wide = torch.float32 if t.dtype in (torch.bfloat16,
                                            torch.float16) else t.dtype
        full = torch.zeros(shape, dtype=wide, device=t.device)
        if all(mesh.coords[a] == 0 for a in mesh.axis_names
               if a not in named):
            full[leaf_index(shape, spec, mesh)] = t.to(wide)
        tally("gather_params", full)
        dist.all_reduce(full, group=group)
        return full.to(t.dtype)
    return tree_map(whole, params, specs)
