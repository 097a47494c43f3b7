"""Multi-pod dry run by spec arithmetic: every (arch x input shape x
production mesh), per device (counterpart of ``src/repro/launch/dryrun.py``).

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \\
      --shape all --both-meshes [--optimized] [--out-dir DIR]

The reference lowers and compiles each step under GSPMD and reads its
memory and its collectives from the compiled program.  The port runs one
process per rank, so there is nothing to compile: one step's per-device
bytes and collectives follow from the specs each rank holds its arrays
by and from the order in which the port's forwards and backwards issue
their collectives.  Nothing here starts a process group or allocates a
tensor: parameters and caches are ``device="meta"`` trees.

Per case (the reference's record keys; ``run_one``):

* ``argument_bytes``: what one rank holds going into the step: its
  params under ``sharding.rank_specs`` (the placement the port runs;
  :func:`held_whole` lists each leaf that it holds whole over tp where
  the reference's ``param_specs`` cut it, with both byte counts), for
  ``train`` the AdamW step counter and float32 moments sliced alike,
  for ``prefill`` / ``decode`` the reference's dense cache under
  ``cache_specs`` (``cache_struct``), and the inputs (:func:`input_specs`)
  split over the data axes where they divide the batch, else whole.
  ``param_bytes``, ``moment_bytes``, ``cache_bytes`` and ``input_bytes``
  break it down.
* ``output_bytes``: what the step hands back: ``train`` the params and
  the optimizer state (updated in place) and five float32 metrics;
  ``prefill`` / ``decode`` the cache and the rank's logits, whole over
  the vocabulary (``[b, 1, V]``, ``[b, 1, K, V]`` with K codebooks).
* ``collective_bytes_per_device`` / ``collective_counts``: the port's own
  collectives in one step, by the kinds ``models.layers`` tallies them
  under (``layers.collective_counts``; ``kind.bwd``: issued by the
  backward), the bytes being each call's buffer (a float32 sum or a
  zero-padded float32 gather: 4 bytes an element; a bf16 activation is
  reduced in float32).  ``train`` is ``train_step(..., ctx=, remat=True)``
  (forward, the remat re-forward of each layer up to its last op that
  saves a tensor for the backward (``torch.utils.checkpoint``'s early
  stop), backward, the data-axis gradient sum, the norm); ``prefill`` is
  ``forward_full(..., cache=, ctx=, last_only=True)``; ``decode`` one
  ``forward_decode_paged`` round, the port's decode on a mesh, over the
  rank's rows of the batch.  :func:`collectives` computes them for any
  mesh shape, so the tests hold them to the tallies of spawned ranks.
* ``flops_per_device``, ``bytes_accessed_per_device``, ``temp_bytes``,
  ``peak_bytes``, ``lower_s``, ``compile_s``: ``null``.  The reference
  reads them from XLA's cost and memory analysis of the compiled
  program; the port has no compiled program, and its eager kernels'
  temporaries depend on the allocator, so no number stands in for them.

The port's runtime mesh has one data axis (``layers.dp_axis``); at the
multi-pod mesh (``pod`` x ``data`` x ``model``) the two data axes are
taken as one data group of their product, as the specs take them.
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import math
import os
import time
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.configs import ASSIGNED, get_config
from repro_torch.distributed.sharding import (P, ParallelismConfig,
                                              cache_specs, fsdp_dims,
                                              input_sharding, local_shape,
                                              param_specs, placement_specs,
                                              )
from repro_torch.launch.mesh import Mesh, make_production_mesh
from repro_torch.models.cache import cache_spec
from repro_torch.models.config import SSM, ModelConfig
from repro_torch.models.layers import heads_split
from repro_torch.models.model import init_params

# StreamingLLM-style window used for full-attention archs at 500k decode
STREAM_WINDOW = 8192

SHAPES = {
    "train_4k": dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
    "decode_32k": dict(kind="decode", seq=32768, batch=128),
    "long_500k": dict(kind="decode", seq=524288, batch=1),
}

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "experiments", "dryrun_torch")

# every collective buffer of the port: float32 sums and gathers, int32 ids
BUF_BYTES = 4
# the metrics train_step returns: loss, lm_loss, aux_loss, grad_norm, lr
N_METRICS = 5


# --------------------------------------------------------------- inputs
def input_specs(cfg: ModelConfig, shape_name: str):
    """Meta tensors standing in for every model input (no allocation)."""
    sh = SHAPES[shape_name]
    b, s = sh["batch"], sh["seq"]
    if sh["kind"] == "decode":
        s = 1
    i32 = dict(dtype=torch.int32, device="meta")
    act = dict(dtype=getattr(torch, cfg.dtype), device="meta")
    out = {}
    if cfg.uses_extra_embeds:
        out["embeds"] = torch.empty((b, s, cfg.d_model), **act)
        out["positions"] = torch.empty((b, s, 3), **i32)
    elif cfg.num_codebooks:
        out["tokens"] = torch.empty((b, s, cfg.num_codebooks), **i32)
    else:
        out["tokens"] = torch.empty((b, s), **i32)
    if sh["kind"] == "train":
        lead = (b, s, cfg.num_codebooks) if cfg.num_codebooks else (b, s)
        out["labels"] = torch.empty(lead, **i32)
    return out


def decode_window(cfg: ModelConfig, shape_name: str) -> int:
    if shape_name == "long_500k" and not cfg.sliding_window \
            and cfg.family not in ("ssm",):
        return STREAM_WINDOW     # windowed-KV serving mode
    return 0


def cache_struct(cfg: ModelConfig, shape_name: str, kv_quant: bool = False):
    """The reference's dense decode cache for the shape, as meta
    tensors."""
    sh = SHAPES[shape_name]
    return cache_spec(cfg, sh["batch"], sh["seq"],
                      window=decode_window(cfg, shape_name),
                      quantized=kv_quant)


def step_parallelism(par: ParallelismConfig,
                     kind: str) -> ParallelismConfig:
    """The parallelism a step of ``kind`` runs under: a serving step
    (prefill, decode) as the engine runs it, ``attn_sharding="none"``
    (the pages hold the kv heads the rules give each rank)."""
    if kind == "train":
        return par
    return dataclasses.replace(par, attn_sharding="none")


def default_parallelism(cfg: ModelConfig, shape_name: str, multi_pod: bool,
                        optimized: bool = False) -> ParallelismConfig:
    """The reference's ``run_one`` choice: FSDP for training (params and
    optimizer sharded everywhere) and where the tp-resident bf16 weights
    alone would exceed 8 GB (DBRX); ``optimized``: expert-parallel MoE and
    sequence-parallel attention."""
    tp_resident_gb = cfg.param_count() * 2 / 16 / 2**30
    return ParallelismConfig(
        dp_axes=("pod", "data") if multi_pod else ("data",),
        fsdp=(SHAPES[shape_name]["kind"] == "train"
              or tp_resident_gb > 8.0),
        expert_parallel=optimized,
        attn_sharding="auto" if optimized else "none")


# --------------------------------------------------------------- memory
@functools.lru_cache(maxsize=16)
def _meta_params(cfg: ModelConfig):
    """``cfg``'s parameter tree as meta tensors (shared: never mutated)."""
    return init_params(cfg, device="meta")


def _nbytes(shape, dtype) -> int:
    return math.prod(shape) * dtype.itemsize


def _paths(tree, prefix=""):
    """(dotted path, leaf) of every leaf of a nested dict / list tree, a
    spec (:class:`P`) being a leaf."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, f"{prefix}{k}.")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _paths(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1], tree


def _tree_bytes(tree, specs, mesh, dtype=None) -> int:
    leaves = dict(_paths(tree))
    return sum(_nbytes(local_shape(leaves[p].shape, s, mesh),
                       dtype or leaves[p].dtype)
               for p, s in _paths(specs))


def _batch_spec(shape, bspec) -> P:
    return P(bspec, *((None,) * (len(shape) - 1)))


def held_whole(cfg: ModelConfig, mesh: Mesh, par: ParallelismConfig,
               moments: bool = False) -> List[Dict]:
    """Every param leaf whose rank bytes under the port's placement
    (``placement_specs``) differ from the reference's ``param_specs``:
    ``{"leaf", "port_bytes", "reference_bytes"}`` (with ``moments`` also
    each one's two float32 AdamW moments, ``mu.<leaf>`` / ``nu.<leaf>``)."""
    full = _meta_params(cfg)
    ref = param_specs(full, cfg, mesh, par)
    port = placement_specs(ref, cfg, mesh, par)
    leaves = dict(_paths(full))
    out = []
    for (path, s_ref), (_, s_port) in zip(_paths(ref), _paths(port)):
        t = leaves[path]
        dts = [(path, t.dtype)]
        if moments:
            dts += [(f"mu.{path}", torch.float32),
                    (f"nu.{path}", torch.float32)]
        for name, dt in dts:
            a = _nbytes(local_shape(t.shape, s_port, mesh), dt)
            b = _nbytes(local_shape(t.shape, s_ref, mesh), dt)
            if a != b:
                out.append({"leaf": name, "port_bytes": a,
                            "reference_bytes": b})
    return out


def memory(cfg: ModelConfig, shape_name: str, mesh: Mesh,
           par: ParallelismConfig) -> Dict[str, int]:
    """Per-device bytes of the step's arguments and outputs (module
    docstring)."""
    sh = SHAPES[shape_name]
    par = step_parallelism(par, sh["kind"])
    full = _meta_params(cfg)
    specs = placement_specs(param_specs(full, cfg, mesh, par), cfg, mesh,
                            par)
    params = _tree_bytes(full, specs, mesh)
    bspec = input_sharding(cfg, mesh, par, sh["batch"])
    ins = input_specs(cfg, shape_name)
    inputs = sum(_nbytes(local_shape(v.shape, _batch_spec(v.shape, bspec),
                                     mesh), v.dtype) for v in ins.values())
    b_local = local_shape((sh["batch"],), P(bspec), mesh)[0]
    out = {"param_bytes": params, "input_bytes": inputs,
           "moment_bytes": 0, "cache_bytes": 0}
    if sh["kind"] == "train":
        out["moment_bytes"] = 2 * _tree_bytes(full, specs, mesh,
                                              torch.float32) + 4
        out["argument_bytes"] = params + out["moment_bytes"] + inputs
        out["output_bytes"] = params + out["moment_bytes"] + \
            N_METRICS * 4
        return out
    cache = cache_struct(cfg, shape_name)
    cspecs = cache_specs(cache, cfg, mesh, par, sh["batch"])
    out["cache_bytes"] = _tree_bytes(cache, cspecs, mesh)
    lead = (b_local, 1) + ((cfg.num_codebooks,) if cfg.num_codebooks > 1
                           else ())
    logits = _nbytes(lead + (cfg.vocab_size,), getattr(torch, cfg.dtype))
    out["argument_bytes"] = params + out["cache_bytes"] + inputs
    out["output_bytes"] = out["cache_bytes"] + logits
    return out


# ---------------------------------------------------------- collectives
class _Layer:
    """The collectives one checkpointed region issues, in order:
    ``(kind, elements, "fwd" | "bwd")``, and ``"save"`` marks an op that
    saves a tensor for the backward (the remat re-forward stops after
    the last one)."""

    def __init__(self):
        self.events: List = []

    def fwd(self, kind, elems):
        self.events.append((kind, elems, "fwd"))

    def bwd(self, kind, elems):
        self.events.append((kind + ".bwd", elems, "bwd"))

    def save(self):
        self.events.append("save")


class _Step:
    """Walks one step of ``cfg`` on a rank of ``mesh`` the way the
    port's forwards issue their collectives (``models/model.py``,
    ``attention.py``, ``moe.py``, ``layers.py``, ``train/train_step.py``):
    ``b`` rows of ``s`` tokens on the rank, ``grad``: a training step
    (backward and remat)."""

    def __init__(self, cfg: ModelConfig, mesh: Mesh, par: ParallelismConfig,
                 b: int, s: int, grad: bool):
        self.cfg, self.mesh, self.par = cfg, mesh, par
        self.b, self.grad = b, grad
        self.tp = mesh.shape[par.tp_axis]
        dp = (par.dp_axes,) if isinstance(par.dp_axes, str) \
            else tuple(par.dp_axes)
        self.dp = math.prod(mesh.shape[a] for a in dp)
        self.full = _meta_params(cfg)
        self.specs = placement_specs(param_specs(self.full, cfg, mesh, par),
                                     cfg, mesh, par)
        self.dims = fsdp_dims(self.specs, par) \
            if par.fsdp and self.dp > 1 else None
        self.tally: Dict[str, List[int]] = {}
        self.d = cfg.d_model
        # the residual stream is this rank's rows between the blocks
        self.rows = (par.attn_sharding == "auto" and self.tp > 1 and s > 1
                     and s % self.tp == 0 and not cfg.ssm_layers)

    # the tally
    def add(self, kind, elems, n=1):
        row = self.tally.setdefault(kind, [0, 0])
        row[0] += n
        row[1] += n * BUF_BYTES * elems

    def commit(self, layer: _Layer, remat: bool):
        """Count a region's events: its forward once (twice up to its
        last saving op under remat), its backward once in training."""
        last = max((i for i, e in enumerate(layer.events) if e == "save"),
                   default=-1)
        for i, e in enumerate(layer.events):
            if e == "save":
                continue
            kind, elems, phase = e
            if phase == "bwd":
                if self.grad:
                    self.add(kind, elems)
            else:
                self.add(kind, elems, 2 if remat and i < last else 1)

    # helpers on the rank's leaves
    def local(self, tree_path):
        """(local numel, FSDP dim) of a param leaf by its path."""
        node, spec, dims = self.full, self.specs, self.dims
        for k in tree_path:
            node, spec = node[k], spec[k]
            dims = dims[k] if dims is not None else None
        return math.prod(local_shape(node.shape, spec, self.mesh)), dims

    def leaves(self, path):
        """The path of every param leaf under ``path``."""
        node = self.full
        for k in path:
            node = node[k]
        return [tuple(path) + tuple(sub.split(".")) for sub, _ in
                _paths(node)]

    def gathers(self, L: _Layer, path):
        """``model._gathered``: every FSDP leaf of the block at ``path``
        but the MoE's expert weights, which ``moe_ffn`` gathers."""
        if self.dims is None:
            return
        experts = [tuple(path) + ("moe", n)
                   for n in ("w_gate", "w_up", "w_down")]
        for leaf in self.leaves(path):
            n, dim = self.local(leaf)
            if dim is not None and leaf not in experts:
                L.fwd("fsdp_gather", n * self.dp)
                L.bwd("fsdp_gather", n * self.dp)

    def whole(self, path):
        """The numel of a leaf as the rank uses it (gathered)."""
        n, dim = self.local(path)
        return n * self.dp if dim is not None else n

    # the blocks
    def norm(self, L: _Layer, path, rows: bool):
        if rows and self.tp > 1:
            for leaf in self.leaves(path):
                L.bwd("tp_enter_weight", self.whole(leaf))
        L.save()

    def attention(self, L: _Layer, path, rows: bool, tokens: int, s: int):
        cfg, tp, d = self.cfg, self.tp, self.d
        attn = tuple(path) + ("attn",)
        if cfg.mla is not None:
            m = cfg.mla
            t_all = tokens * tp if rows else tokens
            if rows:
                L.fwd("seq_gather", t_all * d)
            split = heads_split(cfg, tp)
            if split:
                L.bwd("tp_enter", t_all * d)
            L.save()
            if split:
                L.bwd("tp_enter", t_all * m.kv_lora_rank)
                L.bwd("tp_enter", t_all * m.qk_rope_head_dim)
            L.save()
            if split:
                L.fwd("tp_all_reduce", t_all * d)
            if rows:
                L.bwd("seq_rows", t_all * d)
            return
        seqpar = self.par.attn_sharding == "auto" and tp > 1 and s > 1 \
            and s % tp == 0
        if rows or seqpar:
            t_all = tokens * tp if rows else tokens
            if not rows:
                L.bwd("seq_rows", t_all * d)
            for leaf in self.leaves(attn):
                L.bwd("tp_enter_weight", self.whole(leaf))
            L.save()
            kv = t_all * cfg.num_kv_heads * cfg.head_dim
            for _ in ("k", "v"):
                L.fwd("seq_gather", kv)
                L.bwd("seq_gather", kv)
            L.save()
            if not rows:
                L.fwd("tp_all_gather", t_all * d)
            return
        split = heads_split(cfg, tp) and self.par.attn_sharding != "auto"
        if split:
            L.bwd("tp_enter", tokens * d)
            if cfg.qk_norm:
                L.bwd("tp_enter", cfg.head_dim)
                L.bwd("tp_enter", cfg.head_dim)
        L.save()
        if split:
            L.fwd("tp_all_reduce", tokens * d)

    def mlp(self, L: _Layer, weights, width: int, rows: bool, tokens: int):
        """``layers.tp_mlp`` over ``tokens`` rows (the rank's rows when
        ``rows``); ``weights``: the leaf paths."""
        tp, d = self.tp, self.d
        split = tp > 1 and width % tp == 0 and width >= tp
        if rows:
            if split:
                L.fwd("seq_gather", tokens * tp * d)
                L.bwd("seq_gather", tokens * tp * d)
                L.save()
                L.fwd("seq_scatter", tokens * tp * d)
                L.bwd("seq_scatter", tokens * tp * d)
            else:
                for w in weights:
                    L.bwd("tp_enter_weight", self.whole(w))
                L.save()
            return
        if split:
            L.bwd("tp_enter", tokens * d)
        L.save()
        if split:
            L.fwd("tp_all_reduce", tokens * d)

    def moe(self, L: _Layer, path, rows: bool, b: int, s: int):
        cfg, tp, dp, d = self.cfg, self.tp, self.dp, self.d
        e = cfg.moe
        mp = tuple(path) + ("moe",)
        experts = [mp + (n,) for n in ("w_gate", "w_up", "w_down")]
        ep = self.par.expert_parallel and e.num_experts % tp == 0
        if rows and ep:
            # gather the rows, run on the whole sequence, keep the rank's
            L.fwd("seq_gather", b * s * tp * d)
            self.moe(L, path, False, b, s * tp)
            L.bwd("seq_rows", b * s * tp * d)
            return
        t = b * s

        def gather_experts():
            for w in experts:
                n, dim = self.local(w)
                if dim is not None:
                    L.fwd("fsdp_gather", n * dp)
                    L.bwd("fsdp_gather", n * dp)
        if ep:
            if self.par.fsdp and b * dp * s <= 4096:
                # the rows and the router probabilities gathered over the
                # data axis, the output summed over every rank (groups of
                # one rank included)
                t_all = t * dp
                L.save()
                L.fwd("moe_2d", t_all * e.num_experts)
                L.fwd("moe_2d", t_all * d)
                L.bwd("moe_2d", t_all * d)
                L.bwd("moe_2d", t_all * e.top_k)
                L.save()
                L.fwd("moe_2d", t_all * d)
                L.bwd("moe_2d", t_all * d)
                L.save()          # the load-balance loss
            else:
                gather_experts()
                L.save()
                if tp > 1:
                    L.bwd("tp_enter", t * d)
                L.save()
                if tp > 1:
                    L.bwd("tp_enter", t * e.top_k)
                L.save()
                if tp > 1:
                    L.fwd("tp_all_reduce", t * d)
                L.save()          # the load-balance loss
                if dp > 1:
                    L.fwd("data_all_reduce", 1)
            self.shared(L, mp, rows, t)
            return
        gather_experts()
        sliced = rows or (tp > 1 and s > 1 and s % tp == 0)
        if sliced:
            if not rows:
                L.bwd("seq_rows", t * d)
            L.bwd("tp_enter", d * e.num_experts)
            for w in experts:
                L.bwd("tp_enter", self.whole(w))
            L.save()
            if not rows:
                L.fwd("tp_all_gather", t * d)
            L.save()          # the load-balance loss
            L.fwd("tp_all_reduce", 1)
        else:
            L.save()
        self.shared(L, mp, rows, t)
        if dp > 1:
            L.fwd("data_all_reduce", 1)

    def shared(self, L: _Layer, mp, rows: bool, t: int):
        e = self.cfg.moe
        if not e.num_shared_experts:
            return
        sh = mp + ("shared",)
        self.mlp(L, [sh + (n,) for n in ("w_gate", "w_up", "w_down")],
                 e.d_ff_expert * e.num_shared_experts, rows, t)

    def ffn(self, L: _Layer, path, rows: bool, b: int, s: int):
        block = self.full
        for k in path:
            block = block[k]
        self.norm(L, tuple(path) + ("mlp_norm",), rows)
        if "moe" in block:
            self.moe(L, path, rows, b, s)
            return
        mlp = tuple(path) + ("mlp",)
        self.mlp(L, [mlp + (n,) for n in block["mlp"]],
                 block["mlp"]["w_down"].shape[0], rows, b * s)

    def block_path(self, i: int):
        if self.full["layers"][i]:
            return ("layers", i)
        return ("shared_block",)

    def layers(self, s: int, decode: bool = False):
        """Each layer of the stack as its region, committed (remat in
        training)."""
        cfg, b = self.cfg, self.b
        rows = self.rows and not decode
        n = s // self.tp if rows else s
        for i, kind in enumerate(cfg.layer_pattern):
            L = _Layer()
            path = self.block_path(i)
            self.gathers(L, path)
            if kind == SSM:
                L.save()
                self.commit(L, remat=self.grad)
                continue
            self.norm(L, tuple(path) + ("attn_norm",), rows)
            self.attention(L, path, rows, b * n, s)
            self.ffn(L, path, rows, b, n)
            self.commit(L, remat=self.grad)

    def head(self, L: _Layer, tokens: int, gather: bool):
        """``lm_head`` over ``tokens`` rows."""
        cfg = self.cfg
        if not self._vocab_split():
            return
        L.bwd("vocab", tokens * self.d)
        L.save()
        if gather:
            k = cfg.num_codebooks if cfg.num_codebooks > 1 else 1
            L.fwd("vocab", tokens * k * cfg.vocab_size)

    def _vocab_split(self) -> bool:
        v, tp = self.cfg.vocab_size, self.tp
        return tp > 1 and v % tp == 0 and v >= tp

    def embed(self, L: _Layer, tokens: int):
        if not self.cfg.uses_extra_embeds and self._vocab_split():
            L.fwd("vocab", tokens * self.d)


def collectives(cfg: ModelConfig, kind: str, mesh: Mesh,
                par: ParallelismConfig, batch: int, seq: int,
                rows: Optional[int] = None
                ) -> Tuple[Dict[str, int], Dict[str, int]]:
    """(bytes, calls) by kind of the port's collectives on one rank in one
    step of ``kind`` ("train", "prefill", "decode") of a global ``batch``
    of ``seq`` tokens (decode: one token a row) on ``mesh`` under
    ``par`` (module docstring).  ``rows``: the rows the rank runs, where
    not its share of the batch (an engine's decode round runs its whole
    slot pool on every data rank)."""
    par = step_parallelism(par, kind)
    bspec = input_sharding(cfg, mesh, par, batch)
    b = rows or local_shape((batch,), P(bspec), mesh)[0]
    s = 1 if kind == "decode" else seq
    st = _Step(cfg, mesh, par, b, s, grad=(kind == "train"))
    top = _Layer()
    st.embed(top, b * s)
    if st.rows and not cfg.uses_extra_embeds:
        top.bwd("seq_rows", b * s * st.d)
    st.commit(top, remat=False)
    st.layers(s, decode=(kind == "decode"))
    top = _Layer()
    if st.rows:
        top.fwd("tp_all_gather", b * s * st.d)
    if kind == "train":
        st.head(top, b * s, gather=False)
        if st._vocab_split():
            k = cfg.num_codebooks if cfg.num_codebooks > 1 else 1
            rows = b * s * k
            top.fwd("vocab", rows)             # the target's logit
            top.fwd("vocab", st.tp * rows)     # the max: a [tp, rows] gather
            top.fwd("vocab", rows)             # the sum of exps
        if st.dp > 1:
            top.fwd("data_all_reduce", 1)
            top.fwd("data_all_reduce", 1)
    else:
        st.head(top, b * (1 if kind == "prefill" else s), gather=True)
    st.commit(top, remat=False)
    if kind == "train":
        if st.dp > 1:
            _data_sum(st)
        st.add("grad_norm", 1)
    return ({k: v[1] for k, v in sorted(st.tally.items())},
            {k: v[0] for k, v in sorted(st.tally.items())})


def _data_sum(st: _Step):
    """``train_step._sum_over_data``: the leaves whole over the data axes,
    in the params' leaf order, in buckets of at most ``SUM_BUCKET``
    elements."""
    from repro_torch.train.train_step import SUM_BUCKET
    dims = dict(_paths(st.dims)) if st.dims is not None else {}
    specs = dict(_paths(st.specs))
    size, buckets = SUM_BUCKET, 0
    total = 0
    for path, leaf in _paths(st.full):          # the params' leaf order
        if dims.get(path) is not None:
            continue
        n = math.prod(local_shape(leaf.shape, specs[path], st.mesh))
        if size + n > SUM_BUCKET:
            buckets += 1
            size = 0
        size += n
        total += n
    if buckets:
        row = st.tally.setdefault("data_grad_sum", [0, 0])
        row[0] += buckets
        row[1] += BUF_BYTES * total


# --------------------------------------------------------------- driver
def mesh_name(mesh: Mesh) -> str:
    return "x".join(str(n) for n in mesh.shape.values())


def run_one(arch: str, shape_name: str, multi_pod: bool,
            par: Optional[ParallelismConfig] = None, save: bool = True,
            verbose: bool = True, optimized: bool = False,
            out_dir: Optional[str] = None, cfg: Optional[ModelConfig] = None):
    """One case's record (module docstring), written to
    ``<out_dir>/<arch>_<shape>_<mesh>.json`` with ``save``."""
    cfg = cfg or get_config(arch)
    mesh = make_production_mesh(multi_pod=multi_pod)
    sh = SHAPES[shape_name]
    if par is None:
        par = default_parallelism(cfg, shape_name, multi_pod, optimized)
    par = step_parallelism(par, sh["kind"])
    t0 = time.perf_counter()
    rec = memory(cfg, shape_name, mesh, par)
    coll, counts = collectives(cfg, sh["kind"], mesh, par, sh["batch"],
                               sh["seq"])
    rec.update(flops_per_device=None, bytes_accessed_per_device=None,
               temp_bytes=None, peak_bytes=None,
               collective_bytes_per_device=coll, collective_counts=counts,
               arch=arch, shape=shape_name, mesh=mesh_name(mesh),
               lower_s=None, compile_s=None,
               param_count=cfg.param_count(),
               active_param_count=cfg.active_param_count(),
               held_whole=held_whole(cfg, mesh, par,
                                     moments=sh["kind"] == "train"),
               parallelism=dataclasses.asdict(par),
               seconds=time.perf_counter() - t0)
    if verbose:
        print(line(rec))
    if save:
        d = out_dir or RESULTS_DIR
        os.makedirs(d, exist_ok=True)
        tag = f"{arch}_{shape_name}_{rec['mesh']}".replace("/", "-")
        with open(os.path.join(d, tag + ".json"), "w") as f:
            json.dump(rec, f, indent=1)
    return rec


def line(rec) -> str:
    """One record as a table row: GiB a device and collective MiB."""
    g = 2 ** 30
    coll = sum(rec["collective_bytes_per_device"].values())
    calls = sum(rec["collective_counts"].values())
    return (f"[dryrun] {rec['arch']} x {rec['shape']} x {rec['mesh']}: "
            f"args {rec['argument_bytes'] / g:.3f} GiB/dev (params "
            f"{rec['param_bytes'] / g:.3f}, moments "
            f"{rec['moment_bytes'] / g:.3f}, cache "
            f"{rec['cache_bytes'] / g:.3f}, inputs "
            f"{rec['input_bytes'] / g:.4f}), out "
            f"{rec['output_bytes'] / g:.3f}; collectives "
            f"{coll / 2**20:.1f} MiB in {calls} calls; "
            f"{len(rec['held_whole'])} leaves held whole")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="arch id or 'all'")
    ap.add_argument("--shape", default=None,
                    help="input-shape id or 'all'")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--optimized", action="store_true",
                    help="expert-parallel MoE and sequence-parallel "
                         "attention")
    ap.add_argument("--out-dir", default=None)
    args = ap.parse_args(argv)
    archs = ASSIGNED if args.arch in (None, "all") else [args.arch]
    shapes = list(SHAPES) if args.shape in (None, "all") else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    n = 0
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                run_one(arch, shape, mp, optimized=args.optimized,
                        out_dir=args.out_dir)
                n += 1
    print(f"dry-run: {n} cases by spec arithmetic")


if __name__ == "__main__":
    main()
