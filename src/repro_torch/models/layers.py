"""Shared layer primitives: norms, rotary embeddings (incl. M-RoPE), MLPs,
and the collectives of a mesh.

Counterpart of ``src/repro/models/layers.py``; parameters keep the JAX layout
(``x @ w`` with ``w: [d_in, d_out]``).

Under a mesh (a ``ShardingCtx``, :mod:`repro_torch.models.moe`) each rank
is a process holding its slice of the weights and its rows of the batch,
and the collectives GSPMD inserts in the JAX package are explicit here,
each a ``torch.autograd.Function`` whose backward is the collective the
gradient needs (Megatron's "f" and "g"):

* :func:`tp_all_reduce` after a row-parallel product (``wo``, the MLP's
  ``w_down``): forward a sum over tp, backward the identity, since every
  tp rank consumes the same sum;
* :func:`tp_enter` where a replicated activation enters a rank's head,
  column, vocabulary or expert shard: forward the identity, backward a
  sum over tp (each rank's shard adds its part of the gradient);
* :func:`tp_all_gather` where each rank computed a slice of a dim
  (vocabulary logits, MoE sequence slices): backward the rank's slice;
* :func:`fsdp_gather`: a weight's FSDP shards put back together over
  the data axis; backward a sum over the data axis of which the rank
  keeps its slice (a reduce-scatter);
* :func:`data_all_reduce`: a sum over the data axis whose every rank
  consumes the same value (the loss, the MoE load-balance loss):
  backward the identity.

Sequence parallelism (``attn_sharding="auto"``: each tp rank holds
``s/tp`` rows of the sequence between the blocks) adds three:

* :func:`seq_rows`: the rank's rows of a tensor whole over tp; backward
  the ranks' row gradients put back together (every rank gets the
  whole gradient, as every rank holds the whole tensor);
* :func:`seq_gather`: the ranks' rows put back together on every rank;
  backward the rank's rows of the gradient, summed over tp first where
  each rank consumed a different part of the whole (``summed``: the
  keys and values its own query rows read, the whole input of its
  column shard of a split MLP), as they are where every rank ran the
  same computation on it;
* :func:`seq_scatter`: a row-parallel output summed over tp, of which
  the rank keeps its rows (a reduce-scatter); backward the ranks' row
  gradients put back together.

A weight whole on every rank that a rank uses on its rows alone (a norm
scale, the attention projections under ``"auto"``) enters through
:func:`tp_enter`, so that its gradient is summed over the rows of every
rank.

The forwards are ``all_reduce`` calls, the one collective gloo runs on
CUDA tensors (a gather is a zero-padded sum, exact); a bf16 tensor is
reduced in float32 and rounded once.  Without a ctx (or on an axis of
size 1) they are the identity.

Every collective of the port is tallied on its process by kind (its
calls and the bytes of the buffer it reduces: :func:`collective_counts`,
:func:`reset_collective_counts`): a helper's ``kind`` names the forward
collective and ``kind + ".bwd"`` the one its backward issues.  The dry
run (:mod:`repro_torch.launch.dryrun`) predicts these tallies.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.device import upcast


def dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` in the wider of the two dtypes, as ``jnp.dot`` promotes:
    float32 activations (a VLM's float32 ``embeds`` batch) meet a bf16
    weight as float32, where ``torch.matmul`` refuses mixed dtypes."""
    if x.dtype != w.dtype:
        dt = torch.promote_types(x.dtype, w.dtype)
        x, w = x.to(dt), w.to(dt)
    return x @ w


# ----------------------------------------------------- tensor parallel
def tp_size(ctx) -> int:
    return 1 if ctx is None else ctx.mesh.shape[ctx.tp_axis]


def tp_rank(ctx) -> int:
    return 0 if ctx is None else ctx.mesh.coords[ctx.tp_axis]


def heads_split(cfg, tp: int) -> bool:
    """Whether a tp-way mesh splits the attention heads over its ranks.
    GQA: both the q and the kv heads must divide it, so that each rank's
    contiguous q heads are the groups of its whole kv heads.  MLA: the
    heads must divide it (each rank ``num_heads / tp`` of them); the
    latent has no heads and stays whole."""
    if tp <= 1 or cfg.num_heads < tp or cfg.num_heads % tp:
        return False
    if cfg.mla is not None:
        return True
    return cfg.num_kv_heads >= tp and cfg.num_kv_heads % tp == 0


def tp_split(full: int, local: int, ctx, what: str = "dim") -> bool:
    """Whether a dim of ``full`` entries is split over the tp axis on
    this rank (the partition rules split it iff the tp axis divides it,
    ``sharding._div``), checked against the extent ``local`` the rank
    holds."""
    tp = tp_size(ctx)
    split = tp > 1 and full % tp == 0 and full >= tp
    want = full // tp if split else full
    if local != want:
        raise ValueError(f"{what}: this rank holds {local} of {full}, the "
                         f"placement rules give it {want} at tp {tp}")
    return split


# kind -> [calls, bytes] of this process's collectives
_TALLY: Dict[str, List[int]] = {}


def tally(kind: str, buf: torch.Tensor):
    """Count one collective of ``kind`` over the buffer ``buf``."""
    row = _TALLY.setdefault(kind, [0, 0])
    row[0] += 1
    row[1] += buf.numel() * buf.element_size()


def collective_counts() -> Dict[str, Dict[str, int]]:
    """``{kind: {"calls": n, "bytes": b}}`` since the last reset."""
    return {k: {"calls": c, "bytes": b} for k, (c, b) in _TALLY.items()}


def reset_collective_counts():
    _TALLY.clear()


def _reduce_dtype(x: torch.Tensor) -> torch.dtype:
    return torch.float32 if x.dtype in (torch.bfloat16, torch.float16) \
        else x.dtype


def _sum(x: torch.Tensor, group, kind: str) -> torch.Tensor:
    """A new tensor: ``x`` summed over ``group``."""
    import torch.distributed as dist
    y = x.to(_reduce_dtype(x), copy=True).contiguous()
    tally(kind, y)
    dist.all_reduce(y, group=group)
    return y.to(x.dtype)


def _gather(x: torch.Tensor, dim: int, group, index: int,
            parts: int, kind: str) -> torch.Tensor:
    """Each rank's ``x`` concatenated along ``dim`` in group order: the
    rank writes its slice (number ``index`` of ``parts``) into zeros and
    the group sums them (a sum with zeros is exact, and every rank gets
    the same bits)."""
    import torch.distributed as dist
    n = x.shape[dim]
    shape = list(x.shape)
    shape[dim] = n * parts
    full = torch.zeros(shape, dtype=_reduce_dtype(x), device=x.device)
    full.narrow(dim, index * n, n).copy_(x)
    tally(kind, full)
    dist.all_reduce(full, group=group)
    return full.to(x.dtype)


class _AllReduce(torch.autograd.Function):
    """Forward: the sum over ``group``.  Backward: the gradient as it
    is (every rank consumes the same sum), or summed over ``bwd_group``
    where the ranks of that group consume different parts of it."""

    @staticmethod
    def forward(fctx, x, group, bwd_group, kind):
        fctx.bwd_group, fctx.kind = bwd_group, kind
        return _sum(x, group, kind)

    @staticmethod
    def backward(fctx, g):
        if fctx.bwd_group is not None:
            g = _sum(g, fctx.bwd_group, fctx.kind + ".bwd")
        return g, None, None, None


class _Enter(torch.autograd.Function):
    """Forward: the identity.  Backward: the sum over ``group``."""

    @staticmethod
    def forward(fctx, x, group, kind):
        fctx.group, fctx.kind = group, kind
        return x

    @staticmethod
    def backward(fctx, g):
        return _sum(g, fctx.group, fctx.kind + ".bwd"), None, None


class _AllGather(torch.autograd.Function):
    """Forward: :func:`_gather`.  Backward: the rank's slice of the
    gradient, summed over ``bwd_group`` first where given."""

    @staticmethod
    def forward(fctx, x, dim, group, index, parts, bwd_group, kind):
        dim = dim % x.dim()
        fctx.slice = (dim, index * x.shape[dim], x.shape[dim])
        fctx.bwd_group, fctx.kind = bwd_group, kind
        return _gather(x, dim, group, index, parts, kind)

    @staticmethod
    def backward(fctx, g):
        if fctx.bwd_group is not None:
            g = _sum(g, fctx.bwd_group, fctx.kind + ".bwd")
        return (g.narrow(*fctx.slice).contiguous(), None, None, None, None,
                None, None)


def all_reduce(x, group, bwd_group=None, kind: str = "all_reduce"):
    """:class:`_AllReduce`: the sum over ``group`` under autograd."""
    return _AllReduce.apply(x, group, bwd_group, kind)


def enter(x, group, kind: str = "enter"):
    """:class:`_Enter`: the identity, whose backward sums over
    ``group``."""
    return _Enter.apply(x, group, kind)


def all_gather(x, dim: int, group, index: int, parts: int,
               bwd_group=None, kind: str = "all_gather"):
    """:class:`_AllGather`: the ranks' ``x`` along ``dim`` under
    autograd."""
    return _AllGather.apply(x, dim, group, index, parts, bwd_group, kind)


def tp_all_reduce(x: torch.Tensor, ctx,
                  kind: str = "tp_all_reduce") -> torch.Tensor:
    """Sum ``x`` over the ctx's tp group (a row-parallel product's
    partial sums); identity without a ctx.  Backward: the identity."""
    if tp_size(ctx) == 1:
        return x
    return all_reduce(x, ctx.mesh.group(ctx.tp_axis), kind=kind)


def tp_enter(x: torch.Tensor, ctx, kind: str = "tp_enter") -> torch.Tensor:
    """``x``, replicated over tp, entering this rank's shard; backward
    sums the ranks' gradients (identity without a ctx)."""
    if tp_size(ctx) == 1:
        return x
    return enter(x, ctx.mesh.group(ctx.tp_axis), kind)


def tp_all_gather(x: torch.Tensor, ctx, dim: int,
                  kind: str = "tp_all_gather") -> torch.Tensor:
    """Concatenate each rank's ``x`` along ``dim`` in rank order, on
    every rank.  Backward: this rank's slice of the gradient."""
    if tp_size(ctx) == 1:
        return x
    return all_gather(x, dim, ctx.mesh.group(ctx.tp_axis), tp_rank(ctx),
                      tp_size(ctx), kind=kind)


class _Rows(torch.autograd.Function):
    """Forward: this rank's slice of ``dim`` (number ``index`` of
    ``parts``).  Backward: the ranks' slices of the gradient put back
    together over ``group``."""

    @staticmethod
    def forward(fctx, x, dim, group, index, parts, kind):
        dim = dim % x.dim()
        n = x.shape[dim] // parts
        fctx.args = (dim, group, index, parts, kind + ".bwd")
        return x.narrow(dim, index * n, n).contiguous()

    @staticmethod
    def backward(fctx, g):
        return (_gather(g.contiguous(), *fctx.args), None, None, None, None,
                None)


class _ReduceScatter(torch.autograd.Function):
    """Forward: the sum over ``group``, of which this rank keeps its
    slice of ``dim``.  Backward: the ranks' slices of the gradient put
    back together."""

    @staticmethod
    def forward(fctx, x, dim, group, index, parts, kind):
        dim = dim % x.dim()
        n = x.shape[dim] // parts
        fctx.args = (dim, group, index, parts, kind + ".bwd")
        return _sum(x, group, kind).narrow(dim, index * n, n).contiguous()

    @staticmethod
    def backward(fctx, g):
        return (_gather(g.contiguous(), *fctx.args), None, None, None, None,
                None)


def seq_parallel(ctx, s: int) -> bool:
    """Whether a sequence of ``s`` tokens runs sequence-parallel on this
    rank's mesh: ``attn_sharding="auto"``, ``s > 1``, and the tp axis (of
    more than one rank) divides ``s`` (the reference's
    ``_seq_parallel_wanted``; on a tp axis of one rank its constraints
    change nothing)."""
    if ctx is None or getattr(ctx, "attn_sharding", "none") != "auto":
        return False
    tp = tp_size(ctx)
    return tp > 1 and s > 1 and s % tp == 0


def seq_rows(x: torch.Tensor, ctx, dim: int = 1) -> torch.Tensor:
    """This tp rank's ``1/tp`` of ``x``'s ``dim`` (its rows of the
    sequence); backward: the ranks' row gradients put back together."""
    return _Rows.apply(x, dim, ctx.mesh.group(ctx.tp_axis), tp_rank(ctx),
                       tp_size(ctx), "seq_rows")


def seq_gather(x: torch.Tensor, ctx, dim: int = 1,
               summed: bool = False) -> torch.Tensor:
    """The tp ranks' rows ``x`` put back together along ``dim`` on every
    rank.  Backward: this rank's rows of the gradient, first summed over
    tp where each rank consumed a different part of the whole
    (``summed``)."""
    group = ctx.mesh.group(ctx.tp_axis)
    return all_gather(x, dim, group, tp_rank(ctx), tp_size(ctx),
                      bwd_group=group if summed else None, kind="seq_gather")


def seq_scatter(x: torch.Tensor, ctx, dim: int = 1) -> torch.Tensor:
    """A row-parallel output summed over tp, of which this rank keeps
    its rows of ``dim`` (a reduce-scatter); backward: the ranks' row
    gradients put back together."""
    return _ReduceScatter.apply(x, dim, ctx.mesh.group(ctx.tp_axis),
                                tp_rank(ctx), tp_size(ctx), "seq_scatter")


def tp_enter_tree(tree, ctx):
    """:func:`tp_enter` over the leaves of a dict of tensors (their
    backward sums are the kind ``tp_enter_weight``)."""
    if isinstance(tree, dict):
        return {k: tp_enter_tree(v, ctx) for k, v in tree.items()}
    return tp_enter(tree, ctx, "tp_enter_weight")


@torch.no_grad()
def tp_max(x: torch.Tensor, ctx, kind: str = "tp_max") -> torch.Tensor:
    """The elementwise max of ``x`` over tp (no gradient): the ranks'
    tensors gathered, then reduced (only sums run on every backend)."""
    if tp_size(ctx) == 1:
        return x
    return _gather(x[None], 0, ctx.mesh.group(ctx.tp_axis), tp_rank(ctx),
                   tp_size(ctx), kind).amax(dim=0)


# ------------------------------------------------------------ data axis
def dp_axis(ctx) -> str:
    """The ctx's one data axis (the port's meshes have one)."""
    axes = (ctx.dp_axes,) if isinstance(ctx.dp_axes, str) \
        else tuple(ctx.dp_axes)
    if len(axes) != 1:
        raise NotImplementedError(f"data axes {axes}: a mesh of the port "
                                  "has one data axis")
    return axes[0]


def dp_size(ctx) -> int:
    return 1 if ctx is None else ctx.mesh.shape.get(dp_axis(ctx), 1)


def dp_rank(ctx) -> int:
    return 0 if ctx is None else ctx.mesh.coords.get(dp_axis(ctx), 0)


def data_all_reduce(x: torch.Tensor, ctx) -> torch.Tensor:
    """Sum ``x`` over the data axis; every rank consumes the sum, so the
    backward is the identity."""
    if dp_size(ctx) == 1:
        return x
    return all_reduce(x, ctx.mesh.group(dp_axis(ctx)),
                      kind="data_all_reduce")


def fsdp_gather(leaf: torch.Tensor, dim, ctx) -> torch.Tensor:
    """A weight whole along its FSDP dim ``dim`` (None: the leaf is not
    sharded over the data axis), from each data rank's shard.  Backward:
    the gradient summed over the data axis, of which this rank keeps its
    shard."""
    if dim is None or dp_size(ctx) == 1:
        return leaf
    group = ctx.mesh.group(dp_axis(ctx))
    return all_gather(leaf, dim, group, dp_rank(ctx), dp_size(ctx),
                      bwd_group=group, kind="fsdp_gather")


def fsdp_gather_tree(tree, dims, ctx):
    """:func:`fsdp_gather` over the leaves of a dict tree, ``dims`` the
    same tree of FSDP dims."""
    if isinstance(tree, dict):
        return {k: fsdp_gather_tree(v, dims[k], ctx)
                for k, v in tree.items()}
    return fsdp_gather(tree, dims, ctx)


# ---------------------------------------------------------------- norms
def rmsnorm(x: torch.Tensor, weight: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = upcast(x)
    var = torch.mean(x * x, dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * upcast(weight)).to(dt)


def layernorm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = upcast(x)
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.var(x, dim=-1, keepdim=True, unbiased=False)
    x = (x - mu) * torch.rsqrt(var + eps)
    return (x * upcast(weight) + upcast(bias)).to(dt)


def apply_norm(x, params, cfg):
    if cfg.norm_type == "layernorm":
        return layernorm(x, params["scale"], params["bias"], cfg.norm_eps)
    return rmsnorm(x, params["scale"], cfg.norm_eps)


def init_norm(cfg, d: int, device: torch.device):
    if cfg.norm_type == "layernorm":
        return {"scale": torch.ones(d, dtype=torch.float32, device=device),
                "bias": torch.zeros(d, dtype=torch.float32, device=device)}
    return {"scale": torch.ones(d, dtype=torch.float32, device=device)}


# ---------------------------------------------------------------- rope
def rope_freqs(head_dim: int, theta: float,
               device: Optional[torch.device] = None) -> torch.Tensor:
    """Inverse frequencies for half the head dim. [hd/2] f32."""
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / (theta ** exps)


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float,
                 mrope_sections: Tuple[int, ...] = ()
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables.

    positions: [..., seq] int for 1-D RoPE, or [..., seq, 3] for M-RoPE
    (temporal, height, width position ids — Qwen2-VL arXiv:2409.12191).
    Returns cos, sin of shape [..., seq, head_dim/2] f32.
    """
    inv = rope_freqs(head_dim, theta, positions.device)      # [hd/2]
    if mrope_sections:
        assert positions.shape[-1] == 3, "M-RoPE needs 3-d position ids"
        ang3 = positions[..., None].float() * inv           # [...,seq,3,hd/2]
        # per-frequency component selector from the section layout
        sec = torch.cat([torch.full((s,), i, dtype=torch.long,
                                    device=positions.device)
                         for i, s in enumerate(mrope_sections)])
        onehot = F.one_hot(sec, 3).float()                  # [hd/2, 3]
        ang = torch.einsum("...kf,fk->...f", ang3, onehot)
    else:
        ang = positions[..., None].float() * inv            # [...,seq,hd/2]
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x: [..., seq, heads, head_dim]; cos/sin: [..., seq, head_dim/2]."""
    dt = x.dtype
    half = x.shape[-1] // 2
    x1, x2 = upcast(x[..., :half]), upcast(x[..., half:])
    c = cos[..., None, :]                  # broadcast over heads
    s = sin[..., None, :]
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return out.to(dt)


# ---------------------------------------------------------------- mlp
def swiglu(x, w_gate, w_up, w_down):
    return dot(F.silu(dot(x, w_gate)) * dot(x, w_up), w_down)


def gelu_mlp(x, w_up, w_down):
    # jax.nn.gelu defaults to the tanh approximation
    return dot(F.gelu(dot(x, w_up), approximate="tanh"), w_down)


def normal(shape, std: float, dtype: torch.dtype, device: torch.device,
           generator: torch.Generator) -> torch.Tensor:
    """N(0, std²) drawn directly on ``device`` in ``dtype``: a 7B bf16
    init never materializes a float32 copy on the host."""
    out = torch.empty(shape, dtype=dtype, device=device)
    out.normal_(0.0, std, generator=generator)
    return out


def init_mlp(cfg, d_model: int, d_ff: int, dtype: torch.dtype,
             device: torch.device, generator: torch.Generator):
    s_in = d_model ** -0.5
    s_ff = d_ff ** -0.5
    if cfg.mlp_type == "swiglu":
        return {
            "w_gate": normal((d_model, d_ff), s_in, dtype, device, generator),
            "w_up": normal((d_model, d_ff), s_in, dtype, device, generator),
            "w_down": normal((d_ff, d_model), s_ff, dtype, device, generator),
        }
    return {
        "w_up": normal((d_model, d_ff), s_in, dtype, device, generator),
        "w_down": normal((d_ff, d_model), s_ff, dtype, device, generator),
    }


def apply_mlp(x, params, cfg, ctx=None, d_ff: int = 0, rows: bool = False):
    """The MLP; under a mesh its ``d_ff`` (the whole width) columns of
    ``w_gate``/``w_up`` and rows of ``w_down`` are split over the tp axis
    where it divides (:func:`tp_mlp`).  ``rows``: ``x`` is this rank's
    rows of the sequence (``seq_parallel``)."""
    split = ctx is not None and tp_split(d_ff, params["w_down"].shape[0],
                                         ctx, "MLP width")
    mlp = swiglu_mlp if cfg.mlp_type == "swiglu" else _gelu_mlp
    return tp_mlp(x, params, mlp, ctx, split, rows)


def swiglu_mlp(x, p):
    return swiglu(x, p["w_gate"], p["w_up"], p["w_down"])


def _gelu_mlp(x, p):
    return gelu_mlp(x, p["w_up"], p["w_down"])


def tp_mlp(x, params, mlp, ctx, split: bool, rows: bool = False):
    """``mlp(x, params)`` of an MLP whose hidden columns the tp axis
    splits (``split``: ``x`` enters the rank's columns and the
    row-parallel down product is summed over the ranks) or not.
    ``rows``: ``x`` is this rank's rows of the sequence: a split MLP
    gathers them and reduce-scatters its output; one whole on every rank
    runs on the rows, its weights entering them."""
    if rows:
        if split:
            return seq_scatter(mlp(seq_gather(x, ctx, summed=True), params),
                               ctx)
        return mlp(x, tp_enter_tree(params, ctx))
    if split:
        return tp_all_reduce(mlp(tp_enter(x, ctx), params), ctx)
    return mlp(x, params)
