"""Rank functions of the mesh training tests: each runs in one process per
rank of a ``(data, tp)`` mesh, started by ``repro_torch.launch.mesh.spawn``,
and imports torch and the port only (never JAX).  Inputs arrive as numpy
trees and plain values; results go back the same way, each rank's in a
dict."""
from __future__ import annotations

import hashlib

import numpy as np
import torch

from repro_torch.bridge import from_jax_params
from repro_torch.distributed import sharding as sh
from repro_torch.kernels import ops
from repro_torch.models.model import forward_full
from repro_torch.train import checkpoint
from repro_torch.train import optimizer as opt
from repro_torch.train.train_step import loss_and_grads, train_step


def named(tree, prefix=""):
    """(path, leaf) over a tree of dicts and lists, a spec ``P`` a
    leaf."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from named(v, f"{prefix}.{k}" if prefix else k)
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from named(v, f"{prefix}[{i}]")
    else:
        yield prefix, tree


def _np(tree):
    return {p: t.detach().cpu().numpy() for p, t in named(tree)}


def _digest(t):
    return hashlib.sha1(t.detach().cpu().contiguous().numpy().tobytes()) \
        .hexdigest()


def _slices(params, whole, specs, mesh):
    """Each leaf's slice on this rank: the start of each dim."""
    return dict(named(sh.tree_map(
        lambda t, w, s: tuple(i.start for i in sh.leaf_index(
            np.shape(w), s, mesh)), params, whole, specs)))


def train_job(mesh, job):
    """One job on this rank: the params of ``job["tree"]`` (whole, numpy)
    placed under ``job["par"]``; ``loss_and_grads`` on the first global
    batch, then ``job["steps"]`` train steps on the next ones.  Returns
    the loss and metrics, the gathered gradients and params (rank 0), the
    rank's leaf shapes and slices, digests of every param and moment
    leaf, each step's metrics, and whether a checkpoint saved under the
    mesh restores this rank's slices bit for bit."""
    cfg = job["cfg"]
    par = sh.ParallelismConfig(**job["par"])
    ctx = sh.make_ctx(mesh, par)
    specs = sh.rank_specs(cfg, mesh, par)
    params = from_jax_params(job["tree"], "cpu", mesh, cfg=cfg,
                             parallelism=par)
    batches = [sh.shard_batch({k: torch.from_numpy(v) for k, v in b.items()},
                              cfg, mesh, par) for b in job["batches"]]
    out = {"rank": mesh.rank, "coords": dict(mesh.coords),
           "shapes": {p: tuple(t.shape) for p, t in named(params)},
           "slices": _slices(params, job["tree"], specs, mesh)}
    loss, metrics, grads = loss_and_grads(cfg, params, batches[0], ctx=ctx)
    out.update(loss=float(loss), lm_loss=float(metrics["lm_loss"]),
               aux=float(metrics["aux_loss"]))
    whole = sh.gather_params(grads, specs, mesh)
    if mesh.rank == 0:
        out["grads"] = _np(whole)
    del grads, whole
    if job.get("logits"):
        # the forward alone on the first batch's rows of this data rank,
        # with the (q rows, keys, q_offset) of each flash-attention call
        calls, flash = [], ops.flash_attention

        def record(q, k, v, **kw):
            calls.append((q.shape[1], k.shape[1], kw.get("q_offset", 0)))
            return flash(q, k, v, **kw)
        ops.flash_attention = record
        try:
            with torch.no_grad():
                logits = forward_full(params, cfg,
                                      tokens=batches[0]["tokens"],
                                      ctx=ctx)[0]
        finally:
            ops.flash_attention = flash
        out["logits"] = logits.numpy()
        out["attention_calls"] = calls
    steps = job.get("steps", 0)
    if not steps:
        return out
    state = opt.init(params)
    ocfg = opt.AdamWConfig(**job["opt"])
    out["steps"] = []
    for b in batches[1:1 + steps]:
        params, state, m = train_step(cfg, ocfg, params, state, b, ctx=ctx)
        out["steps"].append({k: float(v) for k, v in m.items()})
    out["digests"] = {
        p: (_digest(t), _digest(mu), _digest(nu))
        for (p, t), (_, mu), (_, nu) in zip(named(params), named(state.mu),
                                            named(state.nu))}
    whole = sh.gather_params(params, specs, mesh)
    whole_state = opt.AdamWState(step=state.step,
                                 mu=sh.gather_params(state.mu, specs, mesh),
                                 nu=sh.gather_params(state.nu, specs, mesh))
    if mesh.rank == 0:
        out["params"] = _np(whole)
    if job.get("ckpt"):
        path = job["ckpt"]
        checkpoint.save(path, params, state, step=steps, mesh=mesh,
                        specs=specs)
        if mesh.rank == 0:
            # the single-device file of the gathered tree
            checkpoint.save(path + "-single", whole, whole_state,
                            step=steps)
        zeros = lambda tree: opt.tree_map(torch.zeros_like, tree)
        template = opt.AdamWState(step=torch.zeros_like(state.step),
                                  mu=zeros(state.mu), nu=zeros(state.nu))
        got, got_state, step = checkpoint.restore(
            path, zeros(params), template, mesh=mesh, specs=specs)
        same = all(torch.equal(a, b) for a, b in zip(
            opt.leaves((params, state.mu, state.nu)),
            opt.leaves((got, got_state.mu, got_state.nu))))
        out["restored"] = same and step == steps and \
            int(got_state.step) == int(state.step)
    return out


def train_suite(mesh, jobs):
    """:func:`train_job` over ``jobs`` in turn on this rank."""
    torch.manual_seed(0)
    return [train_job(mesh, job) for job in jobs]
