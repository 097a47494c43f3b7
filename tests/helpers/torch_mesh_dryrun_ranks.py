"""Rank functions of the dry-run tests: each runs in one process per rank
of a ``(data, tp)`` mesh, started by ``repro_torch.launch.mesh.spawn``,
and imports torch and the port only.  Each case runs one step of the
port on this rank and returns the collectives it issued, by kind
(``layers.collective_counts``)."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.distributed import sharding as sh
from repro_torch.models.cache import init_paged_cache
from repro_torch.models.layers import (collective_counts,
                                       reset_collective_counts)
from repro_torch.models.model import forward_decode_paged, init_params
from repro_torch.train import optimizer as opt
from repro_torch.train.train_step import train_step


def global_batch(cfg, batch: int, seq: int, rng):
    """Tokens ([B, S], [B, S, K] with K codebooks) or a VLM's float32
    embeds, and labels like the tokens."""
    if cfg.uses_extra_embeds:
        return {"embeds": torch.from_numpy(
                    rng.normal(0, 1, (batch, seq, cfg.d_model))
                    .astype(np.float32)),
                "labels": torch.from_numpy(rng.integers(
                    0, cfg.vocab_size, (batch, seq)).astype(np.int32))}
    shape = (batch, seq, cfg.num_codebooks) if cfg.num_codebooks > 1 \
        else (batch, seq)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, shape)
                            .astype(np.int32))
    return {"tokens": toks, "labels": toks.clone()}


def tally_case(mesh, case):
    """One step of ``case`` (``cfg``, ``par`` fields, ``kind`` "train" |
    "decode", global ``batch`` and ``seq``) on this rank: the params drawn
    whole from seed 0 and sliced, the batch's rows of this data rank (all
    of them where the data axis does not divide it); a train step, or
    one paged decode round over as many slots as the rank has rows.
    Returns the step's collectives by kind."""
    cfg = case["cfg"]
    par = sh.ParallelismConfig(**case["par"])
    if case["kind"] != "train":          # as the engine serves
        par = dataclasses.replace(par, attn_sharding="none")
    ctx = sh.make_ctx(mesh, par)
    specs = sh.rank_specs(cfg, mesh, par)
    params = sh.shard_params(init_params(cfg, seed=0, device="cpu"), specs,
                             mesh)
    rng = np.random.default_rng(0)
    seq = case["seq"] if case["kind"] == "train" else 1
    batch = sh.shard_batch(global_batch(cfg, case["batch"], seq, rng), cfg,
                           mesh, par)
    if case["kind"] == "train":
        state = opt.init(params)
        reset_collective_counts()
        train_step(cfg, opt.AdamWConfig(), params, state, batch, ctx=ctx)
        return collective_counts()
    rows = next(iter(batch.values())).shape[0]
    cache = init_paged_cache(cfg, rows, 64, 2, 16, device=torch.device("cpu"),
                             mesh=mesh, parallelism=par)
    cache["pos"].fill_(5)
    reset_collective_counts()
    with torch.no_grad():
        forward_decode_paged(params, cfg, tokens=batch.get("tokens"),
                             embeds=batch.get("embeds"), cache=cache,
                             ctx=ctx)
    return collective_counts()


def tally_suite(mesh, cases):
    """:func:`tally_case` over ``cases`` in turn on this rank."""
    torch.manual_seed(0)
    return [tally_case(mesh, case) for case in cases]
