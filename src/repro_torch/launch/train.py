"""Training launcher, on the GPU by default.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \
      --steps 20 --batch 4 --seq 2048

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \
      --reduced --steps 20 --batch 8 --seq 128 --device cpu

Random weights from seed 0; batches as the JAX launcher draws them
(:func:`make_batch`): a VLM (``uses_extra_embeds``) trains on float32
``embeds`` and labels from ``np.random.default_rng(0)``, a K-codebook
model on ``[B, S, K]`` tokens from that generator (labels = tokens),
every other arch (dense, MoE, Mamba2, hybrid) on ``token_stream(seq,
vocab, seed=step, batch=batch)`` with ``labels = tokens``.  Training on
a mesh is ``train_step(..., ctx=)`` on every rank of
``launch.mesh.spawn``; the production meshes' per-device bytes and
collectives come from the dry run, :mod:`repro_torch.launch.dryrun`.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import get_config, get_reduced
from repro_torch.data.synthetic import token_stream
from repro_torch.device import resolve_device, synchronize
from repro_torch.models.model import init_params
from repro_torch.train import optimizer as opt
from repro_torch.train.train_step import train_step


def make_batch(cfg, batch: int, seq: int, step: int,
               rng: np.random.Generator):
    """Batch ``step`` of the JAX launcher (``repro/launch/train.py``), as
    numpy arrays: float32 ``embeds`` [B, S, d] and int32 labels from
    ``rng`` for a VLM; int32 [B, S, K] tokens from ``rng`` with K
    codebooks; else ``token_stream``.  Labels are the tokens."""
    if cfg.uses_extra_embeds:
        return {"embeds": rng.normal(0, 1, (batch, seq, cfg.d_model))
                .astype(np.float32),
                "labels": rng.integers(0, cfg.vocab_size, (batch, seq))
                .astype(np.int32)}
    if cfg.num_codebooks:
        toks = rng.integers(0, cfg.vocab_size,
                            (batch, seq, cfg.num_codebooks)).astype(np.int32)
    else:
        toks = token_stream(seq, cfg.vocab_size, seed=step, batch=batch)
    return {"tokens": toks, "labels": toks}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="train the reduced variant (CPU-sized)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt", default=None, help="checkpoint path prefix")
    ap.add_argument("--save-every", type=int, default=100)
    ap.add_argument("--resume", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain PyTorch path)")
    args = ap.parse_args(argv)

    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    if args.reduced:
        cfg = dataclasses.replace(cfg, dtype="float32")
    dev = resolve_device(args.device)
    params = init_params(cfg, seed=0, device=dev)
    ocfg = opt.AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 1))
    state = opt.init(params)
    start = 0
    if args.resume:
        from repro_torch.train.checkpoint import restore
        params, state, start = restore(args.resume, params, state)
        print(f"resumed from {args.resume} at step {start}")

    rng = np.random.default_rng(0)
    synchronize(dev)
    t0 = time.perf_counter()
    for step in range(args.steps):
        batch = {k: torch.from_numpy(v).to(dev) for k, v in make_batch(
            cfg, args.batch, args.seq, step, rng).items()}
        params, state, metrics = train_step(cfg, ocfg, params, state, batch)
        if step % 10 == 0 or step == args.steps - 1:
            loss = float(metrics["loss"])
            synchronize(dev)
            print(f"step {step:4d} loss {loss:.4f} "
                  f"({(time.perf_counter() - t0) / (step + 1):.2f}s/step)")
        if args.ckpt and (step + 1) % args.save_every == 0:
            from repro_torch.train.checkpoint import save
            save(args.ckpt, params, state, step=start + step + 1,
                 meta={"arch": cfg.name})


if __name__ == "__main__":
    main()
