"""The batched simulated anneal (Algorithm 1) over instances × chains.

Counterpart of the JAX package's jitted anneal program
(``repro/core/annealing_jax.py:519-536``, ``_run_chains`` /
``_run_chains_multi``: a ``lax.while_loop`` over temperature levels
around a ``fori_loop`` of proposals, vmapped over chains and
instances).  It is not a Pallas kernel there but one compiled program
on the device; here it is one launch of the hand-written kernel
``csrc/anneal.cu``, whose header says what bounds it on the card and
how the design answers.  This module holds the kernel's launch wrapper
and its plain PyTorch version, which the CPU path runs and the card is
held to: ``anneal_chain`` (``annealing_jax.py:446-516``) over a leading
(instances, chains) batch, with the level and proposal loops in Python.

Inputs: ``reqc [I, N, 11]`` (the packed coefficient matrix of
``core/annealing_torch._pack``), ``n_valid [I]`` int, ``draws [I, C, P,
4]`` uniforms in reqc's dtype (proposal ``k`` of a chain reads row
``k``).  Returns the best schedule seen by each chain: ``perm [I, C,
N]`` int32, ``bnd [I, C, N]`` bool and ``G [I, C]`` in reqc's dtype.
"""
from __future__ import annotations

import torch

from repro_torch.core import annealing_torch as at
from repro_torch.kernels import _build

NAME = "anneal"
# what the kernel takes: its float64 sums, taken in another order than
# the plain version's, are exact (and so order-free) while 24 bits of
# mantissa + 16 binary orders of latency + log2(N) fit float64's 53, that
# is to N 8192 (tests/test_torch_anneal_order.py)
MAX_N, MAX_BATCH = 8192, 256


def anneal_chains_plain(reqc, n_valid, draws, max_batch: int, T0: float,
                        T_thres: float, tau: float, iters: int,
                        incremental: bool = True):
    """``anneal_chain`` over every (instance, chain), Metropolis
    acceptance and the line-7 early exit included: a chain stops as
    soon as the best schedule it has seen meets every valid SLO (a
    finished chain's state is frozen, as under ``vmap``)."""
    n_inst, chains, n_prop, _ = draws.shape
    n = reqc.shape[-2]
    mb = max_batch
    dt = reqc.dtype
    dev = reqc.device
    rc = reqc.unsqueeze(1).expand(n_inst, chains, n, at._NCOLS)
    nv = n_valid.to(device=dev, dtype=torch.int64).unsqueeze(1).expand(
        n_inst, chains)
    perm_s, perm_a, bnd0 = at._starts(rc, nv, mb)
    if incremental:
        stats_s = at._build_stats(rc, perm_s, bnd0, mb)
        stats_a = at._build_stats(rc, perm_a, bnd0, mb)
        f_s, met_s = at._agg(stats_s, mb)
        f_a, met_a = at._agg(stats_a, mb)
    else:
        f_s, met_s = at._eval_g(rc, perm_s, bnd0)
        f_a, met_a = at._eval_g(rc, perm_a, bnd0)
    pick = f_s >= f_a
    perm = at._pick(pick, perm_s, perm_a)
    f = torch.where(pick, f_s, f_a)
    met = torch.where(pick, met_s, met_a)
    stats = ()
    if incremental:
        stats = tuple(torch.where(pick.reshape(*pick.shape, *[1] * (
            a.dim() - 2)), a, b) for a, b in zip(stats_s, stats_a))
    f_ref = f.clamp_min(1e-12)
    nv_f = nv.to(dt)
    # the temperature recursion in the working dtype, as the reference's
    # while_loop carries it
    T = torch.tensor(T0, dtype=dt, device=dev)
    T0_t = torch.tensor(T0, dtype=dt, device=dev)
    thres = torch.tensor(T_thres, dtype=dt, device=dev)
    tau_t = torch.tensor(tau, dtype=dt, device=dev)
    bnd = bnd0
    bp, bb, bf, bmet = perm, bnd0, f, met
    k = 0
    while True:
        active = (T >= thres) & (bmet < nv_f)
        if not bool(active.any()):
            break
        if k + iters > n_prop:
            raise ValueError(f"draws hold {n_prop} proposals a chain; the "
                             f"schedule needs more than {k}")
        for _ in range(iters):
            op, i, j, u_acc = at._sample_move(draws[:, :, k], nv)
            k += 1
            if incremental:
                ok, _, upd = at._candidate(rc, perm, bnd, stats, op, i, j,
                                           nv, mb)
                f_new, met_new = at._agg_delta(stats, upd[4], upd[5], mb)
            else:
                ok, perm_c, bnd_c = at._structural(perm, bnd, op, i, j, nv,
                                                   mb)
                f_new, met_new = at._eval_g(rc, perm_c, bnd_c)
            p_acc = torch.exp((f_new - f) / (f_ref * T / T0_t))
            accept = active & ok & ((f_new > f) | (u_acc < p_acc))
            if incremental:
                perm, bnd, stats = at._apply(perm, bnd, stats, upd, accept)
            else:
                perm = at._pick(accept, perm_c, perm)
                bnd = at._pick(accept, bnd_c, bnd)
            f = torch.where(accept, f_new, f)
            met = torch.where(accept, met_new, met)
            better = f > bf
            bp = at._pick(better, perm, bp)
            bb = at._pick(better, bnd, bb)
            bf = torch.where(better, f, bf)
            bmet = torch.where(better, met, bmet)
        T = T * tau_t
    return bp.to(torch.int32), bb, bf


def workspace_bytes(n_inst: int, chains: int, n: int, max_batch: int,
                    incremental: bool) -> int:
    """Bytes of global workspace the kernel asks for at these shapes
    (``anneal_workspace_bytes`` in csrc/anneal.cu, which alone decides
    whether a chain's state fits in shared memory): 0 when it does."""
    return int(_build.load("anneal_workspace_bytes")(
        n_inst, chains, n, max_batch, int(incremental)))


def launch_plan(n: int, max_batch: int, incremental: bool) -> dict:
    """The kernel's launch plan at these shapes (``anneal_plan`` in
    csrc/anneal.cu, which alone decides it): ``threads`` a block (32 is
    a warp per chain), and whether the request rows (``reqc_smem``) and
    the per-chain state (``state_smem``) sit in shared memory."""
    code = int(_build.load("anneal_plan")(n, max_batch, int(incremental)))
    return {"threads": code & 0xFFFF, "reqc_smem": bool(code >> 16 & 1),
            "state_smem": bool(code >> 17 & 1)}


def check_inputs(reqc, n_valid, draws, max_batch, T0, T_thres, tau, iters):
    """What the kernel takes: float32 ``reqc [I, N, 11]`` and ``draws
    [I, C, P, 4]``, int32 ``n_valid [I]``, all contiguous on one CUDA
    device; N <= MAX_N, 1 <= max_batch <= MAX_BATCH, and P covering
    every level of the schedule.  Raises otherwise (float64, which the
    CPU oracle path takes, raises TypeError)."""
    for name, t in (("reqc", reqc), ("draws", draws)):
        if t.dtype != torch.float32:
            raise TypeError(f"{NAME}: {name} must be float32 on the card, "
                            f"got {t.dtype}")
    if reqc.dim() != 3 or reqc.shape[-1] != at._NCOLS:
        raise ValueError(f"{NAME}: reqc must be [I, N, {at._NCOLS}], got "
                         f"{tuple(reqc.shape)}")
    n_inst, n, _ = reqc.shape
    if draws.dim() != 4 or draws.shape[0] != n_inst or draws.shape[-1] != 4:
        raise ValueError(f"{NAME}: draws must be [{n_inst}, C, P, 4], got "
                         f"{tuple(draws.shape)}")
    if tuple(n_valid.shape) != (n_inst,) or n_valid.dtype != torch.int32:
        raise ValueError(f"{NAME}: n_valid must be int32 [{n_inst}], got "
                         f"{n_valid.dtype} {tuple(n_valid.shape)}")
    for name, t in (("reqc", reqc), ("n_valid", n_valid), ("draws", draws)):
        if t.device.type != "cuda" or t.device != reqc.device \
                or not t.is_contiguous():
            raise ValueError(f"{NAME}: {name} must be a contiguous CUDA "
                             f"tensor on {reqc.device}, got {t.device}")
    if not 1 <= n <= MAX_N or not 1 <= max_batch <= MAX_BATCH:
        raise ValueError(f"{NAME}: N={n}, max_batch={max_batch}; the kernel "
                         f"takes N <= {MAX_N}, max_batch <= {MAX_BATCH}")
    need = at.temperature_levels(T0, T_thres, tau) * iters
    if draws.shape[2] < need:
        raise ValueError(f"{NAME}: draws hold {draws.shape[2]} proposals a "
                         f"chain; the schedule needs {need}")
    if n_inst * draws.shape[1] > 2 ** 31 - 1 or iters < 1:
        raise ValueError(f"{NAME}: {n_inst} x {draws.shape[1]} chains, "
                         f"iters={iters}")
    return n_inst, draws.shape[1], n


def anneal_chains_cuda(reqc, n_valid, draws, max_batch: int, T0: float,
                       T_thres: float, tau: float, iters: int,
                       incremental: bool = True):
    """Launch the kernel on the current stream: one block per (instance,
    chain), the whole anneal inside it.  The per-chain state lives in
    shared memory when it fits, else in a workspace from ``torch.empty``
    of the size the kernel asks for.  Raises on anything the kernel does
    not take; never falls back."""
    n_inst, chains, n = check_inputs(reqc, n_valid, draws, max_batch, T0,
                                     T_thres, tau, iters)
    dev = reqc.device
    perm = torch.empty((n_inst, chains, n), dtype=torch.int32, device=dev)
    bnd = torch.empty((n_inst, chains, n), dtype=torch.bool, device=dev)
    g = torch.empty((n_inst, chains), dtype=torch.float32, device=dev)
    work = torch.empty(
        workspace_bytes(n_inst, chains, n, max_batch, incremental),
        dtype=torch.uint8, device=dev)
    err = _build.load(NAME)(
        reqc.data_ptr(), n_valid.data_ptr(), draws.data_ptr(),
        perm.data_ptr(), bnd.data_ptr(), g.data_ptr(), work.data_ptr(),
        n_inst, chains, n, draws.shape[2], max_batch, iters,
        int(incremental), float(T0), float(T_thres), float(tau),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(NAME, err)
    _build.LAUNCHES[NAME] += 1
    return perm, bnd, g
