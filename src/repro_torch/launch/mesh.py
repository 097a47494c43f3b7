"""Device meshes over ``torch.distributed`` process groups (counterpart of
``src/repro/launch/mesh.py``).

The JAX package runs one controller over a mesh of devices; the port
runs one process per mesh position (rank), and a :class:`Mesh` is this
process's view of the grid: the axis names and sizes, its coordinates
and rank, the device it computes on, and the process groups it joins.
Ranks are laid out row-major over the axes, the last (``"model"``, the
tensor-parallel axis) fastest, so the ``tp`` ranks of one data row are
consecutive.

Functions, not module-level constants: importing this module starts no
process and touches no device.

* :func:`make_production_mesh` — the production shape only (16 x 16, or
  2 x 16 x 16 across pods), no processes: the spec arithmetic of
  :mod:`repro_torch.distributed.sharding` and its tests read it.
* :func:`make_host_mesh` — joins the default process group the caller
  started (``torch.distributed.init_process_group``) and builds, on every
  rank in the same order, one group per axis line, one over both axes
  (every rank), and a gloo group over all ranks for host messages (the
  serving engine's step commands).
* :func:`spawn` — starts one process per rank with the ``spawn`` start
  method (a forked child cannot use CUDA once the parent has), joins
  them into a group through a ``TCPStore`` that the parent opens (on a
  port the operating system picks) and holds until the ranks are
  joined, calls
  ``fn(mesh, *args)`` on every rank and returns each rank's result.  On
  the CPU the ranks talk over gloo; on the card over NCCL when every
  rank has a card of its own, else over gloo (NCCL refuses two ranks on
  one device; gloo stages each CUDA collective through the host).

Every group is made with a timeout, so ranks that disagree on what to
run fail with a timeout error instead of hanging.
"""
from __future__ import annotations

import datetime
import itertools
import math
import queue as queue_mod
import time
import traceback
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.device import resolve_device

AXES = ("data", "model")
POD_AXES = ("pod", "data", "model")
DEFAULT_TIMEOUT = 300.0          # seconds a collective may wait


class Mesh:
    """A named grid of ranks.  ``shape`` maps axis name -> size, in axis
    order.  A mesh made by :func:`make_production_mesh` is a shape only
    (``rank`` is None and it has no groups); one made by
    :func:`make_host_mesh` also holds this process's ``rank``,
    ``coords`` (axis -> index), ``device`` and process groups, and
    counts the serving engines built on it (``engines_built``; on a
    rank other than 0, ``followers`` maps each engine's number to the
    engine until rank 0 stops it: ``Engine.follow``)."""

    def __init__(self, shape: Dict[str, int], *, rank: Optional[int] = None,
                 device=None, groups: Optional[Dict[str, object]] = None,
                 control_group=None, timeout: float = DEFAULT_TIMEOUT):
        self.shape = dict(shape)
        self.axis_names = tuple(self.shape)
        self.size = math.prod(self.shape.values())
        self.rank = rank
        self.coords = None if rank is None else coords_of(rank, self.shape)
        self.device = None if device is None else torch.device(device)
        self._groups = groups or {}
        self.control_group = control_group
        self.timeout = timeout
        self.engines_built = 0
        self.followers: Dict[int, object] = {}

    def group(self, axis):
        """The process group over ``axis`` that holds this rank; a tuple
        of both axes names the group of every rank."""
        if axis not in self._groups:
            raise ValueError(f"this mesh has no process group for {axis!r} "
                             "(a shape-only mesh has none)")
        return self._groups[axis]

    def __repr__(self):
        where = "" if self.rank is None else \
            f", rank={self.rank}, coords={self.coords}, device={self.device}"
        return f"Mesh({self.shape}{where})"


def coords_of(rank: int, shape: Dict[str, int]) -> Dict[str, int]:
    """Row-major coordinates of ``rank``, the last axis fastest."""
    out = {}
    for axis in reversed(tuple(shape)):
        rank, out[axis] = divmod(rank, shape[axis])
    return {a: out[a] for a in shape}


def rank_of(coords: Dict[str, int], shape: Dict[str, int]) -> int:
    r = 0
    for axis, n in shape.items():
        r = r * n + coords[axis]
    return r


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The production shape: (16, 16) over ("data", "model"), or (2, 16,
    16) over ("pod", "data", "model") across pods.  Shape only."""
    if multi_pod:
        return Mesh(dict(zip(POD_AXES, (2, 16, 16))))
    return Mesh(dict(zip(AXES, (16, 16))))


def _timeout(seconds: float) -> datetime.timedelta:
    return datetime.timedelta(seconds=seconds)


def make_host_mesh(tp: Optional[int] = None, data: int = 1, *,
                   device=None, timeout: float = DEFAULT_TIMEOUT) -> Mesh:
    """A ``(data, tp)`` mesh over the ranks of the default process group,
    which the caller has started; this process computes on ``device``
    (default: the card, :func:`~repro_torch.device.resolve_device`; pass
    ``"cpu"`` for the plain path).  ``tp`` defaults to every rank not claimed by
    ``data``.  Every rank must call this, with the same arguments: each
    axis line gets a group of its own (the default group's backend), so
    do both axes together (``mesh.group(AXES)``), and all ranks share one
    gloo group for host messages."""
    import torch.distributed as dist
    if not dist.is_initialized():
        raise RuntimeError("make_host_mesh joins a process group the caller "
                           "started: call torch.distributed."
                           "init_process_group first (or use spawn)")
    world = dist.get_world_size()
    if tp is None:
        tp = max(1, world // max(data, 1))
    if data * tp != world:
        raise ValueError(f"a ({data}, {tp}) mesh needs {data * tp} ranks, "
                         f"the process group has {world}")
    shape = dict(zip(AXES, (data, tp)))
    rank = dist.get_rank()
    mine = coords_of(rank, shape)
    td = _timeout(timeout)
    groups = {}
    for axis in AXES:
        others = [a for a in AXES if a != axis]
        # every rank creates every group, in the same order
        for fixed in itertools.product(*(range(shape[a]) for a in others)):
            at = dict(zip(others, fixed))
            ranks = [rank_of({**at, axis: i}, shape)
                     for i in range(shape[axis])]
            g = dist.new_group(ranks, timeout=td)
            if all(mine[a] == at[a] for a in others):
                groups[axis] = g
    # both axes at once: the 2-D expert-parallel MoE sums over them
    groups[AXES] = dist.new_group(list(range(world)), timeout=td)
    control = dist.new_group(list(range(world)), backend="gloo", timeout=td)
    return Mesh(shape, rank=rank, device=resolve_device(device),
                groups=groups, control_group=control, timeout=timeout)


def rank_device(device: str, rank: int, world: int) -> torch.device:
    """The device rank ``rank`` computes on: the CPU, or on the card
    ``cuda:<rank>`` when there is a card for every rank, else ``cuda:0``
    (ranks sharing one card)."""
    dev = torch.device(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    n = torch.cuda.device_count()
    return torch.device("cuda", rank if n >= world else 0)


def default_backend(device: str, world: int) -> str:
    """gloo on the CPU and for ranks sharing a card; NCCL when every rank
    has a card of its own."""
    if torch.device(device).type == "cuda" \
            and torch.cuda.device_count() >= world:
        return "nccl"
    return "gloo"


def _rank_main(rank, world, data, fn, args, port, backend, device, timeout,
               startup, threads, out):
    import torch.distributed as dist
    try:
        if threads:
            torch.set_num_threads(threads)
        dev = rank_device(device, rank, world)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        # a client of the parent's store: the parent listens already, so
        # no rank has a port to open
        store = dist.TCPStore("localhost", port, world, is_master=False,
                              timeout=_timeout(timeout))
        # every rank started before the group's first wait, which takes
        # the collectives' timeout: a rank slow to start (its imports on
        # a loaded host) is not a peer that went silent
        store.set(f"up/{rank}", "1")
        store.wait([f"up/{r}" for r in range(world)], _timeout(startup))
        dist.init_process_group(backend, store=store, rank=rank,
                                world_size=world, timeout=_timeout(timeout))
        mesh = make_host_mesh(tp=world // data, data=data, device=dev,
                              timeout=timeout)
        out.put((rank, True, fn(mesh, *args)))
    except Exception:                              # noqa: BLE001
        # the parent reports it and stops the other ranks
        out.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn: Callable, tp: int, args: Sequence = (), *, data: int = 1,
          device: Optional[str] = None, backend: Optional[str] = None,
          timeout: float = DEFAULT_TIMEOUT, threads: Optional[int] = None,
          deadline: Optional[float] = None) -> List:
    """Run ``fn(mesh, *args)`` on ``data * tp`` spawned ranks and return
    their results in rank order.

    ``fn`` and ``args`` must pickle (a module-level function; numpy arrays
    and plain values), and so must each result.  ``device``: ``"cuda"``
    (the default; raises when there is no card) or ``"cpu"`` (see
    :func:`rank_device`); ``backend`` defaults to
    :func:`default_backend`.  ``timeout``: seconds any collective may
    wait; ``threads``: ``torch.set_num_threads`` in each rank;
    ``deadline``: seconds the whole run may take, and the longest a rank
    waits for the others to start (default: four times ``timeout``).  If
    a rank raises, the others are stopped and a
    ``RuntimeError`` carries its traceback.

    The rendezvous is a ``TCPStore`` this process opens on port 0 (the
    operating system picks a free one and the store keeps listening on
    it) and holds until every rank has returned: no port is read, closed
    and reopened, so concurrent calls never race for one."""
    import multiprocessing as mp

    import torch.distributed as dist
    world = data * tp
    device = str(resolve_device(device))
    backend = backend or default_backend(device, world)
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    store = dist.TCPStore("localhost", 0, world, is_master=True,
                          wait_for_workers=False, timeout=_timeout(timeout))
    limit = 4 * timeout if deadline is None else deadline
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, data, fn, tuple(args), store.port,
                               backend, device, timeout, limit, threads,
                               out),
                         daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    results: Dict[int, object] = {}
    error: Optional[Tuple[int, str]] = None
    end = time.monotonic() + limit
    try:
        while len(results) < world and error is None:
            left = end - time.monotonic()
            if left <= 0:
                error = (-1, f"ranks still running after {limit:.0f} s")
                break
            try:
                rank, ok, val = out.get(timeout=min(left, 1.0))
            except queue_mod.Empty:
                dead = [p for p in procs if p.exitcode not in (None, 0)]
                if dead and out.empty():
                    error = (procs.index(dead[0]),
                             f"exited with code {dead[0].exitcode}")
                continue
            if ok:
                results[rank] = val
            else:
                error = (rank, val)
    finally:
        for p in procs:
            if error is not None and p.is_alive():
                p.terminate()
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
        out.close()
        del store                  # the ranks are joined: stop listening
    if error is not None:
        raise RuntimeError(f"rank {error[0]} of {world} failed:\n{error[1]}")
    return [results[r] for r in range(world)]

