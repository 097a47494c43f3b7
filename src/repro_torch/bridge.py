"""Parameters (and AdamW state) of the JAX package, as numpy arrays,
into the port.

The port keeps the JAX parameter layout (``x @ w`` with ``w: [d_in,
d_out]``, float32 norm scales, the same nesting of dicts and lists), so
the bridge is a straight copy.  JAX bfloat16 arrays arrive as numpy
arrays of ``ml_dtypes.bfloat16``, which ``torch.from_numpy`` refuses:
they go through float32 (exact for every bfloat16 value) and back.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import tree_map
from repro_torch.train.optimizer import AdamWState


def _tensor(x, device: torch.device) -> torch.Tensor:
    arr = np.asarray(x)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.tensor(arr, device=device)


def from_jax_params(tree, device=None, mesh=None, *, cfg=None,
                    parallelism=None):
    """Map a pytree of arrays (``jax.tree.map(np.asarray, params)``) onto
    torch tensors on ``device`` (default ``cuda``), keeping its structure.

    With ``mesh`` (a rank's :class:`~repro_torch.launch.mesh.Mesh`) and
    the model's ``cfg``: only this rank's slice of each leaf, as
    ``Engine(mesh=...)`` places it (``distributed.sharding``:
    ``param_specs`` then ``placement_specs``, under ``parallelism``,
    default the serving one; ``ParallelismConfig(fsdp=True)`` places the
    FSDP shards a mesh trains on), so a rank never copies the whole
    tree."""
    dev = resolve_device(device)
    if mesh is None:
        return tree_map(lambda a: _tensor(a, dev), tree)
    if cfg is None:
        raise ValueError("from_jax_params needs the model's cfg to slice "
                         "the params for a mesh")
    from repro_torch.distributed.sharding import (ParallelismConfig,
                                                  leaf_index, param_specs,
                                                  placement_specs)
    par = parallelism or ParallelismConfig(fsdp=False)
    arrays = tree_map(np.asarray, tree)
    specs = placement_specs(param_specs(arrays, cfg, mesh, par), cfg, mesh,
                            par)
    return tree_map(lambda a, spec: _tensor(np.ascontiguousarray(
        a[leaf_index(a.shape, spec, mesh)]), dev), arrays, specs)


def from_jax_opt_state(state, device=None, mesh=None, *, cfg=None,
                       parallelism=None):
    """A JAX ``AdamWState`` of numpy arrays
    (``jax.tree.map(np.asarray, state)``) as the port's
    :class:`~repro_torch.train.optimizer.AdamWState` on ``device``
    (default ``cuda``): the int32 step and the float32 moments.  With
    ``mesh``, ``cfg`` and ``parallelism``: this rank's slice of each
    moment, sliced as :func:`from_jax_params` slices its param."""
    place = lambda tree: from_jax_params(tree, device, mesh, cfg=cfg,
                                         parallelism=parallelism)
    return AdamWState(step=from_jax_params(state.step, device),
                      mu=place(state.mu), nu=place(state.nu))
