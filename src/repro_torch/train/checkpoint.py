"""Checkpointing: save/restore a parameter tree and the AdamW state
(counterpart of ``src/repro/train/checkpoint.py``, same file layout).

Format: one ``.npz`` whose keys are ``//``-joined tree paths
(``params//layers//0//attn//wq``, ``mu//…``, ``nu//…``, ``opt_step``) plus
a JSON manifest (``step``, ``meta``, ``has_opt``) beside it, so either
package restores the other's float32 checkpoints.

bfloat16 has no numpy dtype without ``ml_dtypes``, which the port does
not use: a bfloat16 tensor is written as its raw 2-byte words (numpy
``|V2``, the dtype that a JAX bfloat16 leaf also reads back as when
``ml_dtypes`` is not loaded) and read back through an ``int16`` view, bit
for bit.

Under a mesh (``mesh=`` and the ``specs`` the rank's leaves are sliced
by, ``distributed.sharding.rank_specs``) :func:`save` puts every leaf
back together (``sharding.gather_params``) and rank 0 writes the
single-device file, as the JAX ``save`` of global arrays does;
:func:`restore` reads that file on every rank and keeps the rank's
slices.
"""
from __future__ import annotations

import json
import os
from typing import Any, Tuple

import numpy as np
import torch

from repro_torch.train.optimizer import AdamWState

_SEP = "//"
_WORD = np.dtype("V2")


def _flatten(tree, prefix: str) -> dict:
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    flat = {}
    for k, v in items:
        flat.update(_flatten(v, f"{prefix}{_SEP}{k}"))
    return flat


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(_WORD)
    return t.numpy()


def _to_tensor(arr: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)) \
            .view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(arr))
    return t.to(device=like.device, dtype=like.dtype)


def save(path: str, params, opt_state: AdamWState = None, step: int = 0,
         meta: dict = None, mesh=None, specs=None):
    """Write ``params`` (and ``opt_state``) to ``path`` (+ ``.json``).
    ``mesh``: every rank calls this with its slices under ``specs``; the
    whole tree is written by rank 0, and every rank returns once it is
    written."""
    if mesh is not None:
        import torch.distributed as dist
        from repro_torch.distributed.sharding import gather_params
        params = gather_params(params, specs, mesh)
        if opt_state is not None:
            opt_state = AdamWState(
                step=opt_state.step,
                mu=gather_params(opt_state.mu, specs, mesh),
                nu=gather_params(opt_state.nu, specs, mesh))
        if mesh.rank == 0:
            save(path, params, opt_state, step, meta)
        dist.barrier(group=mesh.control_group)
        return
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    payload = {k: _to_numpy(v) for k, v in _flatten(params, "params").items()}
    if opt_state is not None:
        for name in ("mu", "nu"):
            payload.update({k: _to_numpy(v) for k, v in
                            _flatten(getattr(opt_state, name), name).items()})
        payload["opt_step"] = _to_numpy(opt_state.step)
    np.savez(path, **payload)
    with open(path + ".json", "w") as f:
        json.dump({"step": step, "meta": meta or {},
                   "has_opt": opt_state is not None}, f)


def _unflatten_into(template, flat: dict, prefix: str, specs=None,
                    mesh=None):
    if isinstance(template, dict):
        return {k: _unflatten_into(v, flat, f"{prefix}{_SEP}{k}",
                                   None if specs is None else specs[k], mesh)
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(_unflatten_into(
            v, flat, f"{prefix}{_SEP}{i}",
            None if specs is None else specs[i], mesh)
            for i, v in enumerate(template))
    arr = flat[prefix]
    if mesh is not None:
        from repro_torch.distributed.sharding import leaf_index
        arr = arr[leaf_index(arr.shape, specs, mesh)]
    assert arr.shape == tuple(template.shape), (prefix, arr.shape,
                                                template.shape)
    return _to_tensor(arr, template)


def restore(path: str, params_template, opt_template: AdamWState = None,
            mesh=None, specs=None) -> Tuple[Any, Any, int]:
    """Returns (params, opt_state_or_None, step), each tensor with its
    template's dtype and device.  ``mesh``: the templates are this rank's
    slices under ``specs``, and so are the tensors returned."""
    with np.load(path if path.endswith(".npz") else path + ".npz") as z:
        flat = {k: z[k] for k in z.files}
    with open((path if not path.endswith(".npz") else path[:-4]) + ".json"
              if not os.path.exists(path + ".json") else path + ".json") as f:
        manifest = json.load(f)
    params = _unflatten_into(params_template, flat, "params", specs, mesh)
    opt_state = None
    if opt_template is not None and manifest.get("has_opt"):
        mu = _unflatten_into(opt_template.mu, flat, "mu", specs, mesh)
        nu = _unflatten_into(opt_template.nu, flat, "nu", specs, mesh)
        opt_state = AdamWState(step=_to_tensor(flat["opt_step"],
                                               opt_template.step),
                               mu=mu, nu=nu)
    return params, opt_state, manifest["step"]
