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
from repro_torch.train.optimizer import AdamWState


def _tensor(x, device: torch.device) -> torch.Tensor:
    arr = np.asarray(x)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.tensor(arr, device=device)


def from_jax_params(tree, device=None):
    """Map a pytree of arrays (``jax.tree.map(np.asarray, params)``) onto
    torch tensors on ``device`` (default ``cuda``), keeping its structure."""
    dev = resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(conv(v) for v in node)
        return _tensor(node, dev)
    return conv(tree)


def from_jax_opt_state(state, device=None):
    """A JAX ``AdamWState`` of numpy arrays
    (``jax.tree.map(np.asarray, state)``) as the port's
    :class:`~repro_torch.train.optimizer.AdamWState` on ``device``
    (default ``cuda``): the int32 step and the float32 moments."""
    return AdamWState(step=from_jax_params(state.step, device),
                      mu=from_jax_params(state.mu, device),
                      nu=from_jax_params(state.nu, device))
