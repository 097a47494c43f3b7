"""The MoE FFN's ragged (grouped) product, the counterpart of
``jax.lax.ragged_dot`` (``src/repro/models/moe.py:80-83``): the rows of
``x`` come in consecutive groups, ``group_sizes[g]`` rows each, and
group ``g`` is multiplied by ``w[g]``.

The JAX package runs no Pallas kernel here, and neither does the port:
on a CUDA tensor this is PyTorch's own grouped product,
``torch._grouped_mm``, given the groups' ends as device offsets.  In
bf16 on the H100 it runs one grouped CUTLASS kernel and reads nothing
back to the host, so a decode round through an MoE stack stays free of
host syncs; a loop over the experts would read the group sizes back in
every MoE layer of every round.  In float32 ``_grouped_mm`` takes
PyTorch's own loop over the groups inside the same call, which reads the
offsets back: the float32 parity runs take that route, the bf16 serve
path never does.  ``_grouped_mm`` wants 16-byte-aligned row strides,
which every published expert width has (``[E, d, ff]`` row-major
weights are taken as stored).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

NAME = "ragged_dot"


def ragged_dot_plain(x, w, group_sizes):
    """x: [T, K]; w: [G, K, N]; group_sizes: [G] int (sum <= T).
    -> [T, N] in x's dtype, one product per group over its rows (rows
    past the last group are zero, as in ``jax.lax.ragged_dot``)."""
    # one unbind, not w[g] per group: the backward then stacks the
    # groups' gradients once instead of summing a [G, K, N] zeros per group
    parts, start, ws = [], 0, w.unbind(0)
    for g, n in enumerate(group_sizes.tolist()):
        parts.append(x[start:start + n] @ ws[g])
        start += n
    if start < x.shape[0]:
        parts.append(x.new_zeros((x.shape[0] - start, w.shape[-1])))
    return torch.cat(parts)


def ragged_work(x, w, group_sizes):
    """(bytes, flops): x, w and the group sizes read once, the output
    written once; 2 · rows · K · N for the rows in groups (reads the
    group sizes: a host sync on the card)."""
    rows = int(group_sizes.sum())
    el = x.element_size()
    nbytes = (x.numel() + w.numel() + x.shape[0] * w.shape[-1]) * el + \
        group_sizes.numel() * group_sizes.element_size()
    return nbytes, 2 * rows * w.shape[1] * w.shape[2]


def ragged_dot_cuda(x, w, group_sizes):
    """``torch._grouped_mm`` over the groups' cumulative ends, counted in
    ``LAUNCHES[NAME]``; nothing is read back on the bf16 path."""
    if x.device.type != "cuda":
        raise ValueError("ragged_dot_cuda takes CUDA tensors")
    offs = torch.cumsum(group_sizes, 0, dtype=torch.int32)
    _build.LAUNCHES[NAME] += 1
    return torch._grouped_mm(x, w, offs=offs)
