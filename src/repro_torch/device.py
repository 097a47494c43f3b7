"""Device and dtype resolution shared by the port's entry points."""
from __future__ import annotations

from typing import Optional, Union

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def resolve_device(device: "Optional[Union[str, torch.device]]" = None
                   ) -> torch.device:
    """``None`` means ``cuda``.  A CUDA request without a card raises:
    an entry point never runs on the CPU unless the caller asks."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def torch_dtype(name: "Union[str, torch.dtype]") -> torch.dtype:
    """``ModelConfig.dtype`` string -> torch dtype."""
    if isinstance(name, torch.dtype):
        return name
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"unsupported dtype {name!r}") from None


def upcast(t: torch.Tensor) -> torch.Tensor:
    """``t`` in float32, the dtype the model takes its norms, rotations,
    attention, scans and losses in; a float64 tensor stays float64, so a
    model whose parameters and inputs are float64 runs in float64 from
    end to end (the tests' witness of its float32 rounding)."""
    return t if t.dtype == torch.float64 else t.float()


def synchronize(device: torch.device):
    """Wait for the work queued on the device's current stream, so a host
    clock read after it measures the work and not its launch.  Only that
    stream: a serving loop's prefill must not wait for the rounds another
    loop queued on a stream of its own."""
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()
