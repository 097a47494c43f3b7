"""Architecture registry: ``get_config(arch_id)`` / ``--arch <id>``.

The ten assigned architectures plus the paper's own evaluation model.
Every config cites its source paper / model card in its module docstring.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.models.config import ModelConfig, reduced

_MODULES = {
    "qwen2-vl-7b": "qwen2_vl_7b",
    "musicgen-medium": "musicgen_medium",
    "starcoder2-3b": "starcoder2_3b",
    "phi4-mini-3.8b": "phi4_mini_3_8b",
    "dbrx-132b": "dbrx_132b",
    "zamba2-1.2b": "zamba2_1_2b",
    "mamba2-780m": "mamba2_780m",
    "h2o-danube-1.8b": "h2o_danube_1_8b",
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
    "qwen3-1.7b": "qwen3_1_7b",
    "qwen2.5-7b": "qwen2_5_7b",       # the paper's evaluation model
}

ASSIGNED = [k for k in _MODULES if k != "qwen2.5-7b"]


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch '{arch_id}'; known: {list(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    return mod.CONFIG


def get_reduced(arch_id: str, **kw) -> ModelConfig:
    return reduced(get_config(arch_id), **kw)


def all_configs() -> Dict[str, ModelConfig]:
    return {k: get_config(k) for k in _MODULES}
