"""Architecture registry: ``--arch <id>`` resolution for the ported configs.

The port carries the architectures its runtime supports so far (GQA and
MLA MoE models); the rest of the reference registry arrives with the slices
that port their layer kinds.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import ModelConfig

# arch id -> module name
_MODULES: Dict[str, str] = {
    "olmoe-1b-7b": "olmoe_1b_7b",
    "deepseek-v2-lite": "deepseek_v2_lite",
}

ARCH_IDS: List[str] = list(_MODULES)


def _module(arch: str):
    if arch not in _MODULES:
        raise KeyError(f"unknown arch '{arch}'; known: {sorted(_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).smoke()
