"""Architecture registry: ``--arch <id>`` resolution for the ported configs.

The port carries every architecture of the reference: the attention-only
ones (GQA, MHA or MLA attention, global or sliding-window, dense or MoE
FFN), recurrentgemma (RG-LRU and local attention), xlstm (mLSTM and sLSTM)
and whisper (encoder-decoder). The serving runtime takes the MoE models
among them (olmoe, DeepSeek-V2-Lite and the three Qwen MoE models); the
plain `Model` API and training take all.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import ModelConfig

# arch id -> module name
_MODULES: Dict[str, str] = {
    "llava-next-34b": "llava_next_34b",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "gemma2-9b": "gemma2_9b",
    "minicpm3-4b": "minicpm3_4b",
    "command-r-plus-104b": "command_r_plus_104b",
    "yi-9b": "yi_9b",
    "deepseek-v2-lite": "deepseek_v2_lite",
    "qwen1.5-moe-a2.7b": "qwen15_moe_a2_7b",
    "qwen2-moe-57b": "qwen2_moe_57b",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "xlstm-1.3b": "xlstm_1_3b",
    "whisper-large-v3": "whisper_large_v3",
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
