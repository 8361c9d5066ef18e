"""Architecture registry: ``--arch <id>`` resolution for the ported configs.

The port carries every architecture of the reference: the attention-only
ones (GQA, MHA or MLA attention, global or sliding-window, dense or MoE
FFN), recurrentgemma (RG-LRU and local attention), xlstm (mLSTM and sLSTM)
and whisper (encoder-decoder). The serving runtime takes the MoE models
among them (olmoe, DeepSeek-V2-Lite and the three Qwen MoE models); the
plain `Model` API and training take all.

The shape cells (`SHAPES`) and the arch lists of the dry run are copies of
the reference's: `ASSIGNED_ARCH_IDS` the ten assigned architectures, in the
reference's order, and `PAPER_ARCH_IDS` the paper's own evaluation models.
"""
from __future__ import annotations

import importlib
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

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
ASSIGNED_ARCH_IDS: List[str] = [
    "recurrentgemma-2b", "llava-next-34b", "qwen3-moe-235b-a22b",
    "olmoe-1b-7b", "gemma2-9b", "minicpm3-4b", "command-r-plus-104b",
    "yi-9b", "xlstm-1.3b", "whisper-large-v3"]
PAPER_ARCH_IDS: List[str] = ["deepseek-v2-lite", "qwen1.5-moe-a2.7b",
                             "qwen2-moe-57b"]


def _module(arch: str):
    if arch not in _MODULES:
        raise KeyError(f"unknown arch '{arch}'; known: {sorted(_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).smoke()


# ---------------------------------------------------------------------------
# Shape cells (assigned input shapes)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: Dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}

SHAPE_NAMES = list(SHAPES)


def cell_skip_reason(cfg: ModelConfig, shape: str) -> Optional[str]:
    """Why a (config, shape) cell is not run, or None if it is."""
    if shape == "long_500k" and not cfg.sub_quadratic:
        return ("full-attention arch: 500k KV cache is the super-linear cost "
                "this cell excludes (DESIGN.md §Shape-cell skips)")
    if shape == "long_500k" and cfg.is_encoder_decoder:
        return "enc-dec decoder context is architecturally bounded (448)"
    return None


def all_cells() -> List[Tuple[str, str]]:
    return [(a, s) for a in ASSIGNED_ARCH_IDS for s in SHAPE_NAMES]
