"""Hardware platform table (paper Table 1 + TPU v5e + the H100 the port
runs on) and cost helpers.

The simulators' compute and transfer durations come from these constants.
`host_bw` is the host<->device expert transfer path (PCIe for the GPUs,
per-host DMA for TPU); `flops` is the dense bf16/fp16 peak used for
per-layer compute-time estimates.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

from repro_torch.configs.base import ModelConfig


@dataclass(frozen=True)
class HardwareSpec:
    name: str
    host_bw: float          # bytes/s host->device (paper Table 1)
    flops: float            # peak FLOP/s (fp16/bf16)
    hbm_bw: float           # bytes/s device memory
    mem_cap: float          # device memory for experts, bytes
    ici_bw: float = 0.0     # inter-chip link bytes/s (TPU)


GB = 1e9
TB = 1e12

PLATFORMS: Dict[str, HardwareSpec] = {
    # paper Table 1 (transfer bandwidth) + public spec sheets (flops/HBM)
    "h20": HardwareSpec("h20", 128 * GB, 148e12, 4.0 * TB, 20 * GB),
    "ascend910b": HardwareSpec("ascend910b", 128 * GB, 320e12, 1.6 * TB, 20 * GB),
    "a100": HardwareSpec("a100", 64 * GB, 312e12, 2.0 * TB, 20 * GB),
    "a6000": HardwareSpec("a6000", 64 * GB, 38.7e12, 0.768 * TB, 20 * GB),
    "rtx4090": HardwareSpec("rtx4090", 32 * GB, 165e12, 1.0 * TB, 20 * GB),
    "arc_b580": HardwareSpec("arc_b580", 16 * GB, 27e12, 0.456 * TB, 12 * GB),
    "rx6500xt": HardwareSpec("rx6500xt", 8 * GB, 16e12, 0.144 * TB, 4 * GB),
    # TPU v5e: 197 TFLOP/s bf16, 819 GB/s HBM, 16 GB, ~50 GB/s/link ICI,
    # host DMA ~32 GB/s per direction
    "tpu_v5e": HardwareSpec("tpu_v5e", 32 * GB, 197e12, 819 * GB, 16 * GB,
                            ici_bw=50 * GB),
    # NVIDIA H100 80GB HBM3 at its 700.00 W power limit (nvidia-smi name
    # and limit). host_bw is measured: the median of the port's pinned
    # host->device expert-copy rates over 15 served runs of chip_smoke.py
    # (48.39-53.30 GB/s, CUDA events on the copy stream). flops (989 TFLOP/s
    # dense bf16) and hbm_bw (3.35 TB/s) are the SXM data sheet's; mem_cap
    # is the paper's 20 GB expert cap (§4.1), as for every platform here.
    "h100": HardwareSpec("h100", 51.63 * GB, 989e12, 3.35 * TB, 20 * GB),
}

# the paper caps GPU memory at 20 GB across platforms (§4.1); the expert
# working set budget is what's left after weights/KV of the dense parts.
DEFAULT_EXPERT_MEM_FRACTION = 0.55


def expert_bytes(cfg: ModelConfig, bytes_per_param: float = 2.0) -> float:
    """E_s: bytes of one routed expert."""
    return float(cfg.expert_bytes(1)) * bytes_per_param


def layer_flops_decode(cfg: ModelConfig, batch: int, kv_len: int) -> float:
    """Approximate per-layer decode FLOPs (one token per sequence)."""
    d = cfg.d_model
    hd = cfg.resolved_head_dim
    H, Hkv = cfg.num_heads, cfg.num_kv_heads
    f = 0.0
    # qkv + out projections
    f += 2.0 * batch * d * (H * hd + 2 * Hkv * hd + H * hd)
    # attention scores/values against kv_len
    f += 2.0 * batch * H * hd * kv_len * 2
    if cfg.moe is not None:
        m = cfg.moe
        f += 2.0 * batch * 3 * d * m.d_expert * m.top_k
        f += 2.0 * batch * 3 * d * (m.d_shared or 0) * m.num_shared_experts
        f += 2.0 * batch * d * m.num_experts  # router
    else:
        f += 2.0 * batch * 3 * d * cfg.d_ff
    return f


def layer_time_decode(cfg: ModelConfig, hw: HardwareSpec, batch: int,
                      kv_len: int, mfu: float = 0.4) -> float:
    """Seconds of compute for one decode layer. Decode is memory-bound at
    small batch: time = max(flops/peak, active bytes/HBM bw)."""
    fl = layer_flops_decode(cfg, batch, kv_len)
    t_compute = fl / (hw.flops * mfu)
    # bytes touched: active expert weights + kv cache read
    d, hd = cfg.d_model, cfg.resolved_head_dim
    by = 2.0 * (cfg.num_heads * hd * d * 2 + cfg.num_kv_heads * hd * d * 2)
    if cfg.moe is not None:
        m = cfg.moe
        n_active = min(m.num_experts, batch * m.top_k)
        by += n_active * 3 * d * m.d_expert * 2.0
        by += m.num_shared_experts * 3 * d * (m.d_shared or 0) * 2.0
    else:
        by += 3 * d * cfg.d_ff * 2.0
    by += batch * kv_len * cfg.num_kv_heads * hd * 2 * 2.0
    t_mem = by / hw.hbm_bw
    return max(t_compute, t_mem)
