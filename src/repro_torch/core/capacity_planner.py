"""Deployment capacity planner (the tool paper §2.3.1 implies).

Given a model config, a hardware platform, and a device-memory budget, derive
the quantities a deployment must choose before serving:

- how many experts fit (slot-buffer capacity) after the dense/persistent
  parts and the KV-cache budget are reserved;
- the expected per-layer activation count N_e at a routing distribution;
- the initial step size S = N_e*E_s / (C_s*T_l);
- whether steady-state prefetch can hide transfers at all
  (bandwidth feasibility: bytes-needed-per-layer-time <= C_s), and the
  minimum S that makes the pipeline feasible;
- the expected stall per step when infeasible (how far over budget).

Used by launch/serve.py at startup and directly testable — this is the
"does this model fit this box, and with what settings" calculation an SRE
runs before rollout.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.core.step_size import StepSizeConfig, initial_step_size
from repro_torch.simulator.hardware import HardwareSpec, layer_time_decode


@dataclass
class CapacityPlan:
    expert_bytes: float
    dense_bytes: float           # persistent non-expert weights
    kv_bytes: float              # KV cache reservation
    capacity_experts: int        # slots that fit
    total_experts: int
    resident_fraction: float
    n_active_per_layer: float    # expected N_e
    layer_time_s: float
    s_initial: int
    bytes_per_layer_window: float   # expert bytes to move per layer period
    bandwidth_feasible: bool
    min_feasible_s: Optional[int]
    expected_stall_per_layer_s: float

    def summary(self) -> str:
        return (f"experts resident {self.capacity_experts}/{self.total_experts}"
                f" ({self.resident_fraction:.0%}); S0={self.s_initial}; "
                f"{'feasible' if self.bandwidth_feasible else 'infeasible'}"
                f" (min feasible S="
                f"{self.min_feasible_s if self.min_feasible_s else 'none'})")


def _dense_bytes(cfg: ModelConfig, bytes_per_param: float) -> float:
    total = cfg.param_count()
    if cfg.moe is None:
        return total * bytes_per_param
    experts = 0
    for i in range(cfg.num_layers):
        if cfg.is_moe_layer(i):
            experts += cfg.moe.num_experts * 3 * cfg.d_model * cfg.moe.d_expert
    return (total - experts) * bytes_per_param


def expected_active_per_layer(cfg: ModelConfig, batch_tokens: int,
                              concentration: float = 1.0) -> float:
    """E[#distinct experts hit by `batch_tokens` tokens of top-k routing].

    With uniform routing: E = E_tot * (1 - (1 - k/E_tot)^T); `concentration`
    < 1 shrinks the effective expert pool (semantic clustering)."""
    if cfg.moe is None:
        return 0.0
    E = max(cfg.moe.num_experts * concentration, 1.0)
    k = cfg.moe.top_k
    hit = E * (1.0 - (1.0 - min(k / E, 1.0)) ** batch_tokens)
    return float(min(hit, cfg.moe.num_experts))


def plan(cfg: ModelConfig, hw: HardwareSpec, *,
         memory_budget_bytes: Optional[float] = None,
         batch: int = 8, kv_len: int = 1024,
         bytes_per_param: float = 2.0,
         concentration: float = 1.0,
         step_cfg: Optional[StepSizeConfig] = None) -> CapacityPlan:
    assert cfg.moe is not None, "capacity planning applies to MoE configs"
    step_cfg = step_cfg or StepSizeConfig()
    budget = memory_budget_bytes or hw.mem_cap

    e_bytes = cfg.expert_bytes(1) * bytes_per_param
    dense = _dense_bytes(cfg, bytes_per_param)
    hd = cfg.resolved_head_dim
    n_attn = sum(1 for i in range(cfg.num_layers)
                 if cfg.layer_kind(i) == "attn")
    kv = batch * kv_len * cfg.num_kv_heads * hd * 2 * n_attn * bytes_per_param
    if cfg.attention == "mla" and cfg.mla is not None:
        kv = batch * kv_len * (cfg.mla.kv_lora_rank +
                               cfg.mla.qk_rope_head_dim) * n_attn * \
            bytes_per_param

    left = budget - dense - kv
    capacity = max(int(left // e_bytes), 0)
    n_moe_layers = sum(cfg.is_moe_layer(i) for i in range(cfg.num_layers))
    total = n_moe_layers * cfg.moe.num_experts

    n_e = expected_active_per_layer(cfg, batch, concentration)
    t_l = layer_time_decode(cfg, hw, batch, kv_len)
    s0 = initial_step_size(n_e, e_bytes, hw.host_bw, t_l, step_cfg)

    # steady state: per layer period, the miss fraction of N_e experts must
    # transfer within T_l (prefetch depth S only shifts WHEN, not how much)
    resident_frac = min(capacity / max(total, 1), 1.0)
    miss_rate = max(0.0, 1.0 - resident_frac)   # uniform-reuse approximation
    need_bytes = n_e * miss_rate * e_bytes
    feasible = need_bytes <= hw.host_bw * t_l
    min_s = None
    if feasible:
        min_s = max(1, math.ceil(need_bytes / max(hw.host_bw * t_l, 1e-12)))
    stall = max(0.0, need_bytes / hw.host_bw - t_l)
    return CapacityPlan(
        expert_bytes=e_bytes, dense_bytes=dense, kv_bytes=kv,
        capacity_experts=capacity, total_experts=total,
        resident_fraction=resident_frac, n_active_per_layer=n_e,
        layer_time_s=t_l, s_initial=s0,
        bytes_per_layer_window=need_bytes,
        bandwidth_feasible=feasible, min_feasible_s=min_s,
        expected_stall_per_layer_s=stall)
