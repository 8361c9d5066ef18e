"""Adaptive step-size controller (paper §3.2.1, §3.2.2 feedback loop).

The step size S — how many layers ahead expert activations are predicted and
prefetched — is initialised from the paper's formula

    S = (N_e * E_s) / (C_s * T_l)

and adjusted at runtime by a stall/overfetch counter pair:
- a *stall* (a predicted expert not resident when its layer starts) bumps the
  stall counter; past `stall_threshold` the counter resets and S += 1;
- an *overfetch* (expert resident well before need / never used) bumps the
  overfetch counter; past `overfetch_threshold` it resets and S -= 1.

All state is host-side Python — faithful to the paper's CPU-resident
controller design (§3.2.5).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional

import numpy as np


@dataclass
class StepSizeConfig:
    s_min: int = 1
    s_max: int = 12
    stall_threshold: int = 3        # stalls before S += 1
    overfetch_threshold: int = 4    # overfetches before S -= 1
    cum_prob_threshold: float = 0.7  # pre-gate cumulative-probability cut
    bandwidth_ema: float = 0.3      # EWMA factor for C_s updates
    # §3.3.2 coordination guard: when prefetched-but-unused evictions are
    # happening, stalls are CAPACITY thrash, not bandwidth lateness —
    # raising S then adds outstanding prefetches and feeds the spiral.
    capacity_guard: bool = True
    # §3.4 cache-aware routing strength ceiling (router-logit units): the
    # controller modulates its `route_bias` within [0, route_bias_max] from
    # the same stall/overfetch thresholds that move S. 0 keeps the
    # perturbation off entirely (the controller never raises it).
    route_bias_max: float = 0.0
    # fraction of route_bias_max moved per threshold event (stall -> up,
    # overfetch -> down): stalls ramp the residency bias toward the ceiling
    # in 1/route_bias_step events; sustained overfetch relaxes it back.
    route_bias_step: float = 0.25


def expected_active_experts(pregate_probs: np.ndarray,
                            threshold: float) -> int:
    """Paper §3.2.1: count experts, in descending probability, until their
    cumulative mass exceeds `threshold`. probs: (E,) or (T, E) (averaged)."""
    p = np.asarray(pregate_probs, np.float64)
    if p.ndim == 2:
        p = p.mean(axis=0)
    p = p / max(p.sum(), 1e-12)
    order = np.sort(p)[::-1]
    cum = np.cumsum(order)
    # searchsorted returns E when threshold exceeds the reachable cumulative
    # mass (e.g. threshold=1.0 against a float sum of 0.9999...), which
    # would report E+1 "active" experts and inflate the initial-S formula —
    # the count is a set size, clamp it to [1, E]
    return int(np.clip(np.searchsorted(cum, threshold) + 1, 1, len(cum)))


def initial_step_size(n_experts_active: float, expert_bytes: float,
                      bandwidth_bytes_per_s: float,
                      layer_compute_s: float,
                      cfg: Optional[StepSizeConfig] = None) -> int:
    """S = N_e * E_s / (C_s * T_l), clamped to [s_min, s_max]."""
    cfg = cfg or StepSizeConfig()
    denom = max(bandwidth_bytes_per_s * layer_compute_s, 1e-12)
    s = (n_experts_active * expert_bytes) / denom
    return int(np.clip(round(s), cfg.s_min, cfg.s_max))


@dataclass
class StepSizeController:
    """Runtime S controller with stall/overfetch feedback (paper §3.2.2)."""

    cfg: StepSizeConfig = field(default_factory=StepSizeConfig)
    s: int = 2
    stall_counter: int = 0
    overfetch_counter: int = 0
    bandwidth_est: float = 16e9      # C_s, bytes/s (updated from transfers)
    layer_time_est: float = 1e-3     # T_l, seconds (updated from compute)
    # §3.4 cache-aware routing strength (router-logit units), modulated by
    # the same stall/overfetch thresholds that move S: stalls push routing
    # toward already-resident experts, sustained overfetch (spare capacity)
    # relaxes the perturbation back toward gate-only routing.
    route_bias: float = 0.0
    # capacity-guard observability: times the §3.3.2 guard consumed an
    # overfetch instead of raising S. Without this, "S held flat by the
    # guard under churn" is indistinguishable from "no stalls at all".
    guard_hits: int = 0
    # history for diagnostics / EXPERIMENTS.md
    s_history: list = field(default_factory=list)

    # -- initialisation ------------------------------------------------------
    def initialize(self, pregate_probs: np.ndarray, expert_bytes: float,
                   token_diversity: float = 0.0) -> int:
        """Set the initial S from the formula; `token_diversity` (Dist(t),
        Observation III) scales the expected expert count: semantically
        diverse batches activate more distinct experts."""
        n_e = expected_active_experts(pregate_probs, self.cfg.cum_prob_threshold)
        n_e = n_e * (1.0 + min(token_diversity, 1.0))
        self.s = initial_step_size(n_e, expert_bytes, self.bandwidth_est,
                                   self.layer_time_est, self.cfg)
        self.s_history.append(self.s)
        return self.s

    # -- feedback ------------------------------------------------------------
    def _move_route_bias(self, direction: float) -> None:
        """Shift the §3.4 routing-perturbation strength one threshold step
        (fraction `route_bias_step` of the ceiling) up or down, clamped to
        [0, route_bias_max]. A zero ceiling keeps the perturbation off."""
        m = self.cfg.route_bias_max
        if m <= 0.0:
            return
        self.route_bias = float(np.clip(
            self.route_bias + direction * self.cfg.route_bias_step * m,
            0.0, m))

    def record_stall(self, n: int = 1) -> None:
        self.stall_counter += n
        if self.stall_counter >= self.cfg.stall_threshold:
            self.stall_counter = 0
            # stalls also push routing toward resident experts (§3.4): the
            # residency bias attacks the same misses S would, without
            # spending link bandwidth
            self._move_route_bias(+1.0)
            if self.cfg.capacity_guard and self.overfetch_counter > 0:
                # cache is evicting unused prefetches: the stall is capacity
                # thrash — deeper lookahead would make it worse. Consume one
                # overfetch instead of raising S (§3.3.2 coordination).
                self.overfetch_counter -= 1
                self.guard_hits += 1
                return
            if self.s < self.cfg.s_max:
                self.s += 1
                self.s_history.append(self.s)

    def record_overfetch(self, n: int = 1) -> None:
        self.overfetch_counter += n
        if self.overfetch_counter >= self.cfg.overfetch_threshold:
            self.overfetch_counter = 0
            # spare residency headroom: relax the routing perturbation
            # before shrinking the prefetch horizon
            self._move_route_bias(-1.0)
            if self.s > self.cfg.s_min:
                self.s -= 1
                self.s_history.append(self.s)

    def record_hit(self) -> None:
        """Predicted expert was resident exactly when needed — no change."""

    # -- coordination with memory manager (§3.3.2) -----------------------------
    def update_bandwidth(self, bytes_moved: float, seconds: float) -> None:
        if seconds <= 0:
            return
        obs = bytes_moved / seconds
        a = self.cfg.bandwidth_ema
        self.bandwidth_est = (1 - a) * self.bandwidth_est + a * obs

    def update_layer_time(self, seconds: float) -> None:
        a = self.cfg.bandwidth_ema
        self.layer_time_est = (1 - a) * self.layer_time_est + a * seconds

    # -- diagnostics ---------------------------------------------------------
    def horizon(self, n_layers_remaining: int) -> int:
        """Effective lookahead for the next dispatch: S clamped to what is
        left of the layer sweep (predicting past the last MoE layer only
        wastes pre-gate compute and link budget)."""
        return int(max(0, min(self.s, n_layers_remaining)))

    def snapshot(self) -> dict:
        """Controller state for benchmarks / EXPERIMENTS records."""
        return {
            "s": self.s,
            "stall_counter": self.stall_counter,
            "overfetch_counter": self.overfetch_counter,
            "bandwidth_est": self.bandwidth_est,
            "layer_time_est": self.layer_time_est,
            "route_bias": self.route_bias,
            "guard_hits": self.guard_hits,
            "s_history": list(self.s_history),
        }


def token_diversity(embeddings: np.ndarray, max_tokens: int = 256) -> float:
    """Cumulative Euclidean distance Dist(t) = sum_{i<j} ||v_i - v_j||
    (paper §2.2 Observation III), normalised by the number of pairs."""
    v = np.asarray(embeddings, np.float64)
    if v.ndim != 2 or v.shape[0] < 2:
        return 0.0
    if v.shape[0] > max_tokens:
        idx = np.linspace(0, v.shape[0] - 1, max_tokens).astype(int)
        v = v[idx]
    sq = np.sum(v * v, axis=1)
    d2 = sq[:, None] + sq[None, :] - 2.0 * (v @ v.T)
    d = np.sqrt(np.maximum(d2, 0.0))
    k = v.shape[0]
    total = float(np.sum(np.triu(d, 1)))
    return total / (k * (k - 1) / 2)
