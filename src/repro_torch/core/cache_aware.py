"""Cache-aware routing (paper §3.4), the port's own copy.

Two mechanisms, both keyed on expert residency:

1. *Scheduling* (offline evaluation): tokens whose experts are already
   resident get priority; tokens requiring swap-ins are deferred so their
   transfers overlap with the resident group's compute.
   `split_by_residency` produces the priority permutation;
   `overlap_schedule` computes how much miss latency is hidden.

2. *Bounded routing perturbation* (live serving path): non-resident
   experts' router logits are biased DOWN by a strength delta >= 0 before
   top-k, so a non-resident expert loses its slot only to a resident
   expert within delta logits of it. The same delta is a provable quality
   bound: with one-sided bias b_i in {-delta, 0}, the biased distribution
   q satisfies

       KL(p || q) = sum_i p_i * (delta * m_i) - log(Z / Z')  <=  delta

   (m_i = 1 for non-resident experts, Z/Z' in [1, e^delta]), so router
   divergence is at most `delta` nats whatever the residency pattern.
   `residency_logit_bias` builds the bias from a host residency mask;
   `bias_reroute` is its trace-level numpy mirror for the serving
   simulator, so both backends apply one policy.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Set, Tuple

import numpy as np
import torch


@dataclass
class ResidencySplit:
    resident_tokens: np.ndarray    # indices of tokens with all experts resident
    deferred_tokens: np.ndarray    # tokens needing >= 1 swap-in
    missing_experts: List[int]     # distinct non-resident experts needed
    order: np.ndarray              # priority permutation over tokens


def split_by_residency(assignments: np.ndarray,
                       resident: Set[int]) -> ResidencySplit:
    """assignments: (T, k) expert ids for one layer."""
    a = np.asarray(assignments)
    res_mask = np.asarray([all(int(e) in resident for e in row) for row in a],
                          bool)
    resident_tokens = np.nonzero(res_mask)[0]
    deferred_tokens = np.nonzero(~res_mask)[0]
    missing = sorted({int(e) for row in a[~res_mask] for e in row
                      if int(e) not in resident})
    order = np.concatenate([resident_tokens, deferred_tokens])
    return ResidencySplit(resident_tokens, deferred_tokens, missing, order)


def overlap_schedule(split: ResidencySplit, layer_compute_s: float,
                     transfer_ready_s: float,
                     now: float) -> Tuple[float, float]:
    """Returns (finish_time, exposed_stall).

    Resident-group compute starts immediately; deferred-group compute starts
    at max(resident-group finish, transfer_ready). Compute time is split
    proportionally to token counts."""
    T = len(split.resident_tokens) + len(split.deferred_tokens)
    if T == 0:
        return now, 0.0
    t_res = layer_compute_s * len(split.resident_tokens) / T
    t_def = layer_compute_s - t_res
    res_done = now + t_res
    if len(split.deferred_tokens) == 0:
        return res_done, 0.0
    start_def = max(res_done, transfer_ready_s)
    exposed = max(0.0, transfer_ready_s - res_done)
    return start_def + t_def, exposed


def sequential_schedule(layer_compute_s: float, transfer_ready_s: float,
                        now: float) -> Tuple[float, float]:
    """Conventional path: block the whole layer until transfers finish."""
    start = max(now, transfer_ready_s)
    return start + layer_compute_s, max(0.0, transfer_ready_s - now)


def residency_logit_bias(resident_mask, strength: float):
    """(..., E) bool/int residency mask -> (..., E) float32 additive bias.

    Resident experts get 0, non-resident ones -strength; adding this to the
    router logits before softmax and top-k gives the bounded perturbation of
    the module docstring (KL(p_orig || p_biased) <= strength nats). A numpy
    mask gives a numpy array, a torch mask a tensor on the mask's device.
    The engine builds the mask on the host from its slot table (assigned
    in-flight transfers count as resident) and moves only this (E,) or
    (s, E) array to the device: no host sync."""
    if isinstance(resident_mask, torch.Tensor):
        return ((resident_mask.to(torch.float32) - 1.0)
                * torch.tensor(strength, dtype=torch.float32))
    m = np.asarray(resident_mask)
    return (m.astype(np.float32) - np.float32(1.0)) * np.float32(strength)


def bias_reroute(assignments: np.ndarray, logits: np.ndarray,
                 resident: Set[int], strength: float
                 ) -> Tuple[np.ndarray, int]:
    """Trace-level mirror of the engine's biased routing for the simulator.

    assignments: (T, k) expert ids from the unbiased trace; logits: (E,)
    router-logit estimate for this layer (the simulator uses pre-gate
    log-probabilities: traces carry no per-layer logits). Each
    non-resident assignment is swapped to the best resident expert not
    already in its row whose logit is within `strength` of the original:
    exactly the swaps the biased top-k on the device could make, so the
    simulated miss reduction tracks the engine's. Returns
    (new_assignments, n_rerouted)."""
    a = np.asarray(assignments)
    if a.ndim == 1:
        a = a.reshape(-1, 1)
    lg = np.asarray(logits, np.float64)
    E = lg.shape[0]
    if strength <= 0.0 or not resident or len(resident) >= E:
        return a, 0
    res_ids = np.asarray(sorted(resident), np.int64)
    out = a.copy()
    n_rerouted = 0
    for t in range(out.shape[0]):
        row = out[t]
        for j in range(row.shape[0]):
            e = int(row[j])
            if e in resident:
                continue
            # resident candidates not already in this row, within the
            # bias window of the displaced expert's logit
            cand = [c for c in res_ids
                    if c not in row and lg[c] >= lg[e] - strength]
            if not cand:
                continue
            row[j] = max(cand, key=lambda c: lg[c])
            n_rerouted += 1
    return out, n_rerouted
