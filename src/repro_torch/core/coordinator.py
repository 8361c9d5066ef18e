"""Policy definitions tying ExpertFlow's pieces together (paper §3.1 Fig 5).

A `Policy` bundles the knobs the evaluation ablates:
- prefetching on/off and the prediction source (pre-gate vs forest),
- fixed vs adaptive step size S,
- single vs two-level LRU,
- cache-aware routing on/off,
- blocking swap-out (baseline contention) vs prioritized miss handling.

Presets mirror the paper's comparison set: `baseline` (Transformers-style
on-demand), `pregate` (Eliseev & Mazur fixed pre-gating), `promoe`
(fixed-stride proactive prefetch), and `expertflow` (the full system).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Sequence, Set, Tuple

import numpy as np

from repro_torch.core.predictor import ForestPredictor, PreGate, topk_set
from repro_torch.core.step_size import (StepSizeConfig, StepSizeController,
                                  expected_active_experts)


@dataclass
class Policy:
    name: str
    prefetch: bool = True
    predictor: str = "pregate"        # pregate | forest | oracle
    adaptive_s: bool = False
    fixed_s: int = 2
    two_level_lru: bool = True
    cache_aware: bool = True
    blocking_swap_out: bool = False
    protect_early_layers: bool = True
    cum_prob_threshold: float = 0.7
    # §3.4 bounded routing perturbation strength delta (router-logit units):
    # non-resident assignments may swap to a resident expert within delta
    # logits, so router KL vs unperturbed routing stays <= delta nats.
    # 0 keeps routing untouched. Requires cache_aware. Mirrors the live
    # engine's `SlotBufferEngine.set_route_bias`; when `step_cfg` sets
    # route_bias_max > 0 the shared controller ramps the effective strength
    # within [0, route_bias] adaptively.
    route_bias: float = 0.0
    step_cfg: StepSizeConfig = field(default_factory=StepSizeConfig)


def baseline() -> Policy:
    """Conventional on-demand loading: no prefetch, single-level LRU,
    swap-out contention on the link, whole-layer blocking."""
    return Policy("baseline", prefetch=False, predictor="pregate",
                  adaptive_s=False, two_level_lru=False, cache_aware=False,
                  blocking_swap_out=True, protect_early_layers=False)


def pregate_fixed(s: int = 2) -> Policy:
    """Eliseev & Mazur-style fixed pre-gating at distance S."""
    return Policy(f"pregate_s{s}", prefetch=True, predictor="pregate",
                  adaptive_s=False, fixed_s=s, two_level_lru=False,
                  cache_aware=False, blocking_swap_out=True,
                  protect_early_layers=False)


def promoe_like(s: int = 2) -> Policy:
    """ProMoE-style proactive sliding-window prefetch (fixed stride,
    non-blocking swap-out, single LRU)."""
    return Policy(f"promoe_s{s}", prefetch=True, predictor="pregate",
                  adaptive_s=False, fixed_s=s, two_level_lru=False,
                  cache_aware=False, blocking_swap_out=False,
                  protect_early_layers=False)


def expertflow(predictor: str = "forest", *, adaptive: bool = True,
               cache_aware: bool = True, two_level: bool = True,
               s0: int = 2) -> Policy:
    return Policy("expertflow", prefetch=True, predictor=predictor,
                  adaptive_s=adaptive, fixed_s=s0, two_level_lru=two_level,
                  cache_aware=cache_aware, blocking_swap_out=False,
                  protect_early_layers=True)


def ablation(name: str, **kw) -> Policy:
    p = expertflow()
    p.name = name
    for k, v in kw.items():
        setattr(p, k, v)
    return p


# ---------------------------------------------------------------------------
# Prediction source
# ---------------------------------------------------------------------------

class PredictionSource:
    """Uniform interface over pre-gate / forest / oracle predictions."""

    def __init__(self, policy: Policy, routers: Sequence[np.ndarray],
                 forest: Optional[ForestPredictor] = None,
                 num_experts: int = 0, top_k: int = 1):
        self.policy = policy
        self.pregate = PreGate(routers)
        self.forest = forest
        self.M = num_experts
        self.top_k = top_k

    def n_select(self, probs: np.ndarray) -> int:
        n = expected_active_experts(probs, self.policy.cum_prob_threshold)
        return int(np.clip(n, self.top_k, self.M))

    def predict(self, *, hidden: np.ndarray, target_layer_pos: int,
                token_ids: np.ndarray, s: int, history: np.ndarray,
                actual: Optional[Sequence[int]] = None) -> Tuple[int, ...]:
        """Predicted expert set for a future layer.

        hidden: (T, d) states at the layer where the prediction is issued.
        target_layer_pos: MoE-layer position being predicted.
        """
        pg = self.pregate.probs(hidden, target_layer_pos)
        if self.policy.predictor == "oracle" and actual is not None:
            return tuple(sorted(set(int(a) for a in actual)))
        if self.policy.predictor == "forest" and self.forest is not None \
                and self.forest.trained:
            scores = self.forest.scores(token_ids, target_layer_pos, s,
                                        history, pg)
            scores = np.maximum(scores, 0.0)
            ssum = scores.sum()
            probs = scores / ssum if ssum > 0 else pg
            return topk_set(scores if ssum > 0 else pg, self.n_select(probs))
        return topk_set(pg, self.n_select(pg))
