"""Hybrid cross-layer expert predictor (paper §3.2.2, §3.2.4–3.2.5).

Two prediction sources:
- `PreGate` (baseline, Eliseev & Mazur style): feed the *current* hidden
  state through a *future* layer's router and take its top-k — accuracy
  decays with the layer gap t (fitted G(t) = a_g e^{-b_g t} + c_g).
- `ForestPredictor` (the paper's contribution): a CPU random forest over
  [token-embedding, S, layer, activation-history] (optionally + pre-gate
  probabilities as the Δ-correction input) that predicts the multi-hot
  actual-activation vector, P(t) = a_p e^{-b_p t} + c_p with c_p > c_g.

A small prediction cache keyed by (token-sequence hash, layer, S) implements
§3.2.2's cached-prediction fast path; on miss the caller falls back to raw
top-k router logits.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.forest import RandomForestRegressor
from repro_torch.core.trace import FeatureSpec, TraceLog, build_features, embedding_table


def topk_set(scores: np.ndarray, k: int) -> Tuple[int, ...]:
    idx = np.argpartition(scores, -k)[-k:]
    return tuple(sorted(int(i) for i in idx))


def recall_accuracy(predicted: Sequence[int], actual: Sequence[int]) -> float:
    """Fraction of actually-activated experts that were predicted — the
    quantity that determines prefetch cache hits."""
    actual = set(actual)
    if not actual:
        return 1.0
    return len(actual & set(predicted)) / len(actual)


def bit_accuracy(pred_bits: np.ndarray, true_bits: np.ndarray) -> float:
    """Paper §3.2.5: proportion of correctly predicted expert bits."""
    return float((pred_bits == true_bits).mean())


# ---------------------------------------------------------------------------

class PreGate:
    """Baseline: apply layer (l+t)'s router weights to the hidden state at
    layer l. Routers are tiny (d x E), so they are always device/host
    resident; this is pure numpy on fetched hidden states."""

    def __init__(self, routers: Sequence[np.ndarray]):
        # routers[l]: (d_model, E) fp32
        self.routers = [np.asarray(r, np.float32) for r in routers]

    def probs(self, hidden: np.ndarray, target_layer: int) -> np.ndarray:
        """hidden: (T, d) pooled or per-token hidden states at current layer.
        Returns mean softmax router distribution of the target layer."""
        logits = hidden.astype(np.float32) @ self.routers[target_layer]
        logits = logits - logits.max(axis=-1, keepdims=True)
        p = np.exp(logits)
        p /= p.sum(axis=-1, keepdims=True)
        return p.mean(axis=0)

    def predict(self, hidden: np.ndarray, target_layer: int,
                top_k: int) -> Tuple[int, ...]:
        return topk_set(self.probs(hidden, target_layer), top_k)


# ---------------------------------------------------------------------------

@dataclass
class PredictorConfig:
    n_estimators: int = 16
    max_depth: int = 12
    min_samples_leaf: int = 2
    max_features: str = "third"
    include_pregate: bool = False   # Δ-correction mode (extended)
    embed_dim: int = 16
    seed: int = 0


class ForestPredictor:
    """Paper's learned predictor. Train offline from trace logs; predict at
    runtime from (tokens, S, layer, history) with a cached fast path."""

    def __init__(self, spec: FeatureSpec, cfg: Optional[PredictorConfig] = None):
        self.spec = spec
        self.cfg = cfg or PredictorConfig()
        self.table = embedding_table(spec)
        self.forest = RandomForestRegressor(
            n_estimators=self.cfg.n_estimators, max_depth=self.cfg.max_depth,
            min_samples_leaf=self.cfg.min_samples_leaf,
            max_features=self.cfg.max_features, seed=self.cfg.seed)
        self.cache: Dict[Tuple[int, int, int], Tuple[int, ...]] = {}
        self.trained = False

    # -- training ----------------------------------------------------------
    def fit(self, log: TraceLog) -> float:
        X, Y = build_features(log, self.spec, self.table)
        if len(X) == 0:
            raise ValueError("empty trace log")
        self.forest.fit(X, Y)
        self.trained = True
        return self.forest.score_mse(X, Y)

    # -- runtime -------------------------------------------------------------
    @staticmethod
    def _key(token_ids: Sequence[int], layer: int, s: int) -> Tuple[int, int, int]:
        h = hashlib.blake2b(np.asarray(token_ids, np.int64).tobytes(),
                            digest_size=8).hexdigest()
        return (int(h, 16), layer, s)

    def features(self, token_ids: Sequence[int], layer: int, s: int,
                 history: np.ndarray,
                 pregate: Optional[np.ndarray] = None) -> np.ndarray:
        ids = np.asarray(token_ids, np.int64) % self.spec.vocab_size
        e = self.table[ids].mean(axis=0)
        feats = [e, [float(s)], [float(layer)], history.reshape(-1)]
        if self.spec.include_pregate:
            pg = np.zeros(self.spec.num_experts)
            if pregate is not None:
                pg[:len(pregate)] = pregate
            feats.append(pg)
        return np.concatenate(feats)[None, :]

    def scores(self, token_ids, layer, s, history, pregate=None) -> np.ndarray:
        x = self.features(token_ids, layer, s, history, pregate)
        y = self.forest.predict(x)[0]
        if self.spec.include_pregate and pregate is not None:
            # Δ-correction: forest predicts deviation from pre-gate
            y = y + pregate
        return y

    def predict(self, token_ids, layer: int, s: int, history: np.ndarray,
                top_k: int, pregate: Optional[np.ndarray] = None,
                use_cache: bool = True) -> Tuple[int, ...]:
        key = self._key(token_ids, layer, s)
        if use_cache and key in self.cache:
            return self.cache[key]
        if not self.trained:
            # cold start: fall back to pre-gate / uniform
            if pregate is not None:
                out = topk_set(np.asarray(pregate), top_k)
            else:
                out = tuple(range(top_k))
        else:
            out = topk_set(self.scores(token_ids, layer, s, history, pregate),
                           top_k)
        if use_cache:
            self.cache[key] = out
        return out


# ---------------------------------------------------------------------------
# Accuracy-vs-step-size evaluation + exponential-decay fit (paper §4.3)
# ---------------------------------------------------------------------------

def fit_exp_decay(t: np.ndarray, acc: np.ndarray):
    """Fit f(t) = a e^{-bt} + c by grid-searching b and solving (a, c) by
    least squares (no scipy in this environment).

    Accuracies live in [0, 1]; fits whose asymptote c leaves that range are
    extrapolation artifacts of short curves, so c is constrained by solving
    for `a` alone against a grid of admissible c values in that case.
    """
    t = np.asarray(t, np.float64)
    acc = np.asarray(acc, np.float64)
    best = (0.0, 0.0, float(acc.mean()), np.inf)
    for b in np.linspace(0.01, 3.0, 300):
        basis = np.exp(-b * t)
        A = np.stack([basis, np.ones_like(t)], axis=1)
        coef, *_ = np.linalg.lstsq(A, acc, rcond=None)
        a_f, c_f = float(coef[0]), float(coef[1])
        if not 0.0 <= c_f <= 1.0:
            # constrained refit: c on a grid, a by 1-d least squares
            for c_try in np.linspace(0.0, min(acc.min() + 0.05, 1.0), 25):
                denom = float(basis @ basis)
                a_try = float(basis @ (acc - c_try)) / max(denom, 1e-12)
                resid = float(((a_try * basis + c_try - acc) ** 2).sum())
                if resid < best[3]:
                    best = (a_try, float(b), float(c_try), resid)
            continue
        resid = float(((A @ coef - acc) ** 2).sum())
        if resid < best[3]:
            best = (a_f, float(b), c_f, resid)
    a, b, c, _ = best
    return {"a": a, "b": b, "c": c}
