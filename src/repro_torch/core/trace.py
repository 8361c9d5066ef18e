"""Activation metadata collection and parsing (paper §3.2.3–3.2.4).

Each record is one (request, layer) observation:

    Sample_i = { token_ids, layer_idx, predicted_experts, actual_experts, S }

`TraceLog` accumulates samples during engine runs, serialises to JSONL, and
builds the grouped dataset G = {(t, S) -> samples} plus the feature matrix
(X, Y) used to train the predictor (§3.2.4–3.2.5).
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np


@dataclass
class Sample:
    token_ids: Tuple[int, ...]
    layer_idx: int
    predicted_experts: Tuple[int, ...]
    actual_experts: Tuple[int, ...]
    step_size: int
    request_id: int = 0
    pregate_probs: Tuple[float, ...] = ()   # optional (extended features)

    def to_json(self) -> str:
        return json.dumps({
            "token_ids": list(self.token_ids),
            "layer_idx": self.layer_idx,
            "predicted_experts": list(self.predicted_experts),
            "actual_experts": list(self.actual_experts),
            "S": self.step_size,
            "request_id": self.request_id,
            "pregate_probs": list(self.pregate_probs),
        })

    @staticmethod
    def from_json(line: str) -> "Sample":
        d = json.loads(line)
        # validation (§3.2.3 "after validation and parsing")
        for k in ("token_ids", "layer_idx", "actual_experts", "S"):
            if k not in d:
                raise ValueError(f"malformed trace line: missing {k}")
        return Sample(tuple(int(t) for t in d["token_ids"]),
                      int(d["layer_idx"]),
                      tuple(int(e) for e in d.get("predicted_experts", ())),
                      tuple(int(e) for e in d["actual_experts"]),
                      int(d["S"]),
                      int(d.get("request_id", 0)),
                      tuple(float(p) for p in d.get("pregate_probs", ())))


class TraceLog:
    def __init__(self):
        self.samples: List[Sample] = []

    def add(self, **kw) -> None:
        self.samples.append(Sample(**kw))

    def extend(self, samples: Iterable[Sample]) -> None:
        self.samples.extend(samples)

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            for s in self.samples:
                f.write(s.to_json() + "\n")

    @staticmethod
    def load(path: str) -> "TraceLog":
        log = TraceLog()
        with open(path) as f:
            for line in f:
                line = line.strip()
                if line:
                    log.samples.append(Sample.from_json(line))
        return log

    # -- grouping (§3.2.4) -------------------------------------------------
    def groups(self) -> Dict[Tuple[Tuple[int, ...], int], List[Sample]]:
        g: Dict[Tuple[Tuple[int, ...], int], List[Sample]] = {}
        for s in self.samples:
            g.setdefault((s.token_ids, s.step_size), []).append(s)
        for v in g.values():
            v.sort(key=lambda s: s.layer_idx)
        return g


# ---------------------------------------------------------------------------
# Feature construction (§3.2.4)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class FeatureSpec:
    vocab_size: int
    embed_dim: int          # d of the fixed random table E in R^{V x d}
    num_layers: int         # L
    num_experts: int        # M (experts per layer)
    include_pregate: bool = False
    seed: int = 1234

    @property
    def feature_dim(self) -> int:
        f = self.embed_dim + 2 + self.num_layers * self.num_experts
        if self.include_pregate:
            f += self.num_experts
        return f


def embedding_table(spec: FeatureSpec) -> np.ndarray:
    rng = np.random.default_rng(spec.seed)
    return rng.standard_normal((spec.vocab_size, spec.embed_dim)) / \
        np.sqrt(spec.embed_dim)


def build_features(log: TraceLog, spec: FeatureSpec,
                   table: np.ndarray | None = None):
    """x = [mean-pooled token embedding, S, l, prev_act (L*M)] (+ pregate),
    y = multi-hot actual experts of layer l. One example per layer per
    request-group; prev_act accumulates over the group's layer order."""
    if table is None:
        table = embedding_table(spec)
    X, Y = [], []
    L, M = spec.num_layers, spec.num_experts
    for (tokens, s), samples in log.groups().items():
        ids = np.asarray(tokens, np.int64) % spec.vocab_size
        e = table[ids].mean(axis=0)
        prev_act = np.zeros(L * M, np.float64)
        for smp in samples:
            l = smp.layer_idx
            feats = [e, [float(s)], [float(l)], prev_act.copy()]
            if spec.include_pregate:
                pg = np.zeros(M)
                n = min(M, len(smp.pregate_probs))
                pg[:n] = smp.pregate_probs[:n]
                feats.append(pg)
            X.append(np.concatenate(feats))
            y = np.zeros(M, np.float64)
            for ex in smp.actual_experts:
                if 0 <= ex < M:
                    y[ex] = 1.0
            Y.append(y)
            if 0 <= l < L:
                for ex in smp.actual_experts:
                    if 0 <= ex < M:
                        prev_act[l * M + ex] = 1.0
    if not X:
        return (np.zeros((0, spec.feature_dim)), np.zeros((0, M)))
    return np.stack(X), np.stack(Y)
