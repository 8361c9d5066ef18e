"""Pure-numpy random-forest regressor (multi-output, MSE splits).

The paper trains a scikit-learn RandomForestRegressor on CPU (deliberately —
a GPU predictor would contend with model execution, §3.2.5). sklearn is not
available in this environment, so this is a from-scratch implementation with
the same interface surface we need: bootstrap bagging, feature subsampling,
depth/leaf-size limits, multi-output mean-squared-error splits.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional

import numpy as np


@dataclass
class _Tree:
    feature: np.ndarray     # (n_nodes,) int32, -1 for leaf
    threshold: np.ndarray   # (n_nodes,) float64
    left: np.ndarray        # (n_nodes,) int32
    right: np.ndarray       # (n_nodes,) int32
    value: np.ndarray       # (n_nodes, n_outputs) float64 leaf means

    def predict(self, X: np.ndarray) -> np.ndarray:
        n = X.shape[0]
        node = np.zeros(n, np.int32)
        active = self.feature[node] >= 0
        while active.any():
            idx = np.nonzero(active)[0]
            f = self.feature[node[idx]]
            t = self.threshold[node[idx]]
            go_left = X[idx, f] <= t
            node[idx] = np.where(go_left, self.left[node[idx]],
                                 self.right[node[idx]])
            active = self.feature[node] >= 0
        return self.value[node]


def _best_split(X: np.ndarray, y: np.ndarray, feat_ids: np.ndarray,
                min_leaf: int):
    """Best (feature, threshold, gain) across candidate features.

    Uses sorted cumulative sums: for a split after position i, SSE_left +
    SSE_right is minimised <=> sum of squared means weighted is maximised.
    Multi-output: sum the criterion over outputs.
    """
    n = X.shape[0]
    best = (None, 0.0, -np.inf)
    y2_total = float((y * y).sum())
    for f in feat_ids:
        xs = X[:, f]
        order = np.argsort(xs, kind="stable")
        xv = xs[order]
        yv = y[order]
        csum = np.cumsum(yv, axis=0)              # (n, M)
        total = csum[-1]
        ks = np.arange(1, n)
        valid = (xv[1:] != xv[:-1]) & (ks >= min_leaf) & (n - ks >= min_leaf)
        if not valid.any():
            continue
        left_sum = csum[:-1]                      # sums of first k
        right_sum = total[None, :] - left_sum
        crit = (left_sum * left_sum).sum(1) / ks + \
               (right_sum * right_sum).sum(1) / (n - ks)
        crit = np.where(valid, crit, -np.inf)
        k = int(np.argmax(crit))
        gain = crit[k] - (total * total).sum() / n
        if crit[k] > -np.inf and gain > best[2]:
            thr = 0.5 * (xv[k] + xv[k + 1])   # split between positions k, k+1
            best = (int(f), float(thr), float(gain))
    return best


class DecisionTreeRegressor:
    def __init__(self, max_depth: int = 12, min_samples_leaf: int = 2,
                 max_features: Optional[str] = "sqrt", rng=None):
        self.max_depth = max_depth
        self.min_samples_leaf = min_samples_leaf
        self.max_features = max_features
        self.rng = rng or np.random.default_rng(0)
        self.tree_: Optional[_Tree] = None

    def _n_feats(self, F: int) -> int:
        if self.max_features == "sqrt":
            return max(1, int(math.sqrt(F)))
        if self.max_features == "third":
            return max(1, F // 3)
        return F

    def fit(self, X: np.ndarray, y: np.ndarray) -> "DecisionTreeRegressor":
        X = np.asarray(X, np.float64)
        y = np.asarray(y, np.float64)
        if y.ndim == 1:
            y = y[:, None]
        n, F = X.shape
        nodes = {"feature": [], "threshold": [], "left": [], "right": [],
                 "value": []}

        def new_node():
            for k in ("feature", "threshold", "left", "right"):
                nodes[k].append(-1)
            nodes["value"].append(np.zeros(y.shape[1]))
            return len(nodes["feature"]) - 1

        stack = [(new_node(), np.arange(n), 0)]
        while stack:
            nid, idx, depth = stack.pop()
            yi = y[idx]
            nodes["value"][nid] = yi.mean(axis=0)
            if depth >= self.max_depth or len(idx) < 2 * self.min_samples_leaf \
                    or np.allclose(yi, yi[0]):
                continue
            feat_ids = self.rng.choice(F, size=min(self._n_feats(F), F),
                                       replace=False)
            f, thr, gain = _best_split(X[idx], yi, feat_ids,
                                       self.min_samples_leaf)
            if f is None or gain <= 1e-12:
                continue
            mask = X[idx, f] <= thr
            li, ri = idx[mask], idx[~mask]
            if len(li) < self.min_samples_leaf or len(ri) < self.min_samples_leaf:
                continue
            lid, rid = new_node(), new_node()
            nodes["feature"][nid] = f
            nodes["threshold"][nid] = thr
            nodes["left"][nid] = lid
            nodes["right"][nid] = rid
            stack.append((lid, li, depth + 1))
            stack.append((rid, ri, depth + 1))

        self.tree_ = _Tree(
            np.asarray(nodes["feature"], np.int32),
            np.asarray(nodes["threshold"], np.float64),
            np.asarray(nodes["left"], np.int32),
            np.asarray(nodes["right"], np.int32),
            np.stack(nodes["value"]),
        )
        return self

    def predict(self, X: np.ndarray) -> np.ndarray:
        assert self.tree_ is not None, "fit first"
        return self.tree_.predict(np.asarray(X, np.float64))


class RandomForestRegressor:
    """Bagged ensemble of CART regressors (multi-output)."""

    def __init__(self, n_estimators: int = 20, max_depth: int = 12,
                 min_samples_leaf: int = 2, max_features: str = "sqrt",
                 bootstrap: bool = True, seed: int = 0):
        self.n_estimators = n_estimators
        self.max_depth = max_depth
        self.min_samples_leaf = min_samples_leaf
        self.max_features = max_features
        self.bootstrap = bootstrap
        self.seed = seed
        self.trees_: List[DecisionTreeRegressor] = []

    def fit(self, X: np.ndarray, y: np.ndarray) -> "RandomForestRegressor":
        X = np.asarray(X, np.float64)
        y = np.asarray(y, np.float64)
        if y.ndim == 1:
            y = y[:, None]
        n = X.shape[0]
        rng = np.random.default_rng(self.seed)
        self.trees_ = []
        for i in range(self.n_estimators):
            t_rng = np.random.default_rng(self.seed * 7919 + i)
            idx = (t_rng.integers(0, n, size=n) if self.bootstrap
                   else np.arange(n))
            tree = DecisionTreeRegressor(self.max_depth, self.min_samples_leaf,
                                         self.max_features, rng=t_rng)
            tree.fit(X[idx], y[idx])
            self.trees_.append(tree)
        return self

    def predict(self, X: np.ndarray) -> np.ndarray:
        assert self.trees_, "fit first"
        out = self.trees_[0].predict(X)
        for t in self.trees_[1:]:
            out = out + t.predict(X)
        return out / len(self.trees_)

    def score_mse(self, X: np.ndarray, y: np.ndarray) -> float:
        pred = self.predict(X)
        y = np.asarray(y, np.float64)
        if y.ndim == 1:
            y = y[:, None]
        return float(np.mean((pred - y) ** 2))
