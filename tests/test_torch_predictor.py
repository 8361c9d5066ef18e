"""The port's trace pipeline, random forest, predictors and policies
(`core/trace.py`, `core/forest.py`, `core/predictor.py`,
`core/coordinator.py`) against the reference's (CPU).

Both sides are numpy, so the comparisons are exact: the same samples give
the same JSONL bytes and the same `build_features` (X, Y); the same (X, y)
grows the same trees (every node's `feature`, `threshold`, `left`,
`right` and `value`) and the same predictions; `PreGate`'s probabilities,
`fit_exp_decay`, `topk_set`, `recall_accuracy`, `bit_accuracy` and every
policy, field for field, are equal; `PredictionSource` picks the same
experts under each policy. The reference's own tests of these modules
(`tests/test_core.py`) run on the port as well. Inputs come from numpy
seeds.
"""
import dataclasses

import numpy as np
import pytest

from repro.core import coordinator as j_coord
from repro.core import forest as j_forest
from repro.core import predictor as j_pred
from repro.core import trace as j_trace
from repro_torch.core import coordinator, predictor, trace
from repro_torch.core import (FeatureSpec, ForestPredictor, PreGate, Sample,
                              TraceLog)
from repro_torch.core.forest import (DecisionTreeRegressor,
                                     RandomForestRegressor)
from repro_torch.core.predictor import (fit_exp_decay, recall_accuracy,
                                        topk_set)
from repro_torch.core.trace import build_features


def _toy_log(tr, L=3, M=8, n_req=12, seed=0, pregate=False):
    """The reference test's topic-structured routing (tokens from a
    topic's vocab block; the topic fixes every layer's experts), built
    with package `tr`'s TraceLog."""
    rng = np.random.default_rng(seed)
    log = tr.TraceLog()
    n_topics, block = 4, 64 // 4
    for r in range(n_req):
        topic = int(rng.integers(n_topics))
        toks = tuple(int(topic * block + t)
                     for t in rng.integers(0, block, 6))
        for li in range(L):
            e0 = (topic * 2 + li) % M
            pg = tuple(float(p) for p in rng.dirichlet(np.ones(M))) \
                if pregate else ()
            log.add(token_ids=toks, layer_idx=li, predicted_experts=(),
                    actual_experts=(e0, (e0 + 1) % M), step_size=2,
                    request_id=r, pregate_probs=pg)
    return log


def _random_log(tr, L=4, M=16, n_req=6, steps=5, seed=3):
    """Decode-shaped logs, as `Engine.generate` writes them: a sliding
    window of the last 64 ids, every layer of every step, mean pre-gate
    probabilities."""
    rng = np.random.default_rng(seed)
    log = tr.TraceLog()
    for r in range(n_req):
        toks = list(rng.integers(0, 1000, int(rng.integers(8, 80))))
        for st in range(steps):
            for li in range(L):
                act = sorted({int(e) for e in rng.integers(0, M, 4)})
                log.add(token_ids=tuple(int(t) for t in toks[-64:]),
                        layer_idx=li, predicted_experts=(),
                        actual_experts=tuple(act), step_size=2,
                        request_id=st, pregate_probs=tuple(
                            float(p) for p in rng.dirichlet(np.ones(M))))
            toks.append(int(rng.integers(0, 1000)))
    return log


# ------------------------------------------------------------ the trace log
@pytest.mark.parametrize("make", [_toy_log, _random_log])
def test_jsonl_bytes_and_roundtrip_match_reference(tmp_path, make):
    mine, ref = make(trace), make(j_trace)
    mine.save(str(tmp_path / "a.jsonl"))
    ref.save(str(tmp_path / "b.jsonl"))
    assert (tmp_path / "a.jsonl").read_bytes() == \
        (tmp_path / "b.jsonl").read_bytes()
    back = TraceLog.load(str(tmp_path / "b.jsonl"))   # the reference's file
    assert [dataclasses.astuple(s) for s in back.samples] == \
        [dataclasses.astuple(s) for s in ref.samples]
    assert back.samples[0] == mine.samples[0]


def test_sample_from_json_validates():
    with pytest.raises(ValueError, match="missing"):
        Sample.from_json('{"token_ids": [1], "layer_idx": 0, "S": 2}')
    line = '{"token_ids": [1, 2], "layer_idx": 1, "actual_experts": [3], ' \
        '"S": 2}'
    s = Sample.from_json(line)
    assert dataclasses.astuple(s) == \
        dataclasses.astuple(j_trace.Sample.from_json(line))
    assert s.to_json() == j_trace.Sample.from_json(line).to_json()


def test_groups_match_reference():
    mine, ref = _toy_log(trace, n_req=4), _toy_log(j_trace, n_req=4)
    gm, gr = mine.groups(), ref.groups()
    assert list(gm) == list(gr)
    assert all(len(v) == 3 for v in gm.values())
    for k in gm:
        assert [dataclasses.astuple(s) for s in gm[k]] == \
            [dataclasses.astuple(s) for s in gr[k]]


@pytest.mark.parametrize("pregate", [False, True])
@pytest.mark.parametrize("make", [_toy_log, _random_log])
def test_build_features_match_reference(make, pregate):
    L, M = (3, 8) if make is _toy_log else (4, 16)
    kw = dict(vocab_size=1000, embed_dim=6, num_layers=L, num_experts=M,
              include_pregate=pregate)
    spec, jspec = FeatureSpec(**kw), j_trace.FeatureSpec(**kw)
    assert spec.feature_dim == jspec.feature_dim
    np.testing.assert_array_equal(trace.embedding_table(spec),
                                  j_trace.embedding_table(jspec))
    X, Y = build_features(make(trace), spec)
    jX, jY = j_trace.build_features(make(j_trace), jspec)
    assert X.shape == (len(make(trace).samples), spec.feature_dim)
    np.testing.assert_array_equal(X, jX)
    np.testing.assert_array_equal(Y, jY)


def test_feature_construction_dims():
    log = _toy_log(trace, L=3, M=8)
    spec = FeatureSpec(vocab_size=64, embed_dim=4, num_layers=3,
                       num_experts=8)
    X, Y = build_features(log, spec)
    assert X.shape[1] == spec.feature_dim == 4 + 2 + 24
    assert Y.shape[1] == 8
    assert X.shape[0] == Y.shape[0] == len(log.samples)
    empty = build_features(TraceLog(), spec)
    assert empty[0].shape == (0, spec.feature_dim)


# --------------------------------------------------------------- the forest
def _same_tree(a, b):
    for f in ("feature", "threshold", "left", "right", "value"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


FOREST_CASES = {
    "multioutput": (lambda r: r.standard_normal((300, 6)),
                    lambda X, r: np.stack([(X[:, 0] > 0).astype(float),
                                           (X[:, 1] > 0.5).astype(float)], 1),
                    dict(n_estimators=10, max_depth=8, seed=1)),
    "regression": (lambda r: r.standard_normal((400, 10)),
                   lambda X, r: X[:, 0] * 2 + np.sin(X[:, 1])
                   + 0.1 * r.standard_normal(400),
                   dict(n_estimators=8, max_depth=10, seed=2)),
    "third_no_bootstrap": (lambda r: r.integers(0, 3, (200, 9)).astype(float),
                           lambda X, r: (X[:, :4] > 1).astype(float),
                           dict(n_estimators=4, max_depth=6,
                                max_features="third", bootstrap=False,
                                min_samples_leaf=3, seed=5)),
}


@pytest.mark.parametrize("case", list(FOREST_CASES))
def test_forest_trees_and_predictions_match_reference(case):
    mk_x, mk_y, kw = FOREST_CASES[case]
    rng = np.random.default_rng(len(case))
    X = mk_x(rng)
    y = mk_y(X, rng)
    mine = RandomForestRegressor(**kw).fit(X, y)
    ref = j_forest.RandomForestRegressor(**kw).fit(X, y)
    assert len(mine.trees_) == len(ref.trees_) == kw["n_estimators"]
    for a, b in zip(mine.trees_, ref.trees_):
        _same_tree(a.tree_, b.tree_)
    Xt = mk_x(np.random.default_rng(99))
    np.testing.assert_array_equal(mine.predict(Xt), ref.predict(Xt))
    assert mine.score_mse(X, y) == ref.score_mse(X, y)


def test_tree_fits_simple_split():
    X = np.array([[0.0], [1.0], [2.0], [3.0]] * 10)
    y = (X[:, 0] >= 2).astype(float)
    t = DecisionTreeRegressor(max_depth=3, min_samples_leaf=1,
                              max_features=None)
    t.fit(X, y)
    pred = t.predict(np.array([[0.5], [2.5]]))
    assert pred[0] < 0.1 and pred[1] > 0.9
    r = j_forest.DecisionTreeRegressor(max_depth=3, min_samples_leaf=1,
                                       max_features=None).fit(X, y)
    _same_tree(t.tree_, r.tree_)


def test_forest_multioutput_regression():
    rng = np.random.default_rng(0)
    X = rng.standard_normal((300, 6))
    Y = np.stack([(X[:, 0] > 0).astype(float),
                  (X[:, 1] > 0.5).astype(float)], axis=1)
    f = RandomForestRegressor(n_estimators=10, max_depth=8, seed=1)
    f.fit(X, Y)
    assert f.score_mse(X, Y) < 0.1


def test_forest_beats_constant_predictor():
    rng = np.random.default_rng(3)
    X = rng.standard_normal((400, 10))
    y = X[:, 0] * 2 + np.sin(X[:, 1]) + 0.1 * rng.standard_normal(400)
    f = RandomForestRegressor(n_estimators=8, max_depth=10, seed=2)
    f.fit(X, y)
    const_mse = float(np.mean((y - y.mean()) ** 2))
    assert f.score_mse(X, y) < 0.5 * const_mse


# ------------------------------------------------------------ the predictor
@pytest.fixture(scope="module")
def fitted():
    """(port, reference) ForestPredictors fit on the same decode-shaped
    logs, pre-gate features on, and the mse each reported."""
    L, M = 4, 16
    kw = dict(vocab_size=1000, embed_dim=8, num_layers=L, num_experts=M,
              include_pregate=True)
    mine = ForestPredictor(FeatureSpec(**kw))
    ref = j_pred.ForestPredictor(j_trace.FeatureSpec(**kw))
    return (mine, mine.fit(_random_log(trace))), \
        (ref, ref.fit(_random_log(j_trace)))


def test_forest_predictor_fit_matches_reference(fitted):
    (mine, mse), (ref, jmse) = fitted
    assert mse == jmse and np.isfinite(mse)
    assert dataclasses.asdict(mine.cfg) == dataclasses.asdict(ref.cfg)
    np.testing.assert_array_equal(mine.table, ref.table)
    for a, b in zip(mine.forest.trees_, ref.forest.trees_):
        _same_tree(a.tree_, b.tree_)


def test_forest_predictor_scores_and_predictions_match_reference(fitted):
    (mine, _), (ref, _) = fitted
    rng = np.random.default_rng(4)
    for _ in range(12):
        toks = tuple(int(t) for t in rng.integers(0, 1000, 20))
        layer, s = int(rng.integers(0, 4)), int(rng.integers(1, 4))
        hist = (rng.random((4, 16)) < 0.3).astype(np.float64)
        pg = rng.dirichlet(np.ones(16))
        for pre in (None, pg):
            np.testing.assert_array_equal(
                mine.features(toks, layer, s, hist, pre),
                ref.features(toks, layer, s, hist, pre))
            np.testing.assert_array_equal(
                mine.scores(toks, layer, s, hist, pre),
                ref.scores(toks, layer, s, hist, pre))
            assert mine.predict(toks, layer, s, hist, 3, pre,
                                use_cache=False) == \
                ref.predict(toks, layer, s, hist, 3, pre, use_cache=False)
        assert mine._key(toks, layer, s) == ref._key(toks, layer, s)


def test_forest_predictor_learns_deterministic_routing():
    log = _toy_log(trace, L=3, M=8, n_req=30)
    spec = FeatureSpec(vocab_size=64, embed_dim=8, num_layers=3,
                       num_experts=8)
    pred = ForestPredictor(spec)
    pred.fit(log)
    hits, total, hist = 0, 0, {}
    for s in log.samples:
        h = hist.setdefault(s.token_ids, np.zeros((3, 8)))
        out = pred.predict(s.token_ids, s.layer_idx, s.step_size, h, top_k=2,
                           use_cache=False)
        hits += len(set(out) & set(s.actual_experts))
        total += len(s.actual_experts)
        for e in s.actual_experts:
            h[s.layer_idx, e] = 1.0
    assert hits / total > 0.8, hits / total


def test_prediction_cache_and_cold_start():
    log = _toy_log(trace)
    spec = FeatureSpec(vocab_size=64, embed_dim=4, num_layers=3,
                       num_experts=8)
    pred = ForestPredictor(spec)
    h = np.zeros((3, 8))
    pg = np.linspace(0, 1, 8)
    assert pred.predict((1, 2), 0, 2, h, 3) == (0, 1, 2)   # untrained
    assert pred.predict((1, 2), 1, 2, h, 3, pg, use_cache=False) == \
        topk_set(pg, 3)
    pred.fit(log)
    a = pred.predict((1, 2, 3), 1, 2, h, top_k=2)
    assert pred._key((1, 2, 3), 1, 2) in pred.cache
    assert pred.predict((1, 2, 3), 1, 2, h, top_k=2) == a
    with pytest.raises(ValueError):
        ForestPredictor(spec).fit(TraceLog())


def test_pregate_probs_match_reference():
    rng = np.random.default_rng(6)
    routers = [rng.standard_normal((12, 16)).astype(np.float32)
               for _ in range(3)]
    mine, ref = PreGate(routers), j_pred.PreGate(routers)
    for t in range(3):
        h = rng.standard_normal((5, 12)).astype(np.float32)
        np.testing.assert_array_equal(mine.probs(h, t), ref.probs(h, t))
        assert mine.predict(h, t, 4) == ref.predict(h, t, 4)


def test_fit_exp_decay_matches_reference():
    t = np.arange(1, 12, dtype=float)
    for acc in (0.4 * np.exp(-0.5 * t) + 0.55,
                0.9 * np.exp(-1.3 * t) - 0.05,      # c out of [0, 1]
                np.random.default_rng(1).random(11)):
        assert fit_exp_decay(t, acc) == j_pred.fit_exp_decay(t, acc)
    fit = fit_exp_decay(t, 0.4 * np.exp(-0.5 * t) + 0.55)
    assert abs(fit["c"] - 0.55) < 0.02 and abs(fit["b"] - 0.5) < 0.1


def test_accuracy_helpers_match_reference():
    assert recall_accuracy((1, 2, 3), (2, 3)) == 1.0
    assert recall_accuracy((1,), (2, 3)) == 0.0
    assert recall_accuracy((2,), (2, 3)) == 0.5
    assert recall_accuracy((1,), ()) == 1.0
    rng = np.random.default_rng(8)
    for _ in range(5):
        sc = rng.random(16)
        assert topk_set(sc, 5) == j_pred.topk_set(sc, 5)
        a, b = rng.integers(0, 2, 32), rng.integers(0, 2, 32)
        assert predictor.bit_accuracy(a, b) == j_pred.bit_accuracy(a, b)


# --------------------------------------------------------------- policies
POLICIES = [("baseline", ()), ("pregate_fixed", (3,)),
            ("promoe_like", (2,)), ("expertflow", ()),
            ("ablation", ("oracle",))]


@pytest.mark.parametrize("name,args", POLICIES)
def test_policies_match_reference_field_for_field(name, args):
    kw = {"predictor": "oracle", "fixed_s": 3} if name == "ablation" else {}
    mine = getattr(coordinator, name)(*args, **kw)
    ref = getattr(j_coord, name)(*args, **kw)
    assert dataclasses.asdict(mine) == dataclasses.asdict(ref)


@pytest.mark.parametrize("policy", ["baseline", "pregate_fixed",
                                    "promoe_like", "expertflow", "oracle"])
def test_prediction_source_matches_reference(fitted, policy):
    (mine_f, _), (ref_f, _) = fitted
    rng = np.random.default_rng(10)
    routers = [rng.standard_normal((8, 16)).astype(np.float32)
               for _ in range(4)]
    if policy == "oracle":
        mk = lambda c: c.ablation("oracle", predictor="oracle")  # noqa: E731
    else:
        mk = lambda c: getattr(c, policy)()  # noqa: E731
    mine = coordinator.PredictionSource(mk(coordinator), routers, mine_f,
                                        16, 2)
    ref = j_coord.PredictionSource(mk(j_coord), routers, ref_f, 16, 2)
    for _ in range(8):
        kw = dict(hidden=rng.standard_normal((3, 8)).astype(np.float32),
                  target_layer_pos=int(rng.integers(0, 4)),
                  token_ids=rng.integers(0, 1000, 12), s=2,
                  history=(rng.random((4, 16)) < 0.2).astype(float),
                  actual=rng.integers(0, 16, 4))
        assert mine.predict(**kw) == ref.predict(**kw)
        p = rng.dirichlet(np.ones(16))
        assert mine.n_select(p) == ref.n_select(p)
