"""The port's `EngineServingConfig` knobs that the reference serving loop
has (CPU, the olmoe smoke config): `deadline_s` shedding at admission
(through `ServingEngine`, as the reference's batcher tests hold it),
`admission_headroom`, `trace_logits`, and the §3.4 cache-aware routing
knobs `route_bias` / `route_bias_adaptive`. Their defaults leave serving as
it was: nothing shed, nothing traced, no bias.

Each knob is also served through the reference's `ServingEngine` on the
same requests, over engines built alike on the same weights (the JAX
model's, carried bitwise through the bridge): equal shed ids and
`n_shed`, equal admission budgets, equal engine and controller settings,
and traced logits rows within 5e-2 (bf16 logits; a differing greedy token
only at a near-tie of the reference's top two, after which that stream's
comparison ends), with and without route bias."""
import jax
import numpy as np
import pytest
import torch

from repro.configs.registry import get_smoke_config as jax_smoke
from repro.models.transformer import Model as JaxModel
from repro.runtime.engine import SlotBufferEngine as JaxEngine
from repro.runtime.request import Request as JaxRequest
from repro.runtime.serving import EngineServingConfig as JaxServingConfig
from repro.runtime.serving import ServingEngine as JaxServingEngine
from repro_torch.bridge import params_from_reference
from repro_torch.configs import get_smoke_config
from repro_torch.models.transformer import Model
from repro_torch.runtime.engine import SlotBufferEngine
from repro_torch.runtime.request import Request
from repro_torch.runtime.serving import EngineServingConfig, ServingEngine

CFG = get_smoke_config("olmoe-1b-7b")
TOL = 5e-2


@pytest.fixture(scope="module")
def params():
    return Model(CFG).init(torch.Generator().manual_seed(5), device="cpu")


def _engine(params, **kw):
    return SlotBufferEngine(CFG, params, Model(CFG), n_slots_per_layer=4,
                            use_kernel=True, device="cpu", **kw)


def _requests(arrivals, deadlines, n_new=3):
    rng = np.random.default_rng(8)
    return [Request(rng.integers(0, CFG.vocab_size, 6), max_new_tokens=n_new,
                    arrival_s=a, deadline_s=d, request_id=i)
            for i, (a, d) in enumerate(zip(arrivals, deadlines))]


def test_defaults_are_the_references():
    c = EngineServingConfig()
    assert (c.admission_headroom, c.trace_logits, c.route_bias,
            c.route_bias_adaptive, c.deadline_s) == (1.0, False, None, None,
                                                     None)


@pytest.mark.parametrize("deadline", [None, 1.0])
def test_deadline_sheds_a_request_queued_past_it(params, deadline):
    """Request 1 arrived 10 s before serving began: with a default deadline
    of 1 s it is shed at admission and counted in `n_shed`; FIFO order of
    the others holds, and request 0 keeps its own (later) deadline. Without
    a default deadline nothing is shed."""
    reqs = _requests([0.0, -10.0, 0.0], [1e9, None, None])
    srv = ServingEngine(_engine(params), EngineServingConfig(
        max_batch=2, prefill_chunk=0, deadline_s=deadline))
    report = srv.serve(reqs)
    shed = [r.request_id for r in srv.batcher.shed]
    if deadline is None:
        assert shed == [] and report.n_shed == 0
        assert all(len(r.output) == 3 for r in reqs)
        assert reqs[1].deadline_s is None
        return
    assert shed == [1] and report.n_shed == 1
    assert reqs[1].output == [] and reqs[1].slot == -1
    assert reqs[0].deadline_s == 1e9 and reqs[2].deadline_s == 1.0
    assert len(reqs[0].output) == 3 and len(reqs[2].output) == 3
    assert sorted(m.request_id for m in report.requests) == [0, 2]


@pytest.mark.parametrize("headroom", [1.0, 2.5])
def test_admission_headroom_reaches_the_admission_policy(params, headroom):
    srv = ServingEngine(_engine(params), EngineServingConfig(
        admission_headroom=headroom))
    adm = srv.batcher.admission
    assert adm.headroom == headroom
    base = ServingEngine(_engine(params)).batcher.admission
    assert adm.budget() == pytest.approx(headroom * base.budget())
    reqs = _requests([0.0, 0.0], [None, None])
    srv.serve(reqs)
    assert all(len(r.output) == 3 for r in reqs)


@pytest.mark.parametrize("chunk", [0, 32], ids=["monolithic", "chunked"])
def test_trace_logits_records_a_row_per_token(params, chunk):
    """One row for the prefill's first token and one per decode step; each
    row's argmax is the greedy token served."""
    reqs = _requests([0.0, 0.0, 0.0], [None] * 3, n_new=4)
    srv = ServingEngine(_engine(params), EngineServingConfig(
        max_batch=2, prefill_chunk=chunk, trace_logits=True))
    srv.serve(reqs)
    assert sorted(srv.logits_trace) == [0, 1, 2]
    for r in reqs:
        rows = srv.logits_trace[r.request_id]
        assert len(rows) == 4 and all(row.shape == (CFG.vocab_size,)
                                      for row in rows)
        assert [int(row.argmax()) for row in rows] == r.output
    quiet = ServingEngine(_engine(params), EngineServingConfig(max_batch=2))
    quiet.serve(_requests([0.0], [None]))
    assert quiet.logits_trace == {}


@pytest.mark.parametrize("adaptive", [False, True])
def test_route_bias_in_the_config_seeds_the_engine(params, adaptive):
    eng = _engine(params)
    ServingEngine(eng, EngineServingConfig(route_bias=0.8,
                                           route_bias_adaptive=adaptive))
    assert eng.route_bias == 0.8 and eng.route_bias_adaptive == adaptive
    assert eng.controller.cfg.route_bias_max == (0.8 if adaptive else 0.0)
    # None leaves the engine's own setting
    own = _engine(params, route_bias=0.5)
    ServingEngine(own, EngineServingConfig())
    assert own.route_bias == 0.5 and not own.route_bias_adaptive


def test_biased_serving_serves_everything_and_demands_fewer(params):
    """The same requests served with route_bias 1.0 and without: every
    request gets its tokens, and the biased run demands no more experts."""
    runs = {}
    for bias in (None, 1.0):
        eng = _engine(params)
        reqs = _requests([0.0] * 4, [None] * 4, n_new=5)
        ServingEngine(eng, EngineServingConfig(
            max_batch=2, prefill_chunk=0, route_bias=bias)).serve(reqs)
        assert all(len(r.output) == 5 for r in reqs)
        runs[bias] = eng.stats.demand_misses
    assert runs[1.0] <= runs[None]


# ------------------------------------------ against the reference's server
@pytest.fixture(scope="module")
def bridged():
    """(JAX model, JAX params, port params) of the olmoe smoke config."""
    jmodel = JaxModel(jax_smoke("olmoe-1b-7b"))
    jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(1))
    return jmodel, jparams, params_from_reference(
        jax.tree.map(np.asarray, jparams))


def _both(bridged, **scfg):
    """(the reference's server, the port's) over engines built alike on the
    same weights, both with the serving config `scfg`."""
    jmodel, jparams, tparams = bridged
    kw = dict(n_slots_per_layer=4, use_kernel=True)
    je = JaxEngine(jmodel.cfg, jparams, jmodel, **kw)
    te = SlotBufferEngine(CFG, tparams, Model(CFG), device="cpu", **kw)
    return (JaxServingEngine(je, JaxServingConfig(**scfg)),
            ServingEngine(te, EngineServingConfig(**scfg)))


def _request_pair(arrivals, deadlines, n_new=3):
    """The same requests twice: the reference's `Request`s, the port's."""
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, CFG.vocab_size, 6) for _ in arrivals]
    return [[R(p, max_new_tokens=n_new, arrival_s=a, deadline_s=d,
               request_id=i)
             for i, (p, a, d) in enumerate(zip(prompts, arrivals, deadlines))]
            for R in (JaxRequest, Request)]


@pytest.mark.parametrize("deadline", [None, 1.0])
def test_deadline_shedding_matches_reference(bridged, deadline):
    got = []
    for srv, reqs in zip(_both(bridged, max_batch=2, prefill_chunk=0,
                               deadline_s=deadline),
                         _request_pair([0.0, -10.0, 0.0], [1e9, None, None])):
        report = srv.serve(reqs)
        got.append(([r.request_id for r in srv.batcher.shed], report.n_shed,
                    srv.batcher.stats.shed,
                    sorted(m.request_id for m in report.requests),
                    [r.deadline_s for r in reqs],
                    [len(r.output) for r in reqs]))
    assert got[1] == got[0]
    assert got[1][1] == (0 if deadline is None else 1)


@pytest.mark.parametrize("headroom", [1.0, 2.5])
def test_admission_budget_matches_reference(bridged, headroom):
    js, ts = _both(bridged, admission_headroom=headroom)
    ja, ta = js.batcher.admission, ts.batcher.admission
    assert ta.headroom == ja.headroom == headroom
    assert ta.budget() == pytest.approx(float(ja.budget()), rel=1e-12)


@pytest.mark.parametrize("adaptive", [None, False, True])
def test_route_bias_config_matches_reference(bridged, adaptive):
    js, ts = _both(bridged, route_bias=0.8, route_bias_adaptive=adaptive)

    def settings(eng):
        return (eng.route_bias, eng.route_bias_adaptive,
                eng.controller.cfg.route_bias_max,
                eng._route_bias_strength())
    assert settings(ts.engine) == settings(js.engine)


@pytest.mark.parametrize("bias", [None, 1.0], ids=["bias_off", "bias_1"])
def test_trace_rows_match_reference(bridged, bias):
    """Three requests at batch 2 (monolithic admission, so one row for the
    prefill's first token and one per decode step each), with and without
    route bias: the port's traced rows against the reference's."""
    servers = _both(bridged, max_batch=2, prefill_chunk=0, trace_logits=True,
                    route_bias=bias)
    pairs = _request_pair([0.0] * 3, [None] * 3, n_new=4)
    for srv, reqs in zip(servers, pairs):
        srv.serve(reqs)
    (js, ts), (jreqs, treqs) = servers, pairs
    assert sorted(ts.logits_trace) == sorted(js.logits_trace) == [0, 1, 2]
    parted = False
    for jr, tr in zip(jreqs, treqs):
        jrows = js.logits_trace[jr.request_id]
        trows = ts.logits_trace[tr.request_id]
        assert len(trows) == len(jrows) == 4
        for step, (got, want) in enumerate(zip(trows, jrows)):
            np.testing.assert_allclose(
                got, want, rtol=TOL, atol=TOL,
                err_msg=f"request {tr.request_id} step {step}")
            if tr.output[step] != jr.output[step]:
                top2 = np.sort(want)[-2:]
                assert top2[1] - top2[0] <= TOL, (
                    f"request {tr.request_id} step {step}: "
                    f"{tr.output[step]} != {jr.output[step]}, reference "
                    f"top-2 gap {top2[1] - top2[0]:.4f}")
                parted = True
                break
    if not parted:       # the same tokens served: the same host decisions
        keys = ("swap_experts", "demand_misses", "prefetch_hits", "replays")
        a, w = ts.engine.stats.snapshot(), js.engine.stats.snapshot()
        assert [a[k] for k in keys] == [w[k] for k in keys], (a, w)
