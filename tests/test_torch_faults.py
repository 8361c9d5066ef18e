"""Fault injection and graceful degradation in the port against the
reference (CPU).

- `core/faults.py`: `FaultPlan`'s presets, `from_arg` and its JSON equal
  the reference's; `FaultInjector`'s draws equal the reference's draw for
  draw over a grid of seeds, keys, attempts and clock times in all three
  scopes (the device link, the disk link through `disk_view`, and the
  corruption draws); `StepWatchdog` trips and recovers on the reference's
  steps over the same step-time sequences.
- The reference's five engine tests (`tests/test_faults.py`), on the
  port's engine and server: a total outage still serves every token
  degraded; the watchdog and a predictor blackout collapse the horizon;
  recovery after an outage window is bitwise a never-faulted engine's; a
  brownout completes with retries and failures; a disabled plan is bitwise
  no plan. The total outage and the disabled plan run on both decode
  paths.
- The port's `SlotBufferEngine` served through `ServingEngine` against the
  JAX ones on the same weights and requests, under `flaky(seed=0)` and
  `brownout_preset(seed=0)`, on the olmoe and DeepSeek-V2-Lite smoke
  configs, unfused and superkernel (the JAX superkernel runs its Pallas
  kernels in interpret mode): every `SlotPathStats` counter, the
  `ServingReport` health keys, `brownout_deferred` and every served token
  equal. The step watchdog and the straggler policy read the wall clock,
  which differs between two frameworks, so in that comparison both are
  built so that they never trip (on both engines): what is compared is
  what the plan decides.
"""
import dataclasses
import itertools

import jax
import numpy as np
import pytest
import torch

from repro.configs.registry import get_smoke_config as jax_smoke
from repro.core import faults as jax_faults
from repro.runtime.engine import Engine as JaxEngine
from repro.runtime.engine import SlotBufferEngine as JaxSlotBufferEngine
from repro.runtime.request import Request as JaxRequest
from repro.runtime.serving import EngineServingConfig as JaxServingConfig
from repro.runtime.serving import ServingEngine as JaxServingEngine
from repro_torch.bridge import params_from_reference
from repro_torch.configs import get_config, get_smoke_config, reduce_config
from repro_torch.core.faults import (FOREVER, FaultInjector, FaultPlan,
                                     StepWatchdog)
from repro_torch.models.transformer import Model
from repro_torch.runtime.engine import SlotBufferEngine
from repro_torch.runtime.request import Request
from repro_torch.runtime.serving import EngineServingConfig, ServingEngine

PATHS = {"unfused": False, "superkernel": True}
COUNTERS = ("swap_calls", "swap_experts", "prefetched", "prefetch_hits",
            "late_hits", "demand_misses", "host_syncs", "steps",
            "spec_layers", "replays", "link_failures", "retries",
            "degraded_steps")
HEALTH = ("n_link_failures", "n_retries", "n_degraded_steps", "n_shed")
TOL = 5e-2          # bf16 logits of two frameworks: the near-tie margin


# ----------------------------------------------------------------- FaultPlan
def test_default_plan_is_disabled_and_presets_are_not():
    assert not FaultPlan().enabled and not FaultPlan.none().enabled
    for preset in FaultPlan.PRESETS[1:]:
        assert FaultPlan.from_arg(preset).enabled, preset


@pytest.mark.parametrize("arg", list(FaultPlan.PRESETS)
                         + ['{"fail_prob": 0.5, "seed": 3}',
                            '{"outage": [[1.0, 2.0]], "jitter": 0.1}'])
def test_from_arg_equals_the_reference(arg):
    mine, ref = FaultPlan.from_arg(arg), jax_faults.FaultPlan.from_arg(arg)
    assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
    assert mine.to_json() == ref.to_json()
    assert (mine.enabled, mine.disk_enabled, mine.corrupt_enabled) == \
        (ref.enabled, ref.disk_enabled, ref.corrupt_enabled)


def test_from_arg_reads_a_file_and_rejects_junk(tmp_path):
    assert FaultPlan.from_arg(None) is None and FaultPlan.from_arg("") is None
    f = tmp_path / "plan.json"
    f.write_text(FaultPlan.stall(seed=9).to_json())
    assert FaultPlan.from_arg(str(f)) == FaultPlan.stall(seed=9)
    with pytest.raises(ValueError):
        FaultPlan.from_arg("nonsense-preset")


def test_json_roundtrip_restores_window_tuples():
    plan = FaultPlan(seed=4, fail_prob=0.2,
                     brownout=((0.0, 1.0, 0.1), (2.0, 3.0, 0.5)),
                     outage=((5.0, 6.0),), disk_outage=((1.0, 2.0),),
                     predictor_blackout=((0.0, FOREVER),))
    back = FaultPlan.from_json(plan.to_json())
    assert back == plan and isinstance(back.brownout[0], tuple)
    ref = jax_faults.FaultPlan.from_json(plan.to_json())
    assert ref.to_json() == plan.to_json()


# -------------------------------------------------------------- FaultInjector
# every field nonzero, so every draw of every scope is taken
FULL = dict(fail_prob=0.4, stall_prob=0.35, stall_s=2.5, jitter=0.3,
            bandwidth_factor=0.7, brownout=((1.0, 2.0, 0.1),),
            outage=((3.0, 4.0),), predictor_blackout=((0.5, 1.5),),
            disk_fail_prob=0.45, disk_stall_prob=0.3, disk_stall_s=1.5,
            disk_jitter=0.2, disk_bandwidth_factor=0.4,
            disk_outage=((2.0, 3.5),), corrupt_disk_prob=0.3,
            corrupt_link_prob=0.25, corrupt_host_prob=0.2)
KEYS = [(0, 0), (2, 5), (7, 63), (93, 127), 5, None]
TIMES = [0.0, 0.75, 1.5, 2.5, 3.25, 1e6]
SCOPES = {
    "device": lambda inj, k, t: (
        inj.transfer_fails(k, t), inj.transfer_extra_s(k, t),
        inj.bandwidth_factor(k, t), inj.link_degraded(t),
        inj.predictor_blackout(t)),
    "disk": lambda inj, k, t: (
        lambda v: (v.transfer_fails(k, t), v.transfer_extra_s(k, t),
                   v.bandwidth_factor(k, t), v.link_degraded(t),
                   v.predictor_blackout(t)))(inj.disk_view()),
    "corrupt": lambda inj, k, t: (
        inj.disk_record_corrupt(k), inj.promotion_corrupt(k),
        inj.host_copy_corrupt(k), inj.disk_view().promotion_corrupt(k)),
}


@pytest.mark.parametrize("seed", [0, 1, 11])
@pytest.mark.parametrize("scope", list(SCOPES))
def test_injector_draws_equal_the_reference(scope, seed):
    """Same plan -> the same decision at every (key, attempt, time), and the
    same failure and stall counts."""
    plan = dict(FULL, seed=seed)
    mine = FaultInjector(FaultPlan(**plan))
    ref = jax_faults.FaultInjector(jax_faults.FaultPlan(**plan))
    draw = SCOPES[scope]
    seen = set()
    for attempt, k, t in itertools.product(range(4), KEYS, TIMES):
        a, b = draw(mine, k, t), draw(ref, k, t)
        assert a == b, (scope, seed, attempt, k, t, a, b)
        seen.add(a)
    assert len(seen) > 4                  # the grid draws both outcomes
    assert (mine.n_failures, mine.n_stalls) == (ref.n_failures, ref.n_stalls)


def test_injector_attach_link_shapes_transfers_as_the_reference():
    """The link hooks give each transfer the reference's duration."""
    from repro.core import prefetcher as jax_pf
    from repro_torch.core import prefetcher as pf
    plan = dict(FULL, seed=2)
    mine, ref = pf.TransferLink(64e9), jax_pf.TransferLink(64e9)
    FaultInjector(FaultPlan(**plan)).attach_link(mine)
    jax_faults.FaultInjector(jax_faults.FaultPlan(**plan)).attach_link(ref)
    durs = set()
    for i in range(24):
        key, t = (i % 3, i), i / 4
        a = mine._duration(pf.Transfer(key, 4e7, 1, t), t)
        assert a == ref._duration(jax_pf.Transfer(key, 4e7, 1, t), t)
        durs.add(a)
    assert len(durs) > 2


# --------------------------------------------------------------- StepWatchdog
@pytest.mark.parametrize("kw", [
    {}, dict(alpha=0.5, trip_factor=4.0, recover_factor=1.5,
             recover_steps=3, warmup=2),
    dict(alpha=0.5, warmup=1, recover_steps=1),
    dict(trip_factor=2.0, recover_factor=1.2, recover_steps=2, warmup=0)])
def test_watchdog_trips_and_recovers_as_the_reference(kw):
    rng = np.random.default_rng(len(kw))
    steps = np.where(rng.random(200) < 0.15, rng.uniform(3, 40, 200),
                     rng.uniform(0.8, 1.6, 200))
    steps[60:80] = 30.0                   # a sustained brownout
    mine, ref = StepWatchdog(**kw), jax_faults.StepWatchdog(**kw)
    for s in steps:
        assert mine.observe(float(s)) == ref.observe(float(s))
        assert (mine.ewma_s, mine.n_trips, mine._ok_streak) == \
            (ref.ewma_s, ref.n_trips, ref._ok_streak)
    assert mine.n_trips > 0


def test_watchdog_recovers_with_hysteresis():
    wd = StepWatchdog(alpha=0.5, trip_factor=4.0, recover_factor=1.5,
                      recover_steps=3, warmup=2)
    for _ in range(4):
        assert not wd.observe(1.0)
    assert wd.observe(10.0) and wd.n_trips == 1
    assert wd.observe(1.0) and wd.observe(1.0)
    assert not wd.observe(1.0)


# ------------------------------------------- the reference's engine tests
TINY = dict(layers=2, d_model=32, heads=2, kv_heads=2, d_ff=64, vocab=128,
            experts=4, top_k=2, d_expert=16)


@pytest.fixture(scope="module")
def tiny():
    cfg = reduce_config(get_config("olmoe-1b-7b"), **TINY)
    g = torch.Generator().manual_seed(0)
    return cfg, Model(cfg).init(g, device="cpu")


def _engine_serve(cfg, params, plan, slots, reqs, trace=False,
                  superkernel=False, **eng_kw):
    sb = SlotBufferEngine(cfg, params, Model(cfg), n_slots_per_layer=slots,
                          max_seq=64, faults=plan, retry_backoff_s=0.0,
                          use_superkernel=superkernel, device="cpu", **eng_kw)
    srv = ServingEngine(sb, EngineServingConfig(
        max_batch=2, prefill_chunk=0, admission_cap=False,
        trace_logits=trace))
    return sb, srv, srv.serve(reqs)


def _prompts(cfg, n, rng):
    return [Request(prompt=rng.integers(0, cfg.vocab_size, 16,
                                        dtype=np.int32),
                    max_new_tokens=6, temperature=0.0, request_id=i)
            for i in range(n)]


@pytest.mark.parametrize("path", list(PATHS))
def test_engine_total_outage_decode_still_emits_tokens(tiny, path):
    """The link dead from t = 0: every request still emits its budget
    (resident-only routing; the missing experts' tokens drop through the
    dead slot) and the run reports degraded steps."""
    cfg, params = tiny
    reqs = _prompts(cfg, 3, np.random.default_rng(0))
    sb, _, rep = _engine_serve(cfg, params, FaultPlan.total_outage(), 3,
                               reqs, superkernel=PATHS[path])
    assert all(len(r.output) == r.max_new_tokens for r in reqs)
    assert rep.n_link_failures > 0 and rep.n_degraded_steps > 0
    assert sb._degraded                    # the link never healed
    assert sb._route_bias_strength() == sb.degraded_route_bias
    assert sb.stats.swap_experts == 0      # nothing ever became resident


def test_engine_watchdog_and_blackout_collapse_horizon(tiny):
    cfg, params = tiny
    sb = SlotBufferEngine(cfg, params, Model(cfg), n_slots_per_layer=3,
                          max_seq=64, faults=FaultPlan.flaky(seed=0),
                          device="cpu")
    assert sb.watchdog is not None
    h0 = sb._horizon(0)
    sb.watchdog.tripped = True
    assert sb._horizon(0) == 0
    sb.watchdog.tripped = False
    assert sb._horizon(0) == h0
    sb2 = SlotBufferEngine(cfg, params, Model(cfg), n_slots_per_layer=3,
                           max_seq=64, device="cpu", faults=FaultPlan(
                               predictor_blackout=((0.0, FOREVER),)))
    assert sb2._horizon(0) == 0
    assert SlotBufferEngine(cfg, params, Model(cfg), n_slots_per_layer=3,
                            max_seq=64, device="cpu").watchdog is None


@pytest.mark.parametrize("path", list(PATHS))
def test_engine_recovery_restores_bit_exactness(tiny, path):
    """The outage window ends, degraded routing clears after a clean
    demand (streak 1), and with route bias 0 the engine is back on the
    calls of an engine that never saw a fault: a request served after
    recovery is bitwise the never-faulted engine's."""
    cfg, params = tiny
    E = cfg.moe.num_experts
    sk = PATHS[path]
    sb, _, rep_a = _engine_serve(
        cfg, params, FaultPlan(outage=((0.0, 2.0),)), E,
        _prompts(cfg, 2, np.random.default_rng(1)), trace=True,
        superkernel=sk, degraded_recover_streak=1)
    assert rep_a.n_link_failures > 0 and not sb._degraded
    assert sb._clock > 2.0                 # the window is over
    srv_b = ServingEngine(sb, EngineServingConfig(
        max_batch=2, prefill_chunk=0, admission_cap=False,
        trace_logits=True))
    srv_b.serve(_prompts(cfg, 2, np.random.default_rng(7)))
    _, srv_c, _ = _engine_serve(cfg, params, None, E,
                                _prompts(cfg, 2, np.random.default_rng(7)),
                                trace=True, superkernel=sk)
    assert set(srv_b.logits_trace) == set(srv_c.logits_trace)
    for rid, rows in srv_c.logits_trace.items():
        assert len(rows) == len(srv_b.logits_trace[rid])
        for x, y in zip(rows, srv_b.logits_trace[rid]):
            assert np.array_equal(x, y)


def test_engine_brownout_completes_and_reports_health(tiny):
    cfg, params = tiny
    reqs = _prompts(cfg, 3, np.random.default_rng(2))
    sb, srv, rep = _engine_serve(cfg, params,
                                 FaultPlan.brownout_preset(seed=0), 3, reqs)
    assert all(len(r.output) == r.max_new_tokens for r in reqs)
    assert rep.n_retries > 0 and rep.n_link_failures > 0 and rep.n_shed == 0
    assert srv.batcher.brownout is not None      # on with a plan
    s = rep.summary()
    for k in HEALTH:
        assert k in s


@pytest.mark.parametrize("path", list(PATHS))
def test_engine_disabled_plan_is_bit_exact(tiny, path):
    cfg, params = tiny
    sk = PATHS[path]
    sb, srv_a, _ = _engine_serve(cfg, params, FaultPlan(), 3,
                                 _prompts(cfg, 2, np.random.default_rng(3)),
                                 trace=True, superkernel=sk)
    assert sb.faults is None and sb.watchdog is None
    assert srv_a.batcher.brownout is None        # off without a plan
    plain, srv_b, _ = _engine_serve(
        cfg, params, None, 3, _prompts(cfg, 2, np.random.default_rng(3)),
        trace=True, superkernel=sk)
    assert set(srv_a.logits_trace) == set(srv_b.logits_trace)
    for rid, rows in srv_a.logits_trace.items():
        for x, y in zip(rows, srv_b.logits_trace[rid]):
            assert np.array_equal(x, y)
    a, w = sb.stats.snapshot(), plain.stats.snapshot()
    assert [a[k] for k in COUNTERS] == [w[k] for k in COUNTERS]


def test_degraded_strength_floors_the_route_bias(tiny):
    cfg, params = tiny
    sb = SlotBufferEngine(cfg, params, Model(cfg), n_slots_per_layer=3,
                          max_seq=64, route_bias=6.0, device="cpu",
                          faults=FaultPlan.flaky(seed=0))
    assert sb._route_bias_strength() == 6.0
    sb._enter_degraded()
    assert sb._route_bias_strength() == 6.0      # max(base, floor)
    sb.set_route_bias(0.5)
    assert sb._route_bias_strength() == sb.degraded_route_bias == 4.0
    sb.degraded_recover_streak = 2
    sb._note_transfer_ok()
    assert sb._degraded
    sb._note_transfer_ok()
    assert not sb._degraded and sb._route_bias_strength() == 0.5


# ------------------------------------------------- against the JAX engine
@pytest.fixture(scope="module")
def smokes():
    """arch -> (port config, port params, JAX config, JAX engine)."""
    out = {}
    for arch in ("olmoe-1b-7b", "deepseek-v2-lite"):
        jcfg = jax_smoke(arch)
        eng = JaxEngine(jcfg, max_seq=64)
        out[arch] = (get_smoke_config(arch), params_from_reference(
            jax.tree.map(np.asarray, eng.params)), jcfg, eng)
    return out


def _never_trips():
    return dict(watchdog_kw=dict(trip_factor=float("inf")),
                serving_kw=dict(brownout_threshold=float("inf")))


class TeacherForced:
    """Makes a port `ServingEngine` emit the JAX server's tokens (each
    request's stream as the reference served it), so that both engines see
    the same tokens and their host decisions can be compared counter for
    counter. Each emitted token must be the port's own greedy choice, or
    within `TOL` of the top of the port's logits row (a near-tie: bf16
    logits of two frameworks)."""

    def __init__(self, monkeypatch, srv, streams):
        from repro_torch.runtime import serving as serving_mod
        self.srv, self.streams, self.ties = srv, streams, []
        self.req = None
        emit = srv._emit_first_token

        def first(req, *a):
            self.req = req
            return emit(req, *a)
        srv._emit_first_token = first
        monkeypatch.setattr(serving_mod, "sample", self.sample)
        monkeypatch.setattr(serving_mod, "sample_rows", self.sample_rows)

    def _force(self, req, row):
        tok = self.streams[req.request_id][len(req.output)]
        row = row.float()
        if int(row.argmax()) != tok:
            gap = float(row.max() - row[tok])
            assert gap <= TOL, (req.request_id, len(req.output), tok, gap)
            self.ties.append((req.request_id, len(req.output), gap))
        return tok

    def sample(self, logits, gen, temperature):
        return torch.tensor([self._force(self.req, logits[0])])

    def sample_rows(self, logits, gens, temps):
        out = logits.argmax(-1)        # monolithic: every active row decodes
        for slot, req in self.srv.batcher.active.items():
            out[slot] = self._force(req, logits[slot])
        return out


@pytest.mark.parametrize("path", list(PATHS))
@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "deepseek-v2-lite"])
@pytest.mark.parametrize("plan", ["flaky", "brownout"])
def test_served_under_faults_equals_the_jax_engine(smokes, monkeypatch, plan,
                                                  arch, path):
    cfg, params, jcfg, jeng = smokes[arch]
    make = {"flaky": "flaky", "brownout": "brownout_preset"}[plan]
    nt = _never_trips()
    kw = dict(n_slots_per_layer=3, max_seq=64, use_kernel=True,
              use_superkernel=PATHS[path], retry_backoff_s=0.0)
    scfg = dict(max_batch=2, prefill_chunk=0, admission_cap=False,
                **nt["serving_kw"])
    te = SlotBufferEngine(cfg, params, Model(cfg), device="cpu",
                          faults=getattr(FaultPlan, make)(seed=0),
                          watchdog=StepWatchdog(**nt["watchdog_kw"]), **kw)
    je = JaxSlotBufferEngine(
        jcfg, jeng.params, jeng.model,
        faults=getattr(jax_faults.FaultPlan, make)(seed=0),
        watchdog=jax_faults.StepWatchdog(**nt["watchdog_kw"]), **kw)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab_size, int(n), dtype=np.int32)
               for n in rng.integers(8, 17, 4)]
    budgets = [6, 3, 6, 4]         # rows free one at a time: admissions wait
    treqs = [Request(prompt=p, max_new_tokens=n, request_id=i)
             for i, (p, n) in enumerate(zip(prompts, budgets))]
    jreqs = [JaxRequest(prompt=p, max_new_tokens=n, request_id=i)
             for i, (p, n) in enumerate(zip(prompts, budgets))]
    jsrv = JaxServingEngine(je, JaxServingConfig(**scfg))
    jrep = jsrv.serve(jreqs)
    tsrv = ServingEngine(te, EngineServingConfig(**scfg))
    forced = TeacherForced(monkeypatch, tsrv,
                           {r.request_id: list(r.output) for r in jreqs})
    trep = tsrv.serve(treqs)
    assert [r.output for r in treqs] == [r.output for r in jreqs]
    assert [len(r.output) for r in treqs] == budgets
    a, w = te.stats.snapshot(), je.stats.snapshot()
    assert {k: a[k] for k in COUNTERS} == {k: w[k] for k in COUNTERS}
    assert {k: getattr(trep, k) for k in HEALTH} == \
        {k: getattr(jrep, k) for k in HEALTH}
    assert tsrv.batcher.stats.brownout_deferred == \
        jsrv.batcher.stats.brownout_deferred
    assert te._degraded == je._degraded
    assert trep.n_link_failures > 0 and trep.n_retries > 0
    if plan == "brownout":               # retries ran out: degraded routing
        assert trep.n_degraded_steps > 0
        assert tsrv.batcher.stats.brownout_deferred > 0
    assert te.controller.s_history == je.controller.s_history
    assert len(forced.ties) <= 2, forced.ties
