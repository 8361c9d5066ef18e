"""The port's simulators, workloads, trace-level cache-aware routing and
capacity planner (`simulator/{hardware,events,serving}.py`,
`data/workloads.py`, `core/cache_aware.py::bias_reroute`,
`core/capacity_planner.py`) against the reference's (CPU).

Both sides are numpy and run the same arithmetic in the same order, so
the tolerance is zero: every `summary()` (and each step's metrics) must
equal the reference's key for key. Each scenario is built twice from the
same numpy arrays, once per package: synthetic traces (the reference
tests' generators) and traces of the JAX `Engine` on the DeepSeek smoke
config, replayed by `simulate` and `simulate_serving` under the four
policies of the serving CLI (and the reference tests' ablations), with
and without a fault plan and a host tier. The reference's own tests of
these modules (`tests/test_simulator.py`, `tests/test_serving.py`,
`tests/test_capacity_planner.py`) run on the port as well.
`PLATFORMS["h100"]` exists; every other entry equals the reference's.
"""
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest

import repro.core.cache_aware as j_ca
import repro.core.capacity_planner as j_cp
import repro.core.coordinator as j_co
import repro.core.faults as j_faults
import repro.data.workloads as j_wl
import repro.simulator.events as j_ev
import repro.simulator.hardware as j_hw
import repro.simulator.serving as j_sv
from repro.configs.registry import get_config as jax_get_config
from repro.configs.registry import get_smoke_config as jax_smoke
from repro_torch.configs import get_config
from repro_torch.core import cache_aware, capacity_planner, coordinator, faults
from repro_torch.core.metrics import RequestMetrics, ServingReport, percentile
from repro_torch.data import workloads
from repro_torch.simulator import events, hardware, serving

PORT = SimpleNamespace(ev=events, sv=serving, hw=hardware, co=coordinator,
                       wl=workloads, faults=faults, ca=cache_aware,
                       cp=capacity_planner, get_config=get_config)
REF = SimpleNamespace(ev=j_ev, sv=j_sv, hw=j_hw, co=j_co, wl=j_wl,
                      faults=j_faults, ca=j_ca, cp=j_cp,
                      get_config=jax_get_config)
MS = 1e-3
ARCHS = ("olmoe-1b-7b", "deepseek-v2-lite", "qwen1.5-moe-a2.7b",
         "qwen2-moe-57b", "qwen3-moe-235b-a22b")


def _both(fn):
    """fn(package) on the port and on the reference."""
    return fn(PORT), fn(REF)


def _same_run(a, b):
    assert a.summary() == b.summary()
    assert [dataclasses.asdict(s) for s in a.steps] == \
        [dataclasses.asdict(s) for s in b.steps]


def _same_serving(a, b):
    assert a.summary() == b.summary()
    assert [dataclasses.asdict(m) for m in a.requests] == \
        [dataclasses.asdict(m) for m in b.requests]
    _same_run(a.run, b.run)


# ------------------------------------------------------------ the platforms
def test_platforms_match_reference_and_h100_is_added():
    assert set(hardware.PLATFORMS) == set(j_hw.PLATFORMS) | {"h100"}
    for name, spec in j_hw.PLATFORMS.items():
        assert dataclasses.astuple(hardware.PLATFORMS[name]) == \
            dataclasses.astuple(spec)
    h = hardware.PLATFORMS["h100"]
    assert (h.name, h.flops, h.hbm_bw, h.mem_cap) == \
        ("h100", 989e12, 3.35e12, 20e9)
    assert 45e9 < h.host_bw < 56e9     # the port's measured copy rates


@pytest.mark.parametrize("arch", ARCHS)
def test_cost_helpers_match_reference(arch):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    assert hardware.expert_bytes(cfg) == j_hw.expert_bytes(jcfg)
    for name in j_hw.PLATFORMS:
        for batch, kv in ((1, 64), (4, 64), (16, 1024)):
            assert hardware.layer_time_decode(
                cfg, hardware.PLATFORMS[name], batch, kv) == \
                j_hw.layer_time_decode(jcfg, j_hw.PLATFORMS[name], batch, kv)


# ---------------------------------------------------------- capacity planner
@pytest.mark.parametrize("arch", ARCHS)
def test_capacity_plan_matches_reference_on_every_platform(arch):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    for name in j_hw.PLATFORMS:
        for kw in ({}, dict(batch=8, kv_len=1024),
                   dict(memory_budget_bytes=6e9, batch=16, kv_len=2048)):
            mine = capacity_planner.plan(cfg, hardware.PLATFORMS[name], **kw)
            ref = j_cp.plan(jcfg, j_hw.PLATFORMS[name], **kw)
            assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
            assert mine.summary() == ref.summary()
    for b in (1, 8, 64):
        assert capacity_planner.expected_active_per_layer(cfg, b) == \
            j_cp.expected_active_per_layer(jcfg, b)
    assert capacity_planner.plan(cfg, hardware.PLATFORMS["h100"]).summary()


def test_planner_reference_properties_on_the_port():
    P = hardware.PLATFORMS
    ds = get_config("deepseek-v2-lite")
    a1, a8, a64 = (capacity_planner.expected_active_per_layer(ds, b)
                   for b in (1, 8, 64))
    assert a1 <= a8 <= a64 <= ds.moe.num_experts
    assert a1 >= ds.moe.top_k * 0.9
    q2 = get_config("qwen2-moe-57b")
    assert capacity_planner.expected_active_per_layer(
        q2, 32, concentration=0.3) < \
        capacity_planner.expected_active_per_layer(q2, 32, concentration=1.0)
    p = capacity_planner.plan(ds, P["a6000"], memory_budget_bytes=20e9,
                              batch=8, kv_len=1024)
    assert 0 < p.capacity_experts < p.total_experts
    assert 0.2 < p.resident_fraction < 0.9 and 1 <= p.s_initial <= 12
    assert p.expert_bytes == pytest.approx(3 * 2048 * 1408 * 2)
    p = capacity_planner.plan(q2, P["rx6500xt"], memory_budget_bytes=6e9,
                              batch=16, kv_len=2048)
    assert p.resident_fraction < 0.2 and not p.bandwidth_feasible
    assert p.expected_stall_per_layer_s > 0
    q15 = get_config("qwen1.5-moe-a2.7b")
    small = capacity_planner.plan(q15, P["a6000"], memory_budget_bytes=10e9)
    big = capacity_planner.plan(q15, P["a6000"], memory_budget_bytes=30e9)
    assert big.capacity_experts > small.capacity_experts
    assert big.expected_stall_per_layer_s <= small.expected_stall_per_layer_s
    slow = capacity_planner.plan(ds, P["rtx4090"], memory_budget_bytes=20e9)
    fast = capacity_planner.plan(ds, P["h20"], memory_budget_bytes=20e9)
    assert fast.s_initial <= slow.s_initial


# --------------------------------------------------------------- workloads
@pytest.mark.parametrize("pattern", ["poisson", "bursty", "mixed"])
def test_workloads_match_reference(pattern):
    assert workloads.WORKLOAD_PATTERNS == j_wl.WORKLOAD_PATTERNS
    for seed in (0, 3):
        mine, ref = _both(lambda pk: pk.wl.make_workload(
            pattern, 20, seed=seed, mean_decode=16))
        assert [dataclasses.astuple(a) for a in mine] == \
            [dataclasses.astuple(b) for b in ref]
        for a in mine:
            assert a.arrival_s >= 0 and a.prompt_len >= 2 \
                and a.decode_len >= 2
        rm, rr = np.random.default_rng(seed), np.random.default_rng(seed)
        for a, b in zip(mine, ref):
            np.testing.assert_array_equal(
                workloads.prompt_tokens(a, 1000, rm),
                j_wl.prompt_tokens(b, 1000, rr))


def test_arrivals_match_reference():
    a = workloads.poisson_arrivals(50, 100.0, np.random.default_rng(0))
    np.testing.assert_array_equal(
        a, j_wl.poisson_arrivals(50, 100.0, np.random.default_rng(0)))
    assert a[0] == 0.0 and np.all(np.diff(a) >= 0)
    b = workloads.bursty_arrivals(30, 6, 0.5, 1e-3,
                                  np.random.default_rng(0))
    np.testing.assert_array_equal(
        b, j_wl.bursty_arrivals(30, 6, 0.5, 1e-3, np.random.default_rng(0)))
    gaps = np.diff(b)
    assert (gaps < 1e-2).sum() == 25 and (gaps > 0.1).sum() == 4
    lens = {s.prompt_len for s in workloads.make_workload(
        "mixed", 200, seed=0, short_prompt=16, long_prompt=64)}
    assert lens == {16, 64}
    with pytest.raises(ValueError):
        workloads.make_workload("sinusoidal", 4)


def test_synthetic_traces_match_reference():
    r, jr = (workloads.synthetic_routers(4, 8, 8, seed=0),
             j_wl.synthetic_routers(4, 8, 8, seed=0))
    for a, b in zip(r, jr):
        np.testing.assert_array_equal(a, b)
    for spec, jspec in zip(workloads.make_workload("poisson", 4, seed=0),
                           j_wl.make_workload("poisson", 4, seed=0)):
        mine = workloads.synthetic_request_trace(spec, 4, 8, 2, r, seed=0)
        ref = j_wl.synthetic_request_trace(jspec, 4, 8, 2, jr, seed=0)
        assert len(mine) == len(ref) == spec.decode_len
        for a, b in zip(mine, ref):
            assert type(a) is events.StepTrace
            assert a.step_idx == b.step_idx
            np.testing.assert_array_equal(a.token_ids, b.token_ids)
            np.testing.assert_array_equal(a.hidden_pooled, b.hidden_pooled)
            for x, y in zip(a.assignments, b.assignments):
                np.testing.assert_array_equal(x, y)
                assert x.shape[1] == 2 and x.min() >= 0 and x.max() < 8
            assert (a.embeddings is None) == (b.embeddings is None)
            if a.embeddings is not None:
                np.testing.assert_array_equal(a.embeddings, b.embeddings)
        assert mine[0].embeddings is not None
        assert len(mine) < 2 or mine[1].embeddings is None


# ----------------------------------------------------------- bias_reroute
@pytest.mark.parametrize("strength", [0.0, 0.2, 1.0, 5.0])
def test_bias_reroute_matches_reference(strength):
    rng = np.random.default_rng(int(strength * 10) + 1)
    for T, k, E in ((6, 2, 16), (1, 8, 64), (12, 4, 60)):
        a = np.stack([rng.permutation(E)[:k] for _ in range(T)])
        lg = rng.standard_normal(E)
        for resident in (set(), {int(e) for e in rng.permutation(E)[:E // 3]},
                         set(range(E))):
            got, n = cache_aware.bias_reroute(a, lg, resident, strength)
            want, jn = j_ca.bias_reroute(a, lg, resident, strength)
            np.testing.assert_array_equal(got, want)
            assert n == jn
            assert n == 0 or strength > 0
    flat, n = cache_aware.bias_reroute(np.array([3, 5]), np.zeros(8), {1},
                                       1.0)
    assert flat.shape == (2, 1) and n == 2 and (flat == 1).all()


# ------------------------------------------------ single-trace simulation
def _synthetic_trace(pk, L=6, M=16, steps=20, T=4, d=8, seed=0,
                     locality=0.8):
    """The reference test's trace (temporal locality), built in `pk`."""
    rng = np.random.default_rng(seed)
    routers = [rng.standard_normal((d, M)).astype(np.float32) * 0.3
               for _ in range(L)]
    tr = pk.ev.RoutingTrace("synthetic", L, M, top_k=2, routers=routers)
    prev = rng.integers(0, M, (L, T, 2))
    for s in range(steps):
        assigns = []
        for li in range(L):
            cur = prev[li].copy()
            mask = rng.random(cur.shape) > locality
            cur[mask] = rng.integers(0, M, mask.sum())
            assigns.append(cur)
        prev = np.stack(assigns)
        tr.steps.append(pk.ev.StepTrace(
            s, rng.integers(0, 64, 8), list(prev),
            rng.standard_normal((L, d)).astype(np.float32),
            rng.standard_normal((T, d))))
    return tr


def _sim(pk, capacity_frac=0.9, layer_ms=1.0, expert_mb=17.0, L=6, M=16):
    return pk.ev.SimSpec(expert_bytes=expert_mb * 1e6,
                         layer_time_s=layer_ms * 1e-3,
                         capacity_experts=int(L * M * capacity_frac))


POLICY_CASES = {
    "baseline": lambda co: co.baseline(),
    "pregate_s2": lambda co: co.pregate_fixed(2),
    "promoe_s2": lambda co: co.promoe_like(2),
    "expertflow": lambda co: co.expertflow(),
    "oracle": lambda co: co.ablation("oracle", predictor="oracle",
                                     adaptive_s=False, fixed_s=3),
    "no_cache_aware": lambda co: co.ablation("no_cache_aware",
                                             cache_aware=False),
    "block": lambda co: co.ablation("block", blocking_swap_out=True),
    "route_bias": lambda co: dataclasses.replace(co.expertflow(),
                                                 route_bias=1.0),
}


@pytest.mark.parametrize("platform", ["a6000", "rx6500xt", "h100"])
@pytest.mark.parametrize("policy", list(POLICY_CASES))
def test_simulate_matches_reference(policy, platform):
    hw = (hardware.PLATFORMS[platform],
          j_hw.PLATFORMS.get(platform, hardware.PLATFORMS[platform]))
    for frac in (0.9, 0.3):
        mine, ref = (events.simulate(
            _synthetic_trace(pk), _sim(pk, frac), h,
            POLICY_CASES[policy](pk.co))
            for pk, h in zip((PORT, REF), hw))
        _same_run(mine, ref)


def test_simulate_reference_properties_on_the_port():
    P, co = hardware.PLATFORMS, coordinator
    tr = _synthetic_trace(PORT)
    sim = lambda f=0.9: _sim(PORT, f)  # noqa: E731
    orac = events.simulate(tr, sim(), P["a6000"], POLICY_CASES["oracle"](co))
    assert sum(s.stall_s for s in orac.steps[2:]) == pytest.approx(0.0,
                                                                  abs=1e-9)
    base = events.simulate(tr, sim(), P["a6000"], co.baseline())
    assert events.simulate(tr, sim(), P["a6000"], co.ablation(
        "oracle", predictor="oracle")).total_stall_s < base.total_stall_s
    on = events.simulate(tr, sim(0.6), P["a6000"], co.expertflow())
    off = events.simulate(tr, sim(0.6), P["a6000"],
                          POLICY_CASES["no_cache_aware"](co))
    assert on.total_stall_s <= off.total_stall_s + 1e-9
    assert events.simulate(tr, sim(), P["rx6500xt"], co.baseline()) \
        .total_stall_s > events.simulate(tr, sim(), P["h20"],
                                         co.baseline()).total_stall_s
    cfg = co.expertflow().step_cfg
    for s in events.simulate(tr, sim(0.5), P["rtx4090"],
                             co.expertflow()).steps:
        assert cfg.s_min <= s.step_size <= cfg.s_max
    big = events.simulate(tr, sim(1.0), P["a6000"], co.expertflow())
    tiny = events.simulate(tr, sim(0.15), P["a6000"], co.expertflow())
    assert tiny.total_cache_miss_s > big.total_cache_miss_s
    s = events.simulate(tr, sim(), P["a6000"], co.promoe_like(2)).summary()
    for k in ("stall_s", "compute_s", "hit_rate", "mean_step_size"):
        assert k in s
    assert s["total_s"] >= s["compute_s"]


# ------------------------------------------------------ serving simulation
FAST = dict(name="test", host_bw=1e12, flops=1e15, hbm_bw=1e12, mem_cap=1e9)


def _plain(co):
    return co.ablation("plain", prefetch=False, adaptive_s=False,
                       two_level_lru=False, cache_aware=False,
                       blocking_swap_out=False, protect_early_layers=False)


def _micro_steps(pk, n_steps, experts_by_layer, L=2, d=4):
    return [pk.ev.StepTrace(si, np.arange(4),
                            [np.array([[e] for e in experts_by_layer[li]])
                             for li in range(L)],
                            np.zeros((L, d), np.float32))
            for si in range(n_steps)]


def _micro(pk, reqs, L=2, M=4, d=4, name="micro"):
    return pk.sv.ServingWorkload(
        L, M, 1, [np.zeros((d, M), np.float32) for _ in range(L)], reqs,
        name=name)


def _two_requests(pk):
    return [pk.sv.ServingRequest(prompt_len=16, max_new_tokens=3,
                                 steps=_micro_steps(pk, 3, [[0], [1]]),
                                 arrival_s=0.0, request_id=0),
            pk.sv.ServingRequest(prompt_len=16, max_new_tokens=2,
                                 steps=_micro_steps(pk, 2, [[2], [3]]),
                                 arrival_s=0.5 * MS, request_id=1)]


@pytest.mark.parametrize("max_batch", [1, 2])
def test_hand_computed_timelines_match_reference(max_batch):
    def run(pk):
        spec = pk.ev.SimSpec(expert_bytes=1e3, layer_time_s=1 * MS,
                             capacity_experts=16)
        return pk.sv.simulate_serving(
            _micro(pk, _two_requests(pk)), spec,
            pk.hw.HardwareSpec(**FAST), _plain(pk.co),
            cfg=pk.sv.ServingConfig(max_batch=max_batch, prefill_chunk=16))
    mine, ref = _both(run)
    _same_serving(mine, ref)
    by_id = {m.request_id: m for m in mine.requests}
    tol = 1e-6
    if max_batch == 2:     # the reference test's two-request timeline
        assert by_id[0].ttft_s == pytest.approx(2 * MS, abs=tol)
        assert by_id[0].finish_s == pytest.approx(8 * MS, abs=tol)
        assert by_id[0].tpot_s == pytest.approx(3 * MS, abs=tol)
        assert by_id[1].queue_delay_s == pytest.approx(3.5 * MS, abs=tol)
        assert by_id[1].ttft_s == pytest.approx(5.5 * MS, abs=tol)
        assert mine.makespan_s == pytest.approx(8 * MS, abs=tol)
    else:                  # one slot serializes the two
        assert by_id[0].finish_s == pytest.approx(6 * MS, abs=tol)
        assert by_id[1].queue_delay_s == pytest.approx(5.5 * MS, abs=tol)
        assert by_id[1].finish_s == pytest.approx(10 * MS, abs=tol)


def test_prefill_scales_with_chunks_and_contention_on_the_port():
    hw = hardware.HardwareSpec(**FAST)
    spec = events.SimSpec(expert_bytes=1e3, layer_time_s=1 * MS,
                          capacity_experts=16)
    r0 = serving.ServingRequest(prompt_len=32, max_new_tokens=1,
                                steps=_micro_steps(PORT, 1, [[0], [1]]),
                                request_id=0)
    rep = serving.simulate_serving(
        _micro(PORT, [r0]), spec, hw, _plain(coordinator),
        cfg=serving.ServingConfig(max_batch=1, prefill_chunk=16))
    assert rep.requests[0].ttft_s == pytest.approx(4 * MS, abs=1e-6)
    assert rep.requests[0].tpot_s == 0.0

    def hot(rid, ebl):
        return serving.ServingRequest(
            prompt_len=16, max_new_tokens=10,
            steps=_micro_steps(PORT, 10, ebl), arrival_s=0.0,
            request_id=rid)

    def misses(reqs):
        wl = serving.ServingWorkload(2, 16, 1,
                                     [np.zeros((4, 16), np.float32)] * 2,
                                     reqs, name="contention")
        rep = serving.simulate_serving(
            wl, events.SimSpec(expert_bytes=1e3, layer_time_s=1 * MS,
                               capacity_experts=8),
            hw, _plain(coordinator),
            cfg=serving.ServingConfig(max_batch=2, prefill_chunk=16))
        return sum(sm.n_misses for sm in rep.run.steps)
    ra = [[0, 1, 2, 3], [4, 5, 6, 7]]
    rb = [[8, 9, 10, 11], [12, 13, 14, 15]]
    alone_a, alone_b = misses([hot(0, ra)]), misses([hot(1, rb)])
    assert alone_a == 8 and alone_b == 8
    assert misses([hot(0, ra), hot(1, rb)]) > alone_a + alone_b
    assert misses([hot(0, ra), hot(1, ra)]) < 2 * alone_a


def _synthetic_workload(pk, pattern="poisson", n=12, L=8, M=32, top_k=2,
                        d=16):
    routers = pk.wl.synthetic_routers(L, M, d, seed=0)
    reqs = [pk.sv.ServingRequest(
        prompt_len=s.prompt_len, max_new_tokens=s.decode_len,
        steps=pk.wl.synthetic_request_trace(s, L, M, top_k, routers, seed=1),
        arrival_s=s.arrival_s, request_id=s.request_id, topic=s.topic)
        for s in pk.wl.make_workload(pattern, n, seed=0)]
    return pk.sv.ServingWorkload(L, M, top_k, routers, reqs, name=pattern)


SERVING_CFGS = {
    "plain": {},
    "faults": dict(fault_plan="brownout", retry_max=2, retry_backoff_s=1e-4),
    "flaky": dict(fault_plan="flaky"),
    "tier": dict(host_budget_frac=0.4, disk_bandwidth=5e8),
    "tier_no_prefetch": dict(host_budget_frac=0.4, disk_prefetch=False),
    "tier_faults_verify": dict(host_budget_frac=0.5,
                               fault_plan="corrupt_flaky", verify="scrub"),
    "deadline": dict(deadline_s=0.02, max_batch=2),
}


def _serving_cfg(pk, name):
    kw = dict(SERVING_CFGS[name])
    plan = kw.pop("fault_plan", None)
    if plan is not None:
        kw["fault_plan"] = pk.faults.FaultPlan.from_arg(plan)
    return pk.sv.ServingConfig(**kw)


@pytest.mark.parametrize("cfg_name", list(SERVING_CFGS))
@pytest.mark.parametrize("policy", ["baseline", "pregate_s2", "promoe_s2",
                                    "expertflow"])
def test_simulate_serving_matches_reference(policy, cfg_name):
    def run(pk):
        spec = pk.ev.SimSpec(expert_bytes=17.3e6, layer_time_s=1 * MS,
                             capacity_experts=int(8 * 32 * 0.5))
        return pk.sv.simulate_serving(
            _synthetic_workload(pk, "bursty" if cfg_name == "deadline"
                                else "poisson"), spec,
            pk.hw.PLATFORMS["a6000"], POLICY_CASES[policy](pk.co),
            cfg=_serving_cfg(pk, cfg_name))
    mine, ref = _both(run)
    _same_serving(mine, ref)
    s = mine.summary()
    assert set(s) == set(ServingReport().summary())
    if cfg_name.startswith("tier"):
        assert s["n_host_misses"] > 0
    if cfg_name in ("faults", "flaky"):
        assert s["n_link_failures"] > 0


def test_serving_expertflow_beats_baseline_and_oracle_covers_batch():
    spec = events.SimSpec(expert_bytes=17.3e6, layer_time_s=1 * MS,
                          capacity_experts=int(8 * 32 * 0.5))
    P = hardware.PLATFORMS
    base = serving.simulate_serving(_synthetic_workload(PORT), spec,
                                    P["a6000"], coordinator.baseline())
    ef = serving.simulate_serving(_synthetic_workload(PORT), spec,
                                  P["a6000"], coordinator.expertflow())
    assert ef.run.total_stall_s < base.run.total_stall_s

    def rotating(rid, offset, n_steps=8, L=2, span=8):
        steps = [events.StepTrace(si, np.arange(4),
                                  [np.array([[offset + (si + li) % span]])
                                   for li in range(L)],
                                  np.zeros((L, 4), np.float32))
                 for si in range(n_steps)]
        return serving.ServingRequest(prompt_len=16, max_new_tokens=n_steps,
                                      steps=steps, arrival_s=0.0,
                                      request_id=rid)
    wl = serving.ServingWorkload(2, 16, 1,
                                 [np.zeros((4, 16), np.float32)] * 2,
                                 [rotating(0, 0), rotating(1, 8)],
                                 name="oracle")
    rep = serving.simulate_serving(
        wl, events.SimSpec(expert_bytes=1e6, layer_time_s=1 * MS,
                           capacity_experts=32),
        P["a6000"], coordinator.ablation("oracle", predictor="oracle",
                                         adaptive_s=False, fixed_s=2),
        cfg=serving.ServingConfig(max_batch=2, prefill_chunk=16))
    steady = rep.run.steps[3:]
    assert steady and sum(sm.stall_s for sm in steady) == pytest.approx(
        0.0, abs=1e-9)
    assert rep.run.steps[-1].n_prefetched > 0


def test_slo_metrics_and_report_keys_on_the_port():
    m = RequestMetrics(request_id=0, arrival_s=1.0, admitted_s=1.5,
                       first_token_s=2.0, finish_s=5.0, n_tokens=4)
    assert (m.queue_delay_s, m.ttft_s, m.tpot_s, m.e2e_s) == \
        pytest.approx((0.5, 1.0, 1.0, 4.0))
    assert RequestMetrics(1, 0, 0, 1, 1, n_tokens=1).tpot_s == 0.0
    xs = list(range(1, 101))
    assert percentile(xs, 50) == pytest.approx(50.5)
    assert percentile(xs, 99) == pytest.approx(99.01)
    assert percentile([], 50) == 0.0
    import repro_torch.runtime.serving as engine_backend
    assert engine_backend.ServingReport is ServingReport
    assert serving.ServingReport is ServingReport
    from repro.core.metrics import ServingReport as JaxServingReport
    assert set(ServingReport().summary()) == set(JaxServingReport().summary())


# ------------------------------------------- traces of the JAX Engine
@pytest.fixture(scope="module")
def engine_traces():
    """Per-request RoutingTraces of the JAX `Engine` on the DeepSeek smoke
    config (the serving CLI's recipe, 4 poisson requests), as numpy."""
    from repro.runtime.engine import Engine as JaxEngine
    cfg = jax_smoke("deepseek-v2-lite")
    eng = JaxEngine(cfg, max_seq=96)
    rng = np.random.default_rng(0)
    out, lines = [], []
    for spec in j_wl.make_workload("poisson", 4, seed=0, mean_decode=6):
        toks = j_wl.prompt_tokens(spec, cfg.vocab_size, rng)
        n = max(2, min(spec.decode_len, 6))
        _, trace, log = eng.generate(toks[None, :], n_steps=n)
        out.append((spec, trace))
        lines += [smp.to_json() for smp in log.samples]
    return out, lines


def _forest(pk_core, lines, trace):
    """The package's ForestPredictor fit on the JAX Engine's samples."""
    log = pk_core.TraceLog()
    log.extend(pk_core.Sample.from_json(x) for x in lines)
    f = pk_core.ForestPredictor(pk_core.FeatureSpec(
        102400, 8, trace.num_moe_layers, trace.num_experts,
        include_pregate=True))
    f.fit(log)
    return f


def _trace_in(pk, trace):
    tr = pk.ev.RoutingTrace(trace.model, trace.num_moe_layers,
                            trace.num_experts, trace.top_k,
                            [np.asarray(r) for r in trace.routers])
    tr.steps = [pk.ev.StepTrace(s.step_idx, np.asarray(s.token_ids),
                                [np.asarray(a) for a in s.assignments],
                                np.asarray(s.hidden_pooled), s.embeddings)
                for s in trace.steps]
    return tr


@pytest.mark.parametrize("policy", ["baseline", "pregate_s2", "promoe_s2",
                                    "expertflow", "oracle"])
def test_engine_traces_simulate_like_the_reference(engine_traces, forests,
                                                   policy):
    trace = engine_traces[0][0][1]
    L, M = trace.num_moe_layers, trace.num_experts
    for frac in (0.9, 0.4):
        mine, ref = (events.simulate(
            _trace_in(pk, trace), _sim(pk, frac, L=L, M=M),
            pk.hw.PLATFORMS["a100"], POLICY_CASES[policy](pk.co),
            forest=f) for pk, f in zip((PORT, REF), forests))
        _same_run(mine, ref)


@pytest.fixture(scope="module")
def forests(engine_traces):
    import repro.core as jax_core
    import repro_torch.core as port_core
    runs, lines = engine_traces
    return tuple(_forest(c, lines, runs[0][1])
                 for c in (port_core, jax_core))


@pytest.mark.parametrize("cfg_name", ["plain", "faults", "tier"])
@pytest.mark.parametrize("policy", ["baseline", "pregate_s2", "promoe_s2",
                                    "expertflow"])
def test_engine_traces_serve_like_the_reference(engine_traces, forests,
                                                policy, cfg_name):
    runs = engine_traces[0]

    def run(pk):
        reqs = [pk.sv.ServingRequest(
            prompt_len=s.prompt_len, max_new_tokens=len(t.steps),
            steps=_trace_in(pk, t).steps, arrival_s=s.arrival_s,
            request_id=s.request_id, topic=s.topic)
            for s, t in runs]
        t0 = runs[0][1]
        L, M = t0.num_moe_layers, t0.num_experts
        wl = pk.sv.ServingWorkload(L, M, t0.top_k,
                                   [np.asarray(r) for r in t0.routers], reqs,
                                   model=t0.model, name="poisson")
        spec = pk.ev.SimSpec(expert_bytes=4e6, layer_time_s=0.2 * MS,
                             capacity_experts=max(4, int(L * M * 0.6)))
        return pk.sv.simulate_serving(
            wl, spec, pk.hw.PLATFORMS["a6000"], POLICY_CASES[policy](pk.co),
            forest=forests[pk is REF], cfg=_serving_cfg(pk, cfg_name))
    mine, ref = _both(run)
    _same_serving(mine, ref)
    assert forests[0].trained
