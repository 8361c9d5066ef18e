"""Multi-tenant serving simulator: concurrent requests, one expert cache.

Extends the single-trace replay (`repro_torch.simulator.events.simulate`)
to the paper's actual evaluation regime (§4.1, continuous batching enabled): N
requests with distinct arrival times, prompt lengths, and decode lengths are
admitted into `ContinuousBatcher` slots, interleave their decode iterations,
and *share* one `TwoLevelLRU` expert cache, one host->device `TransferLink`,
and one adaptive step-size controller (all inside one `SimCore`).

Per decode iteration, per MoE layer l:
  - the layer's demand set is the UNION of the co-batched requests' actual
    expert assignments (token tables concatenated, so cache-aware routing
    sees the whole batch);
  - prefetch predictions are issued per request from its own hidden state
    and MERGED across the batch before tier maintenance and link submission.

Prefill is modelled as a full layer sweep whose per-layer compute scales
with ceil(prompt_len / prefill_chunk); the request's step-0 routing runs
through the shared cache during that sweep (seeding residency per tenant)
and the first output token is emitted when prefill completes. Subsequent
tokens arrive one per decode iteration, giving the TTFT / TPOT / queueing
SLO metrics in `core.metrics.ServingReport`.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from repro_torch.core.cache_aware import bias_reroute
from repro_torch.core.coordinator import Policy, PredictionSource
from repro_torch.core.expert_tiers import HostTierModel
from repro_torch.core.faults import FaultInjector, FaultPlan
from repro_torch.core.metrics import (RunReport, ServingReport, StepMetrics,
                                request_metrics)
from repro_torch.core.predictor import ForestPredictor
from repro_torch.core.step_size import token_diversity
from repro_torch.distributed.fault_tolerance import StragglerPolicy
from repro_torch.runtime.batching import ContinuousBatcher, WorkingSetAdmission
from repro_torch.runtime.request import Request
from repro_torch.simulator.events import SimCore, SimSpec, StepTrace, _distinct
from repro_torch.simulator.hardware import HardwareSpec

Key = Tuple[int, int]


@dataclass
class ServingRequest(Request):
    """The canonical `Request` plus a replayed routing trace and simulator
    runtime state.

    `steps[0]` supplies the prefill routing; `steps[t]` the t-th decode
    iteration's. Traces shorter than the decode length cycle (mod len).
    Lifecycle fields (slot/output/arrival_s/admitted_s/first_token_s/
    finish_s) come from `Request`, so `ContinuousBatcher` and
    `core.metrics.request_metrics` see the exact surface the real-engine
    path uses; there is no prompt token array (`prompt=None`) because the
    simulator replays pre-collected routing, so `prompt_len` is set
    directly.
    """
    steps: List[StepTrace] = field(default_factory=list)
    topic: int = 0
    # runtime state (owned by simulate_serving)
    step_idx: int = 0
    predicted: Dict[int, Set[Key]] = field(default_factory=dict)
    predicted_next: Dict[int, Set[Key]] = field(default_factory=dict)
    history: Optional[np.ndarray] = None

    def step_trace(self, i: int) -> StepTrace:
        return self.steps[i % len(self.steps)]

    @property
    def remaining_tokens(self) -> int:
        return self.max_new_tokens - len(self.output)

    @property
    def mean_distinct_experts(self) -> float:
        """Mean distinct experts per MoE layer across the trace — the
        request's expert working-set estimate for admission control."""
        counts = [len(_distinct(a)) for st in self.steps
                  for a in st.assignments]
        return float(np.mean(counts)) if counts else 0.0

    def reset_runtime(self) -> None:
        self.slot = -1
        self.output = []
        self.step_idx = 0
        self.admitted_s = self.first_token_s = self.finish_s = -1.0
        self.predicted = {}
        self.predicted_next = {}
        self.history = None


@dataclass
class ServingWorkload:
    """Model metadata + the request population hitting the device."""
    num_moe_layers: int
    num_experts: int
    top_k: int
    routers: List[np.ndarray]
    requests: List[ServingRequest]
    model: str = "synthetic"
    name: str = ""


@dataclass
class ServingConfig:
    max_batch: int = 4
    prefill_chunk: int = 16      # prompt tokens per layer-time of prefill
    max_iterations: int = 200000
    # working-set admission cap over the shared cache (ROADMAP adaptive-S
    # item): admit() consults the SimCore's step-size controller. The cap
    # only ever defers admissions; `headroom` scales the budget.
    admission_cap: bool = True
    admission_headroom: float = 1.0
    # fault injection (core.faults.FaultPlan), mirroring the live engine's
    # semantics in the timing model: brownout/jitter/stalls shape transfer
    # durations, transfer failures get bounded retry-with-backoff then
    # degrade (tokens of a permanently-missing expert drop), predictor
    # blackout suppresses prefetch. None (or a disabled plan) changes
    # nothing. Windows are in modeled seconds.
    fault_plan: Optional["FaultPlan"] = None
    retry_max: int = 3
    retry_backoff_s: float = 0.0
    # default per-request deadline (relative to arrival): still-queued
    # requests past it are shed at admission (None = never shed)
    deadline_s: Optional[float] = None
    # brownout admission via the single-replica StragglerPolicy drain
    # signal fed with modeled iteration latency (None = auto: on iff a
    # fault plan is configured)
    brownout_admission: Optional[bool] = None
    brownout_threshold: float = 4.0
    brownout_recovery: float = 1.5
    # disk->host->device tiered expert store (core.expert_tiers):
    # `host_budget_frac` sets the host staging budget as a fraction of the
    # total expert bytes (None = no tier, every expert pre-staged — the
    # pre-tier behavior, bit-identical); `disk_bandwidth` is the disk->host
    # link in bytes per modeled second; `disk_prefetch` gates the
    # popularity-driven S_disk prefetcher (off = every host miss is a
    # demand promotion, the ablation baseline).
    host_budget_frac: Optional[float] = None
    disk_bandwidth: float = 1e8
    disk_prefetch: bool = True
    disk_horizon_max: int = 64
    # expert integrity (core.integrity): `verify` enables promotion
    # verification ("promote") plus the budgeted background scrubber
    # ("scrub"); the modeled outcomes are drawn from the fault plan's
    # corrupt scope through the same (seed, salt, key, attempt) scheme
    # the engine's byte-level chaos uses, so both backends agree.
    verify: str = "off"
    scrub_budget: int = 2
    refetch_max: int = 3


def _token_table(assign: np.ndarray) -> np.ndarray:
    """Normalize a layer assignment to a (T, k) token->expert table."""
    a = np.asarray(assign)
    return a.reshape(-1, 1) if a.ndim == 1 else a


def _predict_target(core: SimCore, source: PredictionSource,
                    r: ServingRequest, st: StepTrace, li: int, s: int,
                    L: int) -> Optional[Set[Key]]:
    """Per-request prediction for layer li+s (wrapping into the request's
    next decode step past the last layer). Returns the predicted keys and
    records them in the request's predicted/predicted_next maps.

    Mirrors the single-stream wrap-target logic in `events.simulate` with
    per-request state in place of that loop's local dicts — a semantic
    change in either site must be applied to both.
    """
    tgt = li + s
    wrap = tgt >= L
    tgt_mod = tgt - L if wrap else tgt
    if tgt_mod >= L:
        return None
    if wrap:
        if r.remaining_tokens <= 1:      # no next decode step for r
            return None
        tgt_step = r.step_trace(r.step_idx + 1)
    else:
        tgt_step = st
    pred = source.predict(
        hidden=st.hidden_pooled[li][None, :], target_layer_pos=tgt_mod,
        token_ids=tgt_step.token_ids, s=s, history=r.history,
        actual=_distinct(tgt_step.assignments[tgt_mod]))
    pkeys = {(tgt_mod, e) for e in pred}
    (r.predicted_next if wrap else r.predicted)[tgt_mod] = pkeys
    return pkeys


def _outstanding(active: Sequence[ServingRequest]) -> Set[Key]:
    out: Set[Key] = set()
    for r in active:
        for v in r.predicted.values():
            out |= v
        for v in r.predicted_next.values():
            out |= v
    return out


def simulate_serving(workload: ServingWorkload, spec: SimSpec,
                     hw: HardwareSpec, policy: Policy,
                     forest: Optional[ForestPredictor] = None,
                     cfg: Optional[ServingConfig] = None) -> ServingReport:
    """Run the multi-request event loop; returns per-request SLO metrics
    plus the per-iteration stall decomposition."""
    cfg = cfg or ServingConfig()
    L, M = workload.num_moe_layers, workload.num_experts
    core = SimCore(spec, hw, policy)
    source = PredictionSource(policy, workload.routers, forest, M,
                              workload.top_k)
    admission = None
    if cfg.admission_cap:
        # the SHARED controller: the same instance the per-layer access
        # loop feeds with stall/overfetch signals steers admission
        admission = WorkingSetAdmission(
            controller=core.controller,
            slots_per_layer=max(1, spec.capacity_experts // max(L, 1)),
            expert_bytes=spec.expert_bytes,
            default_ws=float(workload.top_k),
            headroom=cfg.admission_headroom)
    if cfg.host_budget_frac is not None:
        total_bytes = spec.expert_bytes * L * M
        core.set_tier(HostTierModel(
            L, M, spec.expert_bytes,
            host_budget_bytes=cfg.host_budget_frac * total_bytes,
            disk_bandwidth=cfg.disk_bandwidth,
            disk_horizon_max=cfg.disk_horizon_max,
            prefetch=cfg.disk_prefetch))
    injector = None
    if cfg.fault_plan is not None and cfg.fault_plan.enabled:
        injector = FaultInjector(cfg.fault_plan)
        core.set_faults(injector, cfg.retry_max, cfg.retry_backoff_s)
        if core.tier is not None:
            core.tier.set_faults(injector, cfg.retry_max,
                                 cfg.retry_backoff_s)
    if core.tier is not None and cfg.verify != "off":
        # injector-drawn verification outcomes: the same pure draws the
        # engine's byte-flipping chaos consumes before its CRC check
        dv = injector.disk_view() if injector is not None else None
        if dv is not None:
            verify_fn = lambda key: not (dv.disk_record_corrupt(key)  # noqa: E731,E501
                                         or dv.promotion_corrupt(key))
            scrub_fn = lambda key: not dv.host_copy_corrupt(key)  # noqa: E731,E501
        else:
            verify_fn = scrub_fn = lambda key: True  # noqa: E731
        core.tier.configure_integrity(
            cfg.verify, scrub_budget=cfg.scrub_budget,
            refetch_max=cfg.refetch_max,
            verify_fn=verify_fn, scrub_fn=scrub_fn)
    straggler = StragglerPolicy(1, threshold=cfg.brownout_threshold,
                                recovery=cfg.brownout_recovery)
    brown = cfg.brownout_admission
    if brown is None:
        brown = injector is not None
    batcher = ContinuousBatcher(
        cfg.max_batch, admission=admission,
        brownout=(lambda: straggler.draining(0)) if brown else None)
    report = ServingReport(
        run=RunReport(policy=policy.name, platform=hw.name,
                      model=workload.model),
        policy=policy.name, platform=hw.name, model=workload.model,
        workload=workload.name)

    pending = sorted(workload.requests,
                     key=lambda r: (r.arrival_s, r.request_id))
    for r in pending:
        r.reset_runtime()
        r.history = np.zeros((L, M), np.float64)
        if admission is not None and r.predicted_ws is None:
            r.predicted_ws = r.mean_distinct_experts
        if cfg.deadline_s is not None and r.deadline_s is None:
            r.deadline_s = cfg.deadline_s

    now = 0.0
    it = 0
    s_initialized = False
    n_degraded_steps = 0

    def finish(r: ServingRequest, t: float) -> None:
        r.finish_s = t
        report.add_request(request_metrics(r))

    while pending or batcher.has_work:
        if it >= cfg.max_iterations:
            raise RuntimeError("serving simulation exceeded max_iterations")

        # open-loop arrivals: enqueue everything that has arrived by `now`
        while pending and pending[0].arrival_s <= now:
            batcher.submit(pending.pop(0))
        if not batcher.active and not batcher.waiting:
            now = max(now, pending[0].arrival_s)     # idle: jump to arrival
            continue

        # -- admission + prefill (serial: prefill occupies the accelerator)
        for r in batcher.admit(now=now):
            r.admitted_s = now
            sm = StepMetrics(step=it)
            it += 1
            st0 = r.step_trace(0)
            if policy.adaptive_s and not s_initialized \
                    and st0.embeddings is not None:
                pg0 = source.pregate.probs(st0.hidden_pooled[0][None, :], 0)
                core.controller.initialize(pg0, spec.expert_bytes,
                                           token_diversity(st0.embeddings))
                s_initialized = True
            s = core.s
            sm.step_size = s
            chunks = max(1, math.ceil(r.prompt_len / cfg.prefill_chunk))
            layer_t = spec.layer_time_s * chunks
            for li in range(L):
                core.land_arrivals(now, sm)
                now = core.access_layer(li, st0.assignments[li], now, sm,
                                        layer_time_s=layer_t)
                if policy.prefetch:
                    pkeys = _predict_target(core, source, r, st0, li, s, L)
                    if pkeys:
                        # tier maintenance must see ALL co-resident tenants'
                        # predictions, not just the admitted request's —
                        # otherwise prefill demotes its neighbours' experts
                        tenants = list(batcher.active.values())
                        core.note_predictions(
                            li,
                            _outstanding(tenants) if policy.two_level_lru
                            else set(), s)
                        core.issue_prefetches(pkeys, now)
                for e in _distinct(st0.assignments[li]):
                    r.history[li, e] = 1.0
            r.output.append(0)
            r.first_token_s = now
            sm.n_prefetched = core.pf.n_prefetches
            report.run.add(sm)
            if r.done:                   # 1-token request: done at prefill
                finish(r, now)
                batcher.release(r)

        active = [batcher.active[slot] for slot in batcher.active_slots()]
        if not active:
            continue

        # -- one decode iteration across all co-batched requests ------------
        sm = StepMetrics(step=it)
        it += 1
        s = core.s
        sm.step_size = s
        fail0 = core.n_demand_failures
        for r in active:
            r.step_idx += 1
            r.predicted, r.predicted_next = r.predicted_next, {}
            r.history = np.zeros((L, M), np.float64)

        # step-begin prefetch for early layers not already covered by the
        # previous step's wraparound predictions
        if policy.prefetch:
            begin_keys: Set[Key] = set()
            for r in active:
                cur = r.step_trace(r.step_idx)
                prev = r.step_trace(r.step_idx - 1)
                for tgt in range(min(s, L)):
                    if tgt in r.predicted:
                        continue
                    pred = source.predict(
                        hidden=prev.hidden_pooled[tgt][None, :],
                        target_layer_pos=tgt, token_ids=cur.token_ids,
                        s=s, history=r.history,
                        actual=_distinct(cur.assignments[tgt]))
                    keys = {(tgt, e) for e in pred}
                    r.predicted[tgt] = keys
                    begin_keys |= keys
            core.issue_prefetches(begin_keys, now)

        for li in range(L):
            core.land_arrivals(now, sm)
            # §3.4 bounded perturbation, mirroring the live engine: each
            # request's non-resident assignments may swap to a resident
            # expert within `route_bias` logits (pre-gate log-probs stand in
            # for the per-layer router logits the trace doesn't carry).
            # Adaptive mode (step_cfg.route_bias_max > 0) tracks the shared
            # controller's ramped strength, exactly as the engine does.
            rb = policy.route_bias if policy.cache_aware else 0.0
            if rb > 0.0 and core.controller.cfg.route_bias_max > 0.0:
                rb = min(core.controller.route_bias, rb)
            if rb > 0.0:
                resident_li = {e for (l, e) in core.cache.resident()
                               if l == li}
                tables = []
                for r in active:
                    st = r.step_trace(r.step_idx)
                    lg = np.log(source.pregate.probs(
                        st.hidden_pooled[li][None, :], li) + 1e-12)
                    tbl, n = bias_reroute(
                        _token_table(st.assignments[li]), lg, resident_li,
                        rb)
                    sm.n_rerouted += n
                    tables.append(tbl)
                merged = np.concatenate(tables, axis=0)
            else:
                merged = np.concatenate(
                    [_token_table(r.step_trace(r.step_idx).assignments[li])
                     for r in active], axis=0)
            now = core.access_layer(li, merged, now, sm)

            if policy.prefetch:
                new_keys: Set[Key] = set()
                predicted_any = False
                for r in active:
                    st = r.step_trace(r.step_idx)
                    pkeys = _predict_target(core, source, r, st, li, s, L)
                    if pkeys is not None:
                        predicted_any = True
                        new_keys |= pkeys
                if predicted_any:
                    core.note_predictions(
                        li,
                        _outstanding(active) if policy.two_level_lru
                        else set(), s)
                    core.issue_prefetches(new_keys, now)

            for r in active:
                for e in _distinct(r.step_trace(r.step_idx).assignments[li]):
                    r.history[li, e] = 1.0

        sm.n_prefetched = core.pf.n_prefetches
        # degraded iteration: a demand transfer failed for good this step
        # (tokens dropped), or admission is browned out on modeled latency —
        # same definition shape as the engine's degraded_steps counter
        if core.n_demand_failures > fail0 or straggler.draining(0):
            n_degraded_steps += 1
        straggler.record(0, sm.total_s)
        report.run.add(sm)

        for r in batcher.step({r.slot: 0 for r in active}):
            finish(r, now)

    report.makespan_s = now
    report.mean_occupancy = batcher.stats.mean_occupancy
    report.n_link_failures = core.pf.n_failed + core.pf.link.n_failed
    report.n_retries = core.pf.n_retries
    report.n_degraded_steps = n_degraded_steps
    report.n_shed = batcher.stats.shed
    if core.tier is not None:
        report.n_host_hits = core.tier.host_hits
        report.n_host_misses = core.tier.host_misses
        report.disk_stall_s = core.tier.disk_stall_s
        g = core.tier.guard
        report.n_corrupt_detected = g.n_corrupt_detected
        report.n_requarantined = g.n_requarantined
        report.n_scrubbed = g.n_scrubbed
        report.n_quarantined_experts = g.n_quarantined_experts
    return report
