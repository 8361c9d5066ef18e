"""Discrete-event MoE inference simulator.

Replays *real* routing traces (collected by `repro_torch.runtime.engine`'s
`Engine` from real model execution) through a timing model of one
accelerator + one host->device transfer link, under a pluggable `Policy`
(baseline / pre-gate / ProMoE-like / ExpertFlow). Produces the
waiting-latency / cache-miss-latency metrics of the paper's §4.

Timeline model per decode step, per MoE layer l:
  1. transfers that completed before `now` land in the cache;
  2. the layer's *actual* expert set (from the trace) is checked against the
     cache: resident -> hit; in-flight -> waiting stall; absent -> demand
     load at miss priority (cache-miss stall);
  3. with cache-aware routing, tokens whose experts are resident compute
     first and transfers overlap; otherwise the whole layer blocks;
  4. the policy issues prefetches for layer l+S (predictions from pre-gate /
     forest over current hidden states);
  5. counters feed the adaptive-S controller; tier assignments update.

The accelerator-side state machine (cache + link + controller + stall
accounting) lives in `SimCore` so the single-trace replay below and the
multi-tenant serving loop (`repro_torch.simulator.serving`) share one timing
model.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

import numpy as np

from repro_torch.core.cache import TwoLevelLRU
from repro_torch.core.cache_aware import (overlap_schedule, sequential_schedule,
                                    split_by_residency)
from repro_torch.core.coordinator import Policy, PredictionSource
from repro_torch.core.metrics import RunReport, StepMetrics
from repro_torch.core.predictor import ForestPredictor
from repro_torch.core.prefetcher import Prefetcher, TransferLink
from repro_torch.core.step_size import StepSizeController, token_diversity
from repro_torch.simulator.hardware import HardwareSpec

Key = Tuple[int, int]


@dataclass
class StepTrace:
    """Routing observations for one decode step (from real execution)."""
    step_idx: int
    token_ids: np.ndarray          # (T_ctx,) int — context ids at this step
                                   # (prompt + tokens decoded so far)
    assignments: List[np.ndarray]  # per MoE layer: (T, k) expert ids
    hidden_pooled: np.ndarray      # (L_moe, d) mean hidden state per MoE layer
    embeddings: Optional[np.ndarray] = None  # (T, d) token embeds (diversity)


@dataclass
class RoutingTrace:
    model: str
    num_moe_layers: int
    num_experts: int               # per layer
    top_k: int
    routers: List[np.ndarray]      # per MoE layer (d, E)
    steps: List[StepTrace] = field(default_factory=list)
    bytes_per_param: float = 2.0


@dataclass
class SimSpec:
    """Timing constants for the simulated platform/model pair."""
    expert_bytes: float
    layer_time_s: float            # per-layer compute time T_l
    capacity_experts: int          # device cache size in experts


def _distinct(assign: np.ndarray) -> List[int]:
    return sorted({int(e) for e in np.asarray(assign).reshape(-1)})


class SimCore:
    """One accelerator's shared expert-residency state.

    Bundles the expert cache, host->device link, prefetcher, and adaptive-S
    controller, plus the per-layer access/stall-attribution logic. One
    `SimCore` is shared by every request stream hitting the device — the
    single-trace `simulate()` holds one implicitly; the serving simulator
    routes all concurrent requests through one instance.
    """

    def __init__(self, spec: SimSpec, hw: HardwareSpec, policy: Policy):
        self.spec = spec
        self.hw = hw
        self.policy = policy
        self.link = TransferLink(hw.host_bw)
        self.pf = Prefetcher(self.link, spec.expert_bytes,
                             blocking_swap_out=policy.blocking_swap_out)
        self.cache = TwoLevelLRU(spec.capacity_experts)
        self.controller = StepSizeController(
            cfg=policy.step_cfg, s=policy.fixed_s,
            bandwidth_est=hw.host_bw, layer_time_est=spec.layer_time_s)
        self.prefetched_unused: Set[Key] = set()
        # fault injection (core.faults), mirrored from the live engine via
        # set_faults(); None = fault-free, every code path unchanged
        self.faults = None
        self.retry_max = 0
        self.retry_backoff_s = 0.0
        self.n_demand_failures = 0    # demand transfers that failed for good
        # optional disk->host staging tier (core.expert_tiers): when set,
        # every demand traverses the two-link chain disk->host->device and
        # the popularity-driven S_disk prefetcher runs per layer access
        self.tier = None

    def set_tier(self, tier) -> None:
        """Attach a `HostTierModel` beneath the device cache. The tier
        shares this core's controller so its layer-time/stall signals size
        the disk horizon, mirroring the live engine."""
        self.tier = tier
        tier.controller = self.controller

    def set_faults(self, injector, retry_max: int = 3,
                   retry_backoff_s: float = 0.0) -> None:
        """Mirror the engine's FaultPlan semantics in the timing model:
        brownout/jitter/stalls shape modeled transfer durations via the
        link hooks, transfer failures are drawn at modeled completion time
        inside `Prefetcher.demand`/`advance`, and predictor blackout
        windows suppress prefetch issue."""
        self.faults = injector
        self.retry_max = int(retry_max)
        self.retry_backoff_s = float(retry_backoff_s)
        injector.attach_link(self.link)
        self.pf.injector = injector

    @property
    def s(self) -> int:
        return self.controller.s if self.policy.adaptive_s \
            else self.policy.fixed_s

    # -- residency bookkeeping ---------------------------------------------
    def insert(self, key: Key, sm: StepMetrics) -> None:
        """Land a transferred expert in the cache (with eviction fallout)."""
        if key in self.cache:
            return
        victim = self.cache.insert(key, high=not self.policy.two_level_lru)
        if self.tier is not None:
            # device residency pins the host copy (tier can't drop it)
            self.tier.pin(key)
        if victim is not None:
            self.pf.forget(victim)
            self.pf.writeback(0.0)
            if self.tier is not None:
                self.tier.unpin(victim)
            if victim in self.prefetched_unused:
                self.prefetched_unused.discard(victim)
                sm.n_overfetched += 1
                self.controller.record_overfetch()

    def land_arrivals(self, now: float, sm: StepMetrics) -> None:
        """Insert transfers completed by `now` into the cache."""
        for key in self.pf.advance(now):
            self.insert(key, sm)

    # -- layer execution ----------------------------------------------------
    def access_layer(self, li: int, assignments: np.ndarray, now: float,
                     sm: StepMetrics, layer_time_s: Optional[float] = None,
                     actual: Optional[List[int]] = None) -> float:
        """Run one MoE layer's expert accesses and compute at time `now`.

        `assignments` is the (T, k) token->expert table for the layer — for
        a co-scheduled batch, the concatenation over all requests in the
        batch. `actual` is its distinct expert list, passable when the
        caller already computed it. Resolves misses via demand loads,
        attributes exposed stall (cold -> cache-miss, in-flight -> waiting),
        and returns the layer's finish time.
        """
        lt = self.spec.layer_time_s if layer_time_s is None else layer_time_s
        if actual is None:
            actual = _distinct(assignments)
        keys = [(li, e) for e in actual]
        if self.tier is not None:
            self.tier.advance(now)
            self.tier.note_layer_demand(len(keys))

        missing_inflight: List[Key] = []
        missing_cold: List[Key] = []
        for key in keys:
            if self.cache.touch(key, high=self.policy.two_level_lru):
                sm.n_hits += 1
                if self.tier is not None:
                    self.tier.note_access(key)
                self.prefetched_unused.discard(key)
            else:
                sm.n_misses += 1
                if key in self.pf.issued:
                    missing_inflight.append(key)
                else:
                    missing_cold.append(key)

        # resolve misses: cold demands go at top priority (§3.4)
        ready_t = now
        failed: Set[Key] = set()
        for key in missing_cold + missing_inflight:
            t_host = now
            if self.tier is not None:
                # the two-link chain: host residency first (a host miss
                # stalls on the disk link and records a controller stall,
                # just like a device miss), then the device transfer
                # starts once the expert is staged
                r = self.tier.demand(key, now)
                if r is None:
                    # disk faults defeated the promotion: the expert's
                    # tokens drop, mirroring the device-link degradation
                    self.n_demand_failures += 1
                    failed.add(key)
                    continue
                t_host = now + r[0]
            t_done = self.pf.demand(key, t_host, max_retries=self.retry_max,
                                    backoff_s=self.retry_backoff_s)
            if t_done is None:
                # permanent transfer failure (fault injection): the layer
                # runs without the expert — its tokens drop, mirroring the
                # live engine's dead-sentinel degradation — instead of
                # waiting on a link that will never deliver
                self.n_demand_failures += 1
                failed.add(key)
                continue
            ready_t = max(ready_t, t_done)
            self.insert(key, sm)
        # failed keys stay in `missing` (they are NOT resident — their
        # tokens drop) but don't gate compute start: nothing waits on a
        # transfer that will never land
        missing = set(missing_cold) | set(missing_inflight)
        waited = missing - failed
        if self.tier is not None:
            # issue the long-horizon disk promotions at layer START: the
            # d=1 wave then has this layer's compute time as lead, exactly
            # like the live engine (promotion at clock t, demand at t+1) —
            # issued at layer finish it would land at the very instant the
            # next layer demands it, i.e. always late
            self.tier.auto_prefetch(now, li)
            # budgeted integrity scrub rides the same layer boundary the
            # engine's _advance_clock uses (no-op unless configured)
            self.tier.scrub_tick(now)

        # schedule layer compute
        if self.policy.cache_aware and missing:
            resident_set = {e for (l2, e) in keys if (l2, e) not in missing}
            split = split_by_residency(assignments, resident_set)
            finish, exposed = overlap_schedule(split, lt, ready_t, now)
        else:
            finish, exposed = sequential_schedule(
                lt, ready_t if waited else now, now)
        # attribute exposed stall: in-flight -> waiting, cold -> miss
        if exposed > 0:
            if missing_cold:
                sm.cache_miss_s += exposed
            else:
                sm.waiting_s += exposed
            self.controller.record_stall()
        sm.compute_s += finish - now - exposed
        self.controller.update_layer_time(lt)
        return finish

    # -- prefetch issue -----------------------------------------------------
    def note_predictions(self, li: int, outstanding: Set[Key],
                         s: Optional[int] = None) -> None:
        """Tier maintenance after a prediction round at layer `li`. `s` is
        the step size frozen at step start (the live controller value may
        already have moved mid-step)."""
        if self.policy.two_level_lru:
            self.cache.retier(outstanding, range(max(0, li - 2), li + 1), li)
        if self.policy.protect_early_layers:
            self.cache.protect_early_layers(self.s if s is None else s)

    def issue_prefetches(self, pkeys: Iterable[Key], now: float) -> None:
        if self.faults is not None and self.faults.predictor_blackout(now):
            return        # predictor signal dark: nothing to speculate on
        if self.tier is not None:
            self.tier.note_predicted(pkeys)
        for key in pkeys:
            if key not in self.cache:
                if self.tier is not None \
                        and not self.tier.host_resident(key):
                    # host-absent: queue the disk->host promotion; the
                    # device prefetch happens once the expert is staged
                    self.tier.request(key, now)
                    continue
                self.pf.prefetch(key, now)
                self.prefetched_unused.add(key)


def simulate(trace: RoutingTrace, spec: SimSpec, hw: HardwareSpec,
             policy: Policy, forest: Optional[ForestPredictor] = None,
             max_steps: Optional[int] = None) -> RunReport:
    L, M = trace.num_moe_layers, trace.num_experts
    core = SimCore(spec, hw, policy)
    source = PredictionSource(policy, trace.routers, forest, M, trace.top_k)
    report = RunReport(policy=policy.name, platform=hw.name, model=trace.model)

    predicted_sets: Dict[int, Set[Key]] = {}
    predicted_next: Dict[int, Set[Key]] = {}
    now = 0.0
    prev_step: Optional[StepTrace] = None

    steps = trace.steps[:max_steps] if max_steps else trace.steps
    for si, st in enumerate(steps):
        next_st = steps[si + 1] if si + 1 < len(steps) else None
        predicted_sets, predicted_next = predicted_next, {}
        sm = StepMetrics(step=st.step_idx)
        history = np.zeros((L, M), np.float64)
        if policy.adaptive_s and st.step_idx == 0 and st.embeddings is not None:
            # initial S from the formula (§3.2.1) using layer-0 pre-gate
            pg0 = source.pregate.probs(st.hidden_pooled[0][None, :], 0)
            core.controller.initialize(pg0, spec.expert_bytes,
                                       token_diversity(st.embeddings))
        s = core.s
        sm.step_size = s

        # step-begin prefetch for early layers not already covered by the
        # previous step's wraparound predictions (one decode step stale).
        # The serving loop (`serving.simulate_serving`) mirrors this and the
        # li+s wrap-target prediction below per request — keep them in sync.
        if policy.prefetch and prev_step is not None:
            for tgt in range(min(s, L)):
                if tgt in predicted_sets:
                    continue
                hid = prev_step.hidden_pooled[tgt][None, :]
                pred = source.predict(
                    hidden=hid, target_layer_pos=tgt,
                    token_ids=st.token_ids, s=s, history=history,
                    actual=_distinct(st.assignments[tgt]))
                keys = {(tgt, e) for e in pred}
                predicted_sets[tgt] = keys
                core.issue_prefetches(keys, now)

        for li in range(L):
            core.land_arrivals(now, sm)
            actual = _distinct(st.assignments[li])
            now = core.access_layer(li, st.assignments[li], now, sm,
                                    actual=actual)

            # issue prefetch for layer li + s (prediction from current
            # hidden); past the last layer it wraps into the next decode
            # step's early layers (§3.3.1 early-layer reuse)
            if policy.prefetch:
                tgt = li + s
                wrap = tgt >= L
                tgt_mod = tgt - L if wrap else tgt
                tgt_step = next_st if wrap else st
                if tgt_step is not None and tgt_mod < L:
                    pred = source.predict(
                        hidden=st.hidden_pooled[li][None, :],
                        target_layer_pos=tgt_mod,
                        token_ids=tgt_step.token_ids, s=s, history=history,
                        actual=_distinct(tgt_step.assignments[tgt_mod]))
                    pkeys = {(tgt_mod, e) for e in pred}
                    (predicted_next if wrap else predicted_sets)[tgt_mod] = pkeys
                    outstanding: Set[Key] = set()
                    if policy.two_level_lru:     # only retier consumes it
                        for v in predicted_sets.values():
                            outstanding |= v
                        for v in predicted_next.values():
                            outstanding |= v
                    core.note_predictions(li, outstanding, s)
                    core.issue_prefetches(pkeys, now)

            # history update (forest feature)
            for e in actual:
                history[li, e] = 1.0

        sm.n_prefetched = core.pf.n_prefetches
        report.add(sm)
        prev_step = st
    return report
