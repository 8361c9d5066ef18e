"""Latency/stall metrics aggregation for simulator runs and engine steps.

Two granularities:
- `StepMetrics` / `RunReport`: per decode-iteration stall/hit accounting
  (the paper's §4 waiting / cache-miss latency decomposition);
- `RequestMetrics` / `ServingReport`: per-request SLO metrics for the
  multi-tenant serving simulator — TTFT, TPOT, queueing delay, and their
  p50/p95/p99 tails across the request population.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Sequence

import numpy as np


@dataclass
class StepMetrics:
    step: int = 0
    compute_s: float = 0.0
    waiting_s: float = 0.0        # stall on predicted-but-late experts
    cache_miss_s: float = 0.0     # stall on unpredicted experts (demand loads)
    n_hits: int = 0
    n_misses: int = 0
    n_prefetched: int = 0
    n_overfetched: int = 0
    n_rerouted: int = 0           # §3.4 assignments swapped to resident experts
    step_size: int = 0

    @property
    def stall_s(self) -> float:
        return self.waiting_s + self.cache_miss_s

    @property
    def total_s(self) -> float:
        return self.compute_s + self.stall_s


@dataclass
class RunReport:
    steps: List[StepMetrics] = field(default_factory=list)
    policy: str = ""
    platform: str = ""
    model: str = ""

    def add(self, m: StepMetrics) -> None:
        self.steps.append(m)

    @property
    def total_compute_s(self) -> float:
        return sum(s.compute_s for s in self.steps)

    @property
    def total_waiting_s(self) -> float:
        return sum(s.waiting_s for s in self.steps)

    @property
    def total_cache_miss_s(self) -> float:
        return sum(s.cache_miss_s for s in self.steps)

    @property
    def total_stall_s(self) -> float:
        return self.total_waiting_s + self.total_cache_miss_s

    @property
    def total_s(self) -> float:
        return self.total_compute_s + self.total_stall_s

    @property
    def hit_rate(self) -> float:
        h = sum(s.n_hits for s in self.steps)
        m = sum(s.n_misses for s in self.steps)
        return h / (h + m) if h + m else 1.0

    def summary(self) -> Dict[str, float]:
        return {
            "policy": self.policy,
            "platform": self.platform,
            "model": self.model,
            "compute_s": self.total_compute_s,
            "waiting_s": self.total_waiting_s,
            "cache_miss_s": self.total_cache_miss_s,
            "stall_s": self.total_stall_s,
            "total_s": self.total_s,
            "hit_rate": self.hit_rate,
            "mean_step_size": (sum(s.step_size for s in self.steps)
                               / max(len(self.steps), 1)),
        }


# ---------------------------------------------------------------------------
# Per-request SLO metrics (multi-tenant serving)
# ---------------------------------------------------------------------------

PERCENTILES = (50, 95, 99)


def percentile(xs: Sequence[float], q: float) -> float:
    """Linear-interpolation percentile; 0.0 on an empty population."""
    if not len(xs):
        return 0.0
    return float(np.percentile(np.asarray(xs, np.float64), q))


@dataclass
class RequestMetrics:
    """Lifecycle timestamps for one served request (all absolute seconds)."""
    request_id: int
    arrival_s: float
    admitted_s: float       # left the waiting queue, slot assigned
    first_token_s: float    # prefill complete, first token emitted
    finish_s: float         # last token emitted
    n_tokens: int           # output tokens (>= 1)
    prompt_len: int = 0
    # chunked prefill: when the prompt finished ingesting (may span several
    # serving iterations, interleaved with decode); < 0 = not recorded
    # (monolithic / simulator paths), in which case prefill is taken to run
    # right up to the first token
    prefill_done_s: float = -1.0

    @property
    def queue_delay_s(self) -> float:
        return self.admitted_s - self.arrival_s

    @property
    def prefill_s(self) -> float:
        """Prompt-ingestion span: admission -> prompt fully in cache. Under
        chunked serving this includes the decode iterations interleaved
        between chunks — the fairness cost a long prompt pays so co-batched
        decoders don't stall."""
        end = (self.prefill_done_s if self.prefill_done_s >= 0
               else self.first_token_s)
        return end - self.admitted_s

    @property
    def first_step_s(self) -> float:
        """Prefill-complete -> first token emitted (sampling + bookkeeping);
        0 when prefill completion wasn't separately recorded."""
        if self.prefill_done_s < 0:
            return 0.0
        return self.first_token_s - self.prefill_done_s

    @property
    def ttft_s(self) -> float:
        """Time to first token, measured from arrival (includes queueing).
        Identity: ttft_s == queue_delay_s + prefill_s + first_step_s."""
        return self.first_token_s - self.arrival_s

    @property
    def tpot_s(self) -> float:
        """Time per output token over the decode phase (0 for 1-token
        requests, which have no decode phase)."""
        if self.n_tokens <= 1:
            return 0.0
        return (self.finish_s - self.first_token_s) / (self.n_tokens - 1)

    @property
    def e2e_s(self) -> float:
        return self.finish_s - self.arrival_s


def request_metrics(r) -> RequestMetrics:
    """Build the SLO record from any served request object carrying the
    canonical `runtime.request.Request` lifecycle fields (the real-engine
    path and the simulator's trace-replaying subclass both do)."""
    return RequestMetrics(request_id=r.request_id, arrival_s=r.arrival_s,
                          admitted_s=r.admitted_s,
                          first_token_s=r.first_token_s,
                          finish_s=r.finish_s, n_tokens=len(r.output),
                          prompt_len=r.prompt_len,
                          prefill_done_s=getattr(r, "prefill_done_s", -1.0))


@dataclass
class ServingReport:
    """Multi-request serving run: per-iteration stalls + per-request SLOs."""
    run: RunReport = field(default_factory=RunReport)
    requests: List[RequestMetrics] = field(default_factory=list)
    policy: str = ""
    platform: str = ""
    model: str = ""
    workload: str = ""
    makespan_s: float = 0.0
    mean_occupancy: float = 0.0
    # health counters (fault injection / graceful degradation): filled
    # identically by the engine and simulator backends
    n_link_failures: int = 0      # injected transfer failures observed
    n_retries: int = 0            # demand-transfer retry attempts
    n_degraded_steps: int = 0     # decode iterations in degraded mode
    n_shed: int = 0               # requests dropped past their deadline
    # tiered expert store (disk->host->device, core.expert_tiers) health —
    # all zero when serving from a pre-staged host store
    n_host_hits: int = 0          # demanded experts already host-staged
    n_host_misses: int = 0        # demanded experts promoted from disk
    disk_stall_s: float = 0.0     # exposed disk-link stall
    # expert integrity (checksummed tiers, core.integrity) — all zero
    # with verification off or a clean store
    n_corrupt_detected: int = 0   # verifications that failed
    n_requarantined: int = 0      # corrupt episodes healed by re-fetch
    n_scrubbed: int = 0           # background re-verifications run
    n_quarantined_experts: int = 0  # permanently quarantined (gauge)
    # every gap between two output tokens of one request, s (the real
    # engine's server records them; empty elsewhere)
    token_gaps_s: List[float] = field(default_factory=list)

    def add_request(self, m: RequestMetrics,
                    token_times_s: Sequence[float] = ()) -> None:
        """Record a finished request; `token_times_s`: its tokens' times,
        whose gaps `itl()` reads."""
        self.requests.append(m)
        self.token_gaps_s.extend(b - a for a, b in zip(token_times_s,
                                                        token_times_s[1:]))

    def _dist(self, attr: str) -> Dict[str, float]:
        xs = [getattr(r, attr) for r in self.requests]
        out = {f"p{q}": percentile(xs, q) for q in PERCENTILES}
        out["mean"] = float(np.mean(xs)) if xs else 0.0
        return out

    @property
    def ttft(self) -> Dict[str, float]:
        return self._dist("ttft_s")

    @property
    def tpot(self) -> Dict[str, float]:
        # 1-token requests have no decode phase; exclude them from TPOT
        xs = [r.tpot_s for r in self.requests if r.n_tokens > 1]
        out = {f"p{q}": percentile(xs, q) for q in PERCENTILES}
        out["mean"] = float(np.mean(xs)) if xs else 0.0
        return out

    @property
    def queue_delay(self) -> Dict[str, float]:
        return self._dist("queue_delay_s")

    @property
    def ttft_split(self) -> Dict[str, float]:
        """Mean TTFT attribution: time in queue vs prompt ingestion vs the
        first sampling step. The three components sum to mean TTFT, so a
        regression shows WHERE first-token latency went (admission backlog,
        prefill serialization, or sampling overhead)."""
        out = {}
        for name, attr in (("queue", "queue_delay_s"),
                           ("prefill", "prefill_s"),
                           ("first_step", "first_step_s")):
            xs = [getattr(r, attr) for r in self.requests]
            out[name] = float(np.mean(xs)) if xs else 0.0
        return out

    def itl(self) -> Dict[str, float]:
        """Inter-token latency over EVERY gap between two output tokens of
        one request (not per-request means, as TPOT is): p50 / p95 / p99
        and the mean, in seconds; zeros where no token times were
        recorded."""
        xs = self.token_gaps_s
        out = {f"p{q}": percentile(xs, q) for q in PERCENTILES}
        out["mean"] = float(np.mean(xs)) if xs else 0.0
        return out

    @property
    def throughput_tok_s(self) -> float:
        n = sum(r.n_tokens for r in self.requests)
        return n / self.makespan_s if self.makespan_s > 0 else 0.0

    def summary(self) -> Dict[str, float]:
        out = {
            "policy": self.policy,
            "platform": self.platform,
            "model": self.model,
            "workload": self.workload,
            "n_requests": len(self.requests),
            "makespan_s": self.makespan_s,
            "throughput_tok_s": self.throughput_tok_s,
            "mean_occupancy": self.mean_occupancy,
            "stall_s": self.run.total_stall_s,
            "compute_s": self.run.total_compute_s,
            "waiting_s": self.run.total_waiting_s,
            "cache_miss_s": self.run.total_cache_miss_s,
            "hit_rate": self.run.hit_rate,
            "n_link_failures": self.n_link_failures,
            "n_retries": self.n_retries,
            "n_degraded_steps": self.n_degraded_steps,
            "n_shed": self.n_shed,
            "n_host_hits": self.n_host_hits,
            "n_host_misses": self.n_host_misses,
            "disk_stall_s": self.disk_stall_s,
            "n_corrupt_detected": self.n_corrupt_detected,
            "n_requarantined": self.n_requarantined,
            "n_scrubbed": self.n_scrubbed,
            "n_quarantined_experts": self.n_quarantined_experts,
        }
        for name, dist in (("ttft", self.ttft), ("tpot", self.tpot),
                           ("queue_delay", self.queue_delay)):
            for k, v in dist.items():
                out[f"{name}_{k}_s"] = v
        for k, v in self.ttft_split.items():
            out[f"ttft_{k}_mean_s"] = v
        return out
