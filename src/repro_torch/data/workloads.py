"""Serving workload generation: arrival processes + per-request routing.

Three arrival patterns drive the multi-tenant serving simulator
(`repro_torch.simulator.serving`):

- ``poisson``: open-loop Poisson arrivals at a fixed rate — the steady
  heavy-traffic regime;
- ``bursty``: flash crowds — tightly clustered bursts separated by idle
  gaps, stressing queueing and cache churn on re-warm;
- ``mixed``: Poisson arrivals with a bimodal short/long prompt mix, so
  long prefills head-of-line-block short interactive requests.

Each request also gets a *topic*: per-request routing traces are biased
toward a topic-specific hot expert pool (`synthetic_request_trace`), so
co-resident tenants with different topics contend for cache capacity —
the qualitative difference between single-stream replay and serving.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.simulator.events import StepTrace

WORKLOAD_PATTERNS = ("poisson", "bursty", "mixed")


@dataclass
class RequestSpec:
    """One request's shape, before any routing trace is attached."""
    arrival_s: float
    prompt_len: int
    decode_len: int            # output tokens incl. the prefill token
    topic: int
    request_id: int = 0


# ---------------------------------------------------------------------------
# Arrival processes
# ---------------------------------------------------------------------------

def poisson_arrivals(n: int, rate_rps: float,
                     rng: np.random.Generator) -> np.ndarray:
    """Open-loop Poisson process: exponential inter-arrival gaps."""
    if n <= 0:
        return np.zeros(0)
    gaps = rng.exponential(1.0 / max(rate_rps, 1e-9), size=n)
    t = np.cumsum(gaps)
    return t - t[0]            # first request arrives at t=0


def bursty_arrivals(n: int, burst_size: int, gap_s: float,
                    intra_s: float, rng: np.random.Generator) -> np.ndarray:
    """Flash crowds: bursts of `burst_size` requests `intra_s` apart,
    separated by idle gaps of ~`gap_s` (±25% jitter)."""
    if n <= 0:
        return np.zeros(0)
    out: List[float] = []
    t = 0.0
    while len(out) < n:
        for i in range(burst_size):
            if len(out) >= n:
                break
            out.append(t + i * intra_s)
        t = out[-1] + gap_s * (1.0 + rng.uniform(-0.25, 0.25))
    return np.asarray(out[:n])


# ---------------------------------------------------------------------------
# Workload construction
# ---------------------------------------------------------------------------

def make_workload(pattern: str, n: int, seed: int = 0, *,
                  rate_rps: float = 40.0,
                  burst_size: int = 6, burst_gap_s: float = 0.5,
                  short_prompt: int = 16, long_prompt: int = 64,
                  long_frac: float = 0.3,
                  mean_decode: int = 12, n_topics: int = 4
                  ) -> List[RequestSpec]:
    """Generate `n` request shapes for one of `WORKLOAD_PATTERNS`."""
    if pattern not in WORKLOAD_PATTERNS:
        raise ValueError(f"unknown workload pattern {pattern!r}; "
                         f"expected one of {WORKLOAD_PATTERNS}")
    rng = np.random.default_rng(seed)
    if pattern == "poisson":
        arrivals = poisson_arrivals(n, rate_rps, rng)
    elif pattern == "bursty":
        arrivals = bursty_arrivals(n, burst_size, burst_gap_s,
                                   intra_s=1e-3, rng=rng)
    else:  # mixed: moderate poisson, bimodal prompt lengths
        arrivals = poisson_arrivals(n, rate_rps * 0.5, rng)

    out: List[RequestSpec] = []
    for i, t in enumerate(arrivals):
        if pattern == "mixed":
            plen = long_prompt if rng.random() < long_frac else short_prompt
        else:
            plen = int(round(short_prompt *
                             (1.0 + rng.uniform(-0.25, 0.25))))
        dlen = max(2, int(rng.geometric(1.0 / mean_decode)))
        out.append(RequestSpec(arrival_s=float(t), prompt_len=max(2, plen),
                               decode_len=dlen,
                               topic=int(rng.integers(n_topics)),
                               request_id=i))
    return out


def prompt_tokens(spec: RequestSpec, vocab_size: int,
                  rng: np.random.Generator, n_topics: int = 4) -> np.ndarray:
    """Topic-blocked Zipf token ids for a request (feeds the real engine)."""
    block = max(2, vocab_size // n_topics)
    ranks = np.arange(1, block + 1, dtype=np.float64)
    p = 1.0 / ranks ** 1.2
    p /= p.sum()
    base = rng.choice(block, p=p, size=spec.prompt_len)
    return ((spec.topic % n_topics) * block + base).astype(np.int32) \
        % vocab_size


# ---------------------------------------------------------------------------
# Synthetic per-request routing traces (CPU-fast serving benchmarks)
# ---------------------------------------------------------------------------

def synthetic_routers(L: int, M: int, d: int,
                      seed: int = 0) -> List[np.ndarray]:
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((d, M)).astype(np.float32) * 0.3
            for _ in range(L)]


def synthetic_request_trace(spec: RequestSpec, L: int, M: int, top_k: int,
                            routers: Sequence[np.ndarray],
                            tokens_per_step: int = 2, seed: int = 0,
                            topic_scale: float = 6.0, drift: float = 0.3,
                            layer_drift: float = 0.1,
                            token_noise: float = 0.2) -> List[StepTrace]:
    """Routing for one request: step 0 drives prefill, steps 1.. decode.

    Assignments are generated *through the routers* from a slowly drifting,
    topic-anchored hidden state, so the trace has the three structural
    properties real traces show: temporal locality (the AR(1) hidden state
    drifts, it does not jump), tenant clustering (requests sharing a topic
    anchor activate overlapping experts; different topics mostly disjoint
    ones), and pre-gate predictive power (a future layer's router applied to
    the current hidden state approximates that layer's actual routing).
    """
    rng = np.random.default_rng(seed * 100003 + spec.request_id)
    d = routers[0].shape[0]
    topic_rng = np.random.default_rng(7919 * (spec.topic + 1))
    anchor = topic_rng.standard_normal(d)
    anchor *= topic_scale / max(np.linalg.norm(anchor), 1e-9)

    h = anchor + 0.3 * rng.standard_normal(d)
    T = tokens_per_step
    steps: List[StepTrace] = []
    for si in range(max(1, spec.decode_len)):
        h = (1 - drift) * h + drift * (anchor + rng.standard_normal(d))
        assigns: List[np.ndarray] = []
        pooled = np.empty((L, d), np.float32)
        emb: Optional[np.ndarray] = None
        for l in range(L):
            g = h + layer_drift * rng.standard_normal(d)
            toks = g[None, :] + token_noise * rng.standard_normal((T, d))
            logits = toks.astype(np.float32) @ routers[l]
            ids = np.argsort(-logits, axis=-1)[:, :top_k]
            assigns.append(ids.astype(np.int64))
            pooled[l] = g
            if si == 0 and l == 0:
                emb = toks.astype(np.float32)
        steps.append(StepTrace(si, rng.integers(0, 64, 8), assigns,
                               pooled, emb))
    return steps
