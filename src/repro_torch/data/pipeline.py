"""Synthetic workload + training data pipelines (numpy; the reference's
streams, bitwise, for the same seed).

`sharegpt_like` mimics the paper's workload construction (§4.1): requests
bucketed by prompt length (±5% jitter within a group, up to `per_group`
samples per group), with token content drawn from topic-clustered Zipf
distributions — topic mixing controls the intra-batch semantic diversity
Dist(t) that Observation III ties to expert demand.

`token_batches` is the training-side pipeline: an infinite deterministic
stream of (tokens, labels) batches for the train-step loop.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np


@dataclass
class WorkloadRequest:
    tokens: np.ndarray
    topic: int
    group_len: int


def _zipf_probs(n: int, a: float = 1.2) -> np.ndarray:
    p = 1.0 / np.arange(1, n + 1) ** a
    return p / p.sum()


def sharegpt_like(seed: int = 0, vocab_size: int = 512, n_topics: int = 8,
                  length_groups: Sequence[int] = (8, 16, 32, 64, 128, 256,
                                                  512, 1024),
                  per_group: int = 50, jitter: float = 0.05,
                  topic_mix: float = 0.0) -> List[WorkloadRequest]:
    """topic_mix=0: each request draws from one topic's vocab block
    (low Dist(t)); topic_mix=1: tokens drawn uniformly across topics
    (high Dist(t))."""
    rng = np.random.default_rng(seed)
    block = vocab_size // n_topics
    zipf = _zipf_probs(block)
    out: List[WorkloadRequest] = []
    for g in length_groups:
        for _ in range(per_group):
            L = max(2, int(round(g * (1 + rng.uniform(-jitter, jitter)))))
            topic = int(rng.integers(n_topics))
            toks = np.empty(L, np.int64)
            for i in range(L):
                t = topic if rng.random() > topic_mix else int(
                    rng.integers(n_topics))
                toks[i] = t * block + rng.choice(block, p=zipf)
            out.append(WorkloadRequest(toks.astype(np.int32), topic, g))
    return out


def batch_requests(reqs: List[WorkloadRequest], batch: int,
                   pad_id: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Right-pad a request group to a (B, T) batch + length vector."""
    sel = reqs[:batch]
    T = max(r.tokens.shape[0] for r in sel)
    toks = np.full((len(sel), T), pad_id, np.int32)
    lens = np.zeros(len(sel), np.int32)
    for i, r in enumerate(sel):
        toks[i, :len(r.tokens)] = r.tokens
        lens[i] = len(r.tokens)
    return toks, lens


def token_batches(vocab_size: int, batch: int, seq_len: int,
                  seed: int = 0) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Deterministic synthetic LM training stream: (tokens, labels)."""
    rng = np.random.default_rng(seed)
    n_topics = 16
    block = max(2, vocab_size // n_topics)
    zipf = _zipf_probs(block)
    while True:
        topic = rng.integers(n_topics, size=(batch, 1))
        base = rng.choice(block, p=zipf, size=(batch, seq_len + 1))
        toks = (topic * block + base).astype(np.int32) % vocab_size
        yield toks[:, :-1], toks[:, 1:]
