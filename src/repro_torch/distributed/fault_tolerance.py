"""Straggler mitigation for serving: the reference's `StragglerPolicy`.

Only the policy is carried here; the reference module's checkpoint/restart
runner belongs to training and is not part of the port yet.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np


@dataclass
class ReplicaHealth:
    ewma_s: float = 0.0
    baseline_s: float = 0.0   # slow healthy-latency reference (1-replica mode)
    n: int = 0
    draining: bool = False


class StragglerPolicy:
    """Pod-replica straggler detection for the serving fleet.

    With multiple replicas the reference is the fleet median (a replica
    slower than its peers drains). A SINGLE replica has no fleet to
    compare against — its reference is a second, much slower EWMA of its
    own healthy latency (`baseline_alpha`), frozen while draining so a
    sustained brownout cannot normalize itself into the baseline. The
    same drain signal then doubles as the serving brownout: the batcher
    pauses admissions while its (only) replica drains."""

    def __init__(self, n_replicas: int, threshold: float = 2.0,
                 alpha: float = 0.2, recovery: float = 1.2,
                 baseline_alpha: float = 0.05, warmup: int = 1):
        self.replicas = [ReplicaHealth() for _ in range(n_replicas)]
        self.threshold = threshold
        self.recovery = recovery
        self.alpha = alpha
        self.baseline_alpha = baseline_alpha
        # samples ignored for the baseline and drain decisions (the first
        # serving decode iteration pays one-off set-up costs and would
        # poison a wall-clock baseline)
        self.warmup = warmup

    def record(self, replica: int, latency_s: float) -> None:
        r = self.replicas[replica]
        r.ewma_s = latency_s if r.n == 0 else \
            (1 - self.alpha) * r.ewma_s + self.alpha * latency_s
        r.n += 1
        if r.n <= self.warmup:
            return
        ref = self._reference(r)
        if ref > 0:
            if r.ewma_s > self.threshold * ref:
                r.draining = True
            elif r.draining and r.ewma_s < self.recovery * ref:
                r.draining = False
        if not r.draining:
            r.baseline_s = latency_s if r.baseline_s == 0.0 else \
                (1 - self.baseline_alpha) * r.baseline_s \
                + self.baseline_alpha * latency_s

    def _reference(self, r: ReplicaHealth) -> float:
        if len(self.replicas) > 1:
            return self.median()
        return r.baseline_s

    def draining(self, replica: int = 0) -> bool:
        return self.replicas[replica].draining

    def median(self) -> float:
        vals = [r.ewma_s for r in self.replicas if r.n > 0]
        return float(np.median(vals)) if vals else 0.0

    def healthy_replicas(self) -> List[int]:
        return [i for i, r in enumerate(self.replicas) if not r.draining]

    def pick(self, step: int) -> int:
        """Round-robin over healthy replicas."""
        healthy = self.healthy_replicas() or list(range(len(self.replicas)))
        return healthy[step % len(healthy)]
