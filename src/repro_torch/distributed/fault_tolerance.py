"""Fault tolerance: checkpoint/restart of the train loop and straggler
mitigation for serving.

- `TrainRunner` wraps the step loop with periodic asynchronous checkpoints
  and restart from the latest one: on a failure (an exception in a step,
  or the failure detector's signal) it reloads the last durable state and
  goes on, up to `max_retries` times in a row.
- `StragglerPolicy`: per-replica latency EWMAs; a replica whose EWMA
  exceeds `threshold` x the reference latency is drained (no new
  admissions) until it recovers.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from repro_torch.checkpoint.checkpointer import Checkpointer


@dataclass
class TrainRunner:
    step_fn: Callable                      # (state, batch) -> (state, metrics)
    checkpointer: Checkpointer
    state: Any
    step: int = 0
    failure_detector: Optional[Callable[[], bool]] = None
    on_restore: Optional[Callable[[Any], Any]] = None
    max_retries: int = 3

    def restore_if_available(self, like: Any) -> bool:
        """Load the latest checkpoint into `like`'s structure, if any."""
        restored, step = self.checkpointer.restore_latest(like)
        if restored is None:
            return False
        self.state = restored if self.on_restore is None \
            else self.on_restore(restored)
        self.step = step
        return True

    def run(self, batches, num_steps: int,
            metrics_cb: Optional[Callable[[int, Dict], None]] = None) -> Any:
        """Steps until `num_steps`, saving through the checkpointer after
        each; returns the final state once every write has landed."""
        retries = 0
        it = iter(batches)
        while self.step < num_steps:
            batch = next(it)
            try:
                if self.failure_detector and self.failure_detector():
                    raise RuntimeError("failure detected by monitor")
                self.state, metrics = self.step_fn(self.state, batch)
                self.step += 1
                retries = 0
                if metrics_cb:
                    metrics_cb(self.step, metrics)
                self.checkpointer.maybe_save(self.step, self.state)
            except Exception:
                retries += 1
                if retries > self.max_retries:
                    raise
                # restart path: reload the last durable state and go on
                self.checkpointer.wait()
                restored, step = self.checkpointer.restore_latest(self.state)
                if restored is not None:
                    self.state = restored if self.on_restore is None \
                        else self.on_restore(restored)
                    self.step = step
        self.checkpointer.wait()
        return self.state


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
