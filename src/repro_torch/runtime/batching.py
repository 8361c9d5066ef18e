"""Continuous batching scheduler (paper §4.1: "continuous batching enabled").

Requests arrive over (simulated) time, are prefillled on admission, join the
decode batch in a free slot, and leave at completion — freeing the slot for
the next waiting request. The scheduler is engine-agnostic: it operates on a
`step_fn(batch_tokens) -> next_tokens` plus admission callbacks, so both the
real engine and the latency simulator reuse it.

Admission is working-set aware (the ROADMAP adaptive-S item): with a
`WorkingSetAdmission` policy, `admit` consults the SHARED
`StepSizeController` — the same instance the engine/simulator feeds with
stall/overfetch/bandwidth signals — and each waiting request's predicted
per-layer expert working set, and stops admitting once the co-batched
working set would outgrow what the cache can hold plus what the link can
stream within the current lookahead S. A transiently-exceeded cap cannot
starve anyone: the queue head is always admitted into an empty batch, and
head-of-line blocking means retirements eventually drain to that state.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence

from repro_torch.core.step_size import StepSizeController
from repro_torch.runtime.request import Request


@dataclass
class WorkingSetAdmission:
    """Expert working-set admission cap over one shared expert cache.

    `budget()` = cache slots per MoE layer + experts the host->device link
    can stream within the controller's current lookahead window (S layers of
    compute at the controller's bandwidth/layer-time estimates) — i.e. the
    residency the runtime can actually sustain per layer. A request's cost
    is its `predicted_ws` (predicted distinct experts per layer) when the
    submitter estimated one, else `default_ws` (top_k: the floor any decode
    row demands).
    """
    controller: StepSizeController
    slots_per_layer: int
    expert_bytes: float = 0.0      # 0 disables the streamable term
    default_ws: float = 2.0
    headroom: float = 1.0          # scales the budget (tests / tuning knob)

    def working_set(self, req: Request) -> float:
        if req.predicted_ws is not None:
            return float(req.predicted_ws)
        return float(self.default_ws)

    def budget(self) -> float:
        snap = self.controller.snapshot()
        streamable = 0.0
        if self.expert_bytes > 0:
            streamable = (snap["bandwidth_est"] * snap["layer_time_est"]
                          * max(snap["s"], 1)) / self.expert_bytes
        return self.headroom * (self.slots_per_layer + streamable)

    def admits(self, req: Request, active: Sequence[Request]) -> bool:
        if not active:
            return True            # no-starvation guarantee
        total = sum(self.working_set(r) for r in active)
        return total + self.working_set(req) <= self.budget()


@dataclass
class BatcherStats:
    admitted: int = 0
    completed: int = 0
    decode_iterations: int = 0
    occupancy_sum: float = 0.0
    admission_deferred: int = 0    # admit() passes blocked by the cap
    shed: int = 0                  # requests dropped past their deadline
    brownout_deferred: int = 0     # admit() passes paused while degraded

    @property
    def mean_occupancy(self) -> float:
        return self.occupancy_sum / max(self.decode_iterations, 1)


class ContinuousBatcher:
    """Slot-based continuous batching over a fixed max batch size."""

    def __init__(self, max_batch: int,
                 admission: Optional[WorkingSetAdmission] = None,
                 brownout: Optional[Callable[[], bool]] = None):
        self.max_batch = max_batch
        self.admission = admission
        # brownout() -> True pauses admissions while the engine is degraded
        # (straggler drain / fault-degraded routing / tripped watchdog).
        # The queue head still admits into an EMPTY batch, preserving the
        # no-starvation guarantee: even a permanently-degraded engine keeps
        # serving, one working set at a time.
        self.brownout = brownout
        self.waiting: List[Request] = []
        self.active: Dict[int, Request] = {}   # slot -> request
        self.free_slots = list(range(max_batch))
        self.shed: List[Request] = []          # dropped past their deadline
        self.stats = BatcherStats()

    def submit(self, req: Request) -> None:
        self.waiting.append(req)

    def admit(self, on_admit: Optional[Callable[[Request, int], None]] = None,
              now: Optional[float] = None) -> List[Request]:
        """Move waiting requests into free slots (prefill happens here).
        With `now`, only requests that have arrived (`arrival_s <= now`)
        are admitted — the serving simulator's open-loop admission gate.
        With an admission policy, stop (head-of-line, preserving FIFO
        order) once the co-batched expert working set would exceed the
        shared cache's sustainable budget."""
        admitted = []
        while self.waiting and self.free_slots:
            head = self.waiting[0]
            if now is not None and head.arrival_s > now:
                break
            # load shedding: a queued request past its deadline can no
            # longer meet its SLO — drop it (even mid-brownout, so expired
            # work drains instead of pinning the queue) and keep admitting
            if now is not None and head.deadline_s is not None \
                    and now - head.arrival_s > head.deadline_s:
                self.waiting.pop(0)
                head.slot = -1
                self.shed.append(head)
                self.stats.shed += 1
                continue
            if self.brownout is not None and self.active and self.brownout():
                self.stats.brownout_deferred += 1
                break
            if self.admission is not None and not self.admission.admits(
                    head, list(self.active.values())):
                self.stats.admission_deferred += 1
                break
            req = self.waiting.pop(0)
            slot = self.free_slots.pop(0)
            req.slot = slot
            self.active[slot] = req
            if on_admit:
                on_admit(req, slot)
            self.stats.admitted += 1
            admitted.append(req)
        return admitted

    def _free(self, slot: int, req: Request) -> None:
        """The ONE retirement path (shared by `release` and `step`): drop
        the slot->request binding, return the slot to the pool, and CLEAR
        `req.slot` — a retired request holding its old slot id would alias
        whichever request reuses that slot in later slot-keyed lookups
        (e.g. logits traces)."""
        del self.active[slot]
        req.slot = -1
        self.free_slots.append(slot)
        self.free_slots.sort()
        self.stats.completed += 1

    def release(self, req: Request) -> None:
        """Free a request's slot outside the `step()` path (e.g. a request
        whose full output was produced at prefill)."""
        if req.slot in self.active and self.active[req.slot] is req:
            self._free(req.slot, req)

    def step(self, next_tokens: Dict[int, int]) -> List[Request]:
        """Record one decode iteration's sampled tokens; returns finished."""
        finished = []
        self.stats.decode_iterations += 1
        self.stats.occupancy_sum += len(self.active) / self.max_batch
        for slot, tok in next_tokens.items():
            req = self.active.get(slot)
            # mirror release()'s identity guard: a caller passing a stale
            # slot id (e.g. after a retire-then-readmit race) must not feed
            # tokens to — or retire — the slot's NEW occupant
            if req is None or req.slot != slot:
                continue
            req.output.append(int(tok))
            if req.done:
                finished.append(req)
                self._free(slot, req)
        return finished

    @property
    def has_work(self) -> bool:
        return bool(self.waiting or self.active)

    def active_slots(self) -> List[int]:
        return sorted(self.active)
