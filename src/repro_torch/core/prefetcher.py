"""Transfer link model + prefetch queue (paper §3.3.2, §3.4).

The host->device link is a serialized resource. Transfers carry a priority:
cache-miss resolution preempts *queued* (not in-flight) prefetches — the
paper's "highest priority in the memory queue". Observed transfer times feed
the bandwidth estimate C_s back to the step-size controller.

In the baseline configuration (`blocking_swap_out=True`) evictions occupy
the link too (write-back), modelling the swap-in/swap-out contention the
paper attributes to conventional MoE systems; ExpertFlow discards read-only
expert weights without write-back.
"""
from __future__ import annotations

import heapq
import itertools
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

Key = Tuple[int, int]

PRIO_MISS = 0        # on-demand miss: head of queue
PRIO_PREFETCH = 1
PRIO_WRITEBACK = 2


@dataclass
class Transfer:
    key: Optional[Key]
    nbytes: float
    priority: int
    issue_t: float
    start_t: float = -1.0
    done_t: float = -1.0
    kind: str = "prefetch"     # prefetch | miss | writeback
    failed: bool = False       # declared lost: must never settle as a hit


class TransferLink:
    """Non-preemptive priority-queued serial link."""

    def __init__(self, bandwidth: float):
        self.bandwidth = bandwidth
        self._counter = itertools.count()
        self._queue: List[Tuple[int, int, Transfer]] = []  # (prio, seq, tr)
        self._busy_until = 0.0
        self.in_flight: Dict[Key, Transfer] = {}
        self.completed: List[Transfer] = []
        self.failed: List[Transfer] = []
        self.n_failed = 0
        self.bytes_moved = 0.0
        # optional fault hooks (core.faults.FaultInjector.attach_link):
        # bandwidth_hook(tr, start) -> multiplier, latency_hook(tr, start)
        # -> extra seconds. None (the default) keeps transfer timing
        # byte-identical to a hook-free link.
        self.bandwidth_hook = None
        self.latency_hook = None

    def _duration(self, tr: Transfer, start: float) -> float:
        bw = self.bandwidth
        if self.bandwidth_hook is not None:
            bw *= max(float(self.bandwidth_hook(tr, start)), 1e-9)
        dur = tr.nbytes / bw
        if self.latency_hook is not None:
            dur += max(float(self.latency_hook(tr, start)), 0.0)
        return dur

    def submit(self, tr: Transfer) -> Transfer:
        heapq.heappush(self._queue, (tr.priority, next(self._counter), tr))
        if tr.key is not None:
            self.in_flight[tr.key] = tr
        return tr

    def promote(self, key: Key) -> None:
        """Raise a queued transfer for `key` to miss priority (§3.4)."""
        for i, (prio, seq, tr) in enumerate(self._queue):
            if tr.key == key and prio > PRIO_MISS:
                tr.priority = PRIO_MISS
                tr.kind = "miss"
                self._queue[i] = (PRIO_MISS, seq, tr)
                heapq.heapify(self._queue)
                return

    def drain_until(self, t: float) -> List[Transfer]:
        """Run the link forward to time `t`; return transfers completed."""
        done = []
        while self._queue:
            prio, seq, tr = self._queue[0]
            start = max(self._busy_until, tr.issue_t)
            if start >= t:
                break
            heapq.heappop(self._queue)
            tr.start_t = start
            tr.done_t = start + self._duration(tr, start)
            self._busy_until = tr.done_t
            self.bytes_moved += tr.nbytes
            self.completed.append(tr)
            if tr.key is not None:
                self.in_flight.pop(tr.key, None)
            done.append(tr)
        return done

    def finish(self, key: Key, now: float) -> float:
        """Run the link until `key`'s transfer completes; returns its
        completion time. Queued items ahead of it (by priority) run first."""
        if self._find(key) is None:
            for c in reversed(self.completed):
                if c.key == key:
                    return max(c.done_t, 0.0)
            raise KeyError(f"transfer for {key} not found")
        while self._queue:
            prio, seq, tr = heapq.heappop(self._queue)
            tr.start_t = max(self._busy_until, tr.issue_t)
            tr.done_t = tr.start_t + self._duration(tr, tr.start_t)
            self._busy_until = tr.done_t
            self.bytes_moved += tr.nbytes
            self.completed.append(tr)
            if tr.key is not None:
                self.in_flight.pop(tr.key, None)
            if tr.key == key:
                return tr.done_t
        raise KeyError(f"transfer for {key} vanished from queue")

    def cancel(self, key: Key) -> bool:
        """Drop any queued transfer for `key` (an evicted expert's pending
        fetch is moot). Returns True if something was removed."""
        kept = [item for item in self._queue if item[2].key != key]
        if len(kept) == len(self._queue):
            return False
        self._queue = kept
        heapq.heapify(self._queue)
        self.in_flight.pop(key, None)
        return True

    def fail(self, key: Key) -> bool:
        """A queued transfer for `key` failed: remove it from the queue and
        `in_flight` and record it under `failed`. Unlike a completion it
        never advances `busy_until`, never counts toward `bytes_moved`,
        and never appears in `completed` — the link accounting invariants
        (bytes_moved == sum of completed sizes) survive any failure
        interleaving. Returns True if a transfer was failed."""
        dropped = None
        kept = []
        for item in self._queue:
            if dropped is None and item[2].key == key:
                dropped = item[2]
            else:
                kept.append(item)
        if dropped is None:
            return False
        dropped.failed = True
        self.failed.append(dropped)
        self.n_failed += 1
        self._queue = kept
        heapq.heapify(self._queue)
        self.in_flight.pop(key, None)
        return True

    def _find(self, key: Key) -> Optional[Transfer]:
        for _, _, tr in self._queue:
            if tr.key == key:
                return tr
        return None

    def pending(self, key: Key) -> bool:
        return self._find(key) is not None

    @property
    def busy_until(self) -> float:
        return self._busy_until


class Prefetcher:
    """Issues expert transfers and tracks readiness + observed bandwidth."""

    def __init__(self, link: TransferLink, expert_bytes: float,
                 blocking_swap_out: bool = False,
                 cancel_on_forget: bool = False):
        self.link = link
        self.expert_bytes = expert_bytes
        self.blocking_swap_out = blocking_swap_out
        # True (the slot-path runtime): eviction cancels the key's pending
        # transfer outright — stale completions must never repopulate
        # ready_at, or the late-transfer stall signal corrupts. False (the
        # simulator's historical semantics): an in-flight prefetch of an
        # evicted expert still occupies the modeled link and re-lands via
        # advance(), preserving the committed figure baselines.
        self.cancel_on_forget = cancel_on_forget
        # optional core.faults.FaultInjector: transfer outcomes are drawn at
        # modeled completion time (the simulator mirror). The live engine
        # leaves this None and decides failures before issuing instead.
        self.injector = None
        self.ready_at: Dict[Key, float] = {}
        self.issued: Dict[Key, Transfer] = {}
        self.n_prefetches = 0
        self.n_misses = 0
        self.n_late_prefetches = 0       # prefetched, but demanded before done
        self.n_unused_prefetches = 0     # prefetched, evicted without a demand
        self.n_failed = 0                # transfers declared lost
        self.n_retries = 0               # demand resubmissions after failure
        self._demanded: set = set()      # keys that saw a demand() call
        self._completed_seen = 0          # monotone index into link.completed
        self._pending: List[Transfer] = []  # completed but not yet surfaced

    def prefetch(self, key: Key, now: float) -> None:
        if key in self.issued or key in self.ready_at:
            return
        tr = Transfer(key, self.expert_bytes, PRIO_PREFETCH, now)
        self.link.submit(tr)
        self.issued[key] = tr
        self.n_prefetches += 1

    def prefetch_many(self, keys, now: float) -> None:
        """Issue a speculative window of transfers in submission order.

        Callers pass the multi-layer horizon's fills nearest-layer-first;
        the link is FIFO within the prefetch priority class, so the expert
        needed soonest also lands soonest (§3.4 queue discipline)."""
        for key in keys:
            self.prefetch(key, now)

    def demand(self, key: Key, now: float, max_retries: int = 0,
               backoff_s: float = 0.0) -> Optional[float]:
        """Miss path: fetch `key` at top priority; returns ready time.

        With a fault `injector` attached, each attempt's outcome is drawn
        at its modeled completion time; a failed attempt is scrubbed (it
        occupied the link but delivers nothing) and resubmitted at miss
        priority after exponential backoff, up to `max_retries` times.
        Returns None when every attempt failed — the caller must treat the
        expert as non-resident rather than wait forever."""
        self._demanded.add(key)
        if key in self.ready_at:
            return self.ready_at[key]
        if key in self.issued:
            self.n_late_prefetches += 1
            self.link.promote(key)
        else:
            self._submit_demand(key, now)
        attempt = 0
        while True:
            t_done = self.link.finish(key, now)
            if self.injector is None \
                    or not self.injector.transfer_fails(key, t_done):
                self._complete(key, t_done)
                return t_done
            self.n_failed += 1
            self._scrub_failed(key)
            if attempt >= max_retries:
                return None
            attempt += 1
            self.n_retries += 1
            now = t_done + backoff_s * (2.0 ** (attempt - 1))
            self._submit_demand(key, now, retry=True)

    def _submit_demand(self, key: Key, now: float,
                       retry: bool = False) -> None:
        tr = Transfer(key, self.expert_bytes, PRIO_MISS, now, kind="miss")
        self.link.submit(tr)
        self.issued[key] = tr
        if not retry:
            self.n_misses += 1

    def _scrub_failed(self, key: Key) -> None:
        """A demand attempt for `key` completed-but-failed: mark the exact
        transfer so advance() can never surface it into ready_at, and drop
        the issued entry so a later demand is a fresh submission."""
        tr = self.issued.pop(key, None)
        if tr is not None:
            tr.failed = True
            self._pending = [p for p in self._pending if p is not tr]

    def fail(self, key: Key) -> bool:
        """Declare `key`'s in-flight transfer failed (external fault): the
        queued copy is scrubbed from the link, the issued/pending
        bookkeeping is dropped, and a later demand() for the key is a
        fresh miss. A transfer that already *delivered* (`ready_at`) is
        not rescinded. Returns True if a live transfer was failed."""
        tr = self.issued.pop(key, None)
        dropped = self.link.fail(key)
        if tr is not None:
            tr.failed = True
            self._pending = [p for p in self._pending if p is not tr]
        if tr is None and not dropped:
            return False
        self.n_failed += 1
        return True

    def writeback(self, now: float) -> None:
        """Baseline swap-out contention: eviction occupies the link."""
        if self.blocking_swap_out:
            self.link.submit(Transfer(None, self.expert_bytes, PRIO_WRITEBACK,
                                      now, kind="writeback"))

    def advance(self, t: float) -> List[Key]:
        """Advance link time; returns expert keys that became resident by t
        (including ones completed while fast-forwarding a miss)."""
        self.link.drain_until(t)
        new = self.link.completed[self._completed_seen:]
        self._completed_seen = len(self.link.completed)
        self._pending.extend(tr for tr in new if tr.key is not None)
        arrived = []
        still = []
        for tr in self._pending:
            if tr.done_t <= t:
                # a failed transfer's completion must never settle as a
                # prefetch hit — drop it silently
                if tr.failed:
                    continue
                # under cancel_on_forget, surface only the EXACT transfer
                # currently expected for the key (identity, not membership):
                # a stale completion of a forgotten-then-reissued key must
                # neither repopulate ready_at early nor orphan the live
                # transfer's issued entry
                if self.cancel_on_forget and self.issued.get(tr.key) is not tr:
                    continue
                if tr.key in self.ready_at:
                    continue
                if self.injector is not None \
                        and self.injector.transfer_fails(tr.key, tr.done_t):
                    # the prefetch completed but its payload is lost: a
                    # later demand for the key must be a fresh miss
                    tr.failed = True
                    self.n_failed += 1
                    if self.issued.get(tr.key) is tr:
                        del self.issued[tr.key]
                    continue
                self._complete(tr.key, tr.done_t)
                arrived.append(tr.key)
            else:
                still.append(tr)
        self._pending = still
        return arrived

    def _complete(self, key: Key, t_done: float) -> None:
        self.ready_at[key] = t_done
        self.issued.pop(key, None)

    def is_ready(self, key: Key, now: float) -> bool:
        return key in self.ready_at and self.ready_at[key] <= now

    def note_use(self, key: Key) -> None:
        """Record that a prefetched expert was actually consumed (cache hit
        — no demand() ever fires for it), so a later eviction does not
        misclassify it as an unused prefetch."""
        self._demanded.add(key)

    def forget(self, key: Key, count_unused: bool = True) -> None:
        """Expert evicted — future use must re-fetch. An eviction of a
        prefetched key that never saw a demand (whether the transfer
        completed or is still queued/in flight) counts as an unused
        prefetch (the controller's overfetch signal, §3.2.2) —
        `count_unused=False` defers that call to the caller (`note_unused`)
        when used-vs-unused is not yet decidable at eviction time.

        With `cancel_on_forget` the issued entry, any still-queued
        transfer, AND any drained-but-unsurfaced completion are dropped
        too: a later demand for the re-evicted key must be a fresh miss,
        and a stale completion must never repopulate ready_at for a
        non-resident expert. The integrity layer (`core.integrity`) leans
        on exactly this to discard a delivered-but-corrupt promotion so
        its bounded re-fetch is a genuinely fresh read."""
        if count_unused and (key in self.ready_at or key in self.issued) \
                and key not in self._demanded:
            self.n_unused_prefetches += 1
        self.ready_at.pop(key, None)
        if self.cancel_on_forget:
            self.issued.pop(key, None)
            self.link.cancel(key)
            self._pending = [tr for tr in self._pending if tr.key != key]
        self._demanded.discard(key)

    def note_unused(self, key: Key) -> None:
        """Deferred verdict for a key forgotten with count_unused=False:
        it was settled as never-used after all."""
        self.n_unused_prefetches += 1
