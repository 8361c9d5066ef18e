"""Deterministic fault injection for the expert-transfer subsystem.

The host->device link is the one resource the whole runtime assumes always
delivers: `ensure_resident` blocks on `TransferLink.finish`, the prefetcher
books completions as residency, and the step-size controller trusts the
observed bandwidth. A production fleet sees that link *misbehave* —
bandwidth collapse under PCIe contention (brownout), flaky DMA transfers,
multi-second stalls, predictor services going dark. This module injects
exactly those failures, deterministically, so graceful degradation is a
testable property instead of an incident report:

- `FaultPlan`: a frozen, JSON-serializable description of the scenario
  (failure probability, brownout windows, stalls/jitter, outage windows,
  predictor blackout). An all-default plan is *disabled* — engines built
  with one take the fault-free code path bit-exactly.
- `FaultInjector`: draws every fault decision from a seed keyed by
  `(seed, salt, key, attempt)` — independent of call order or wall time,
  so two backends (engine + simulator) replaying the same plan see the
  same per-transfer outcomes, and CI gates are deterministic.
- `StepWatchdog`: EWMA step-deadline monitor with hysteresis; the engine
  collapses its speculative horizon S->0 while tripped and re-expands
  once step wall-time recovers.

Nothing here touches the device: injection happens in the host-side
bookkeeping (link hooks, miss path, horizon choice). A failed transfer is
a decision drawn from the plan before any copy is issued, never a caught
CUDA error: a real launch or copy error still raises.

The port's own copy of the reference's module, draw for draw. The disk
and corrupt scopes are the tiered expert store's (`core.expert_tiers`,
through `disk_view`): its disk link's faults and the bytes its checks
see flipped.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass, field, asdict
from typing import Dict, Optional, Tuple

import numpy as np

# open-ended windows use a large finite sentinel (JSON has no inf)
FOREVER = 1e18

Window = Tuple[float, float]                 # [start, end) in link-clock units
BrownoutWindow = Tuple[float, float, float]  # [start, end) -> bandwidth factor


def _in_window(windows, t: float) -> bool:
    return any(a <= t < b for a, b in windows)


@dataclass(frozen=True)
class FaultPlan:
    """Seeded description of a link-misbehavior scenario.

    All times are in the owning backend's *link clock*: the engine's
    virtual transfer clock (one unit per MoE layer) or the simulator's
    modeled seconds. An all-default plan is disabled (`enabled` is False)
    and must cost nothing."""

    seed: int = 0
    # per-transfer failure probability (drawn per attempt, so retries can
    # succeed); 1.0 inside an `outage` window regardless
    fail_prob: float = 0.0
    # per-transfer stall: with prob `stall_prob` add `stall_s` to latency
    stall_prob: float = 0.0
    stall_s: float = 0.0
    # multiplicative bandwidth jitter: uniform in [1-jitter, 1] per transfer
    jitter: float = 0.0
    # global bandwidth derate (1.0 = healthy link)
    bandwidth_factor: float = 1.0
    # timed brownouts: ((start, end, factor), ...) further derate bandwidth
    brownout: Tuple[BrownoutWindow, ...] = ()
    # total-outage windows: every transfer attempt inside fails
    outage: Tuple[Window, ...] = ()
    # predictor blackout: prefetch/speculation signals unavailable
    predictor_blackout: Tuple[Window, ...] = ()
    # ---- disk-link scope (the disk->host promotion queue of the tiered
    # expert store, core.expert_tiers). Same semantics as the device-link
    # fields above, drawn with independent salts so chaos scenarios
    # compose: a plan can brown out the PCIe link AND kill the disk.
    disk_fail_prob: float = 0.0
    disk_stall_prob: float = 0.0
    disk_stall_s: float = 0.0
    disk_jitter: float = 0.0
    disk_bandwidth_factor: float = 1.0
    disk_outage: Tuple[Window, ...] = ()
    # ---- corrupt scope (the integrity layer, core.integrity). The link
    # delivers on time but the *bytes* lie. Three injection points:
    # on-media rot (a per-key property of the record — every re-read is
    # corrupt, so bounded re-fetch exhausts and the expert is permanently
    # quarantined), in-transit payload flips (per-attempt — a re-fetch
    # usually heals), and in-RAM rot of a host-resident copy (drawn per
    # scrubber visit).
    corrupt_disk_prob: float = 0.0
    corrupt_link_prob: float = 0.0
    corrupt_host_prob: float = 0.0

    @property
    def corrupt_enabled(self) -> bool:
        return (self.corrupt_disk_prob > 0.0 or self.corrupt_link_prob > 0.0
                or self.corrupt_host_prob > 0.0)

    @property
    def disk_enabled(self) -> bool:
        return (self.disk_fail_prob > 0.0 or self.disk_stall_prob > 0.0
                or self.disk_jitter > 0.0
                or self.disk_bandwidth_factor != 1.0
                or bool(self.disk_outage) or self.corrupt_enabled)

    @property
    def enabled(self) -> bool:
        return (self.fail_prob > 0.0 or self.stall_prob > 0.0
                or self.jitter > 0.0 or self.bandwidth_factor != 1.0
                or bool(self.brownout) or bool(self.outage)
                or bool(self.predictor_blackout) or self.disk_enabled)

    # ------------------------------------------------------------ presets
    @classmethod
    def none(cls) -> "FaultPlan":
        return cls()

    @classmethod
    def flaky(cls, seed: int = 0, fail_prob: float = 0.3) -> "FaultPlan":
        """Transfers randomly fail; retries usually recover."""
        return cls(seed=seed, fail_prob=fail_prob)

    @classmethod
    def brownout_preset(cls, seed: int = 0) -> "FaultPlan":
        """Sustained bandwidth collapse with flaky transfers on top — the
        CI smoke scenario: retries fire AND degraded routing engages."""
        return cls(seed=seed, fail_prob=0.55, bandwidth_factor=0.05,
                   jitter=0.3)

    @classmethod
    def stall(cls, seed: int = 0, stall_prob: float = 0.3,
              stall_s: float = 5.0) -> "FaultPlan":
        """Transfers intermittently hang for `stall_s` link-clock units."""
        return cls(seed=seed, stall_prob=stall_prob, stall_s=stall_s,
                   jitter=0.1)

    @classmethod
    def total_outage(cls, start: float = 0.0,
                     end: float = FOREVER) -> "FaultPlan":
        """The link is dead in [start, end): every attempt fails."""
        return cls(outage=((start, end),))

    @classmethod
    def disk_flaky(cls, seed: int = 0,
                   disk_fail_prob: float = 0.3) -> "FaultPlan":
        """Disk->host promotions randomly fail; retries usually recover."""
        return cls(seed=seed, disk_fail_prob=disk_fail_prob)

    @classmethod
    def disk_dead(cls, start: float = 0.0,
                  end: float = FOREVER) -> "FaultPlan":
        """The disk link is dead in [start, end): every promotion attempt
        fails — serving must degrade (drop tokens), never deadlock."""
        return cls(disk_outage=((start, end),))

    @classmethod
    def corrupt_disk(cls, seed: int = 0,
                     corrupt_disk_prob: float = 0.25) -> "FaultPlan":
        """A fraction of on-disk expert records are rotten: every re-fetch
        re-reads the same bad bytes, so verification exhausts its bounded
        retries and the expert is permanently quarantined (degraded
        resident-only routing) — serving completes, never deadlocks."""
        return cls(seed=seed, corrupt_disk_prob=corrupt_disk_prob)

    @classmethod
    def corrupt_flaky(cls, seed: int = 0,
                      corrupt_link_prob: float = 0.3,
                      corrupt_host_prob: float = 0.1) -> "FaultPlan":
        """Transient corruption: promotion payloads flip in transit and
        host-resident copies rot in RAM — both heal on re-fetch, so the
        integrity layer detects, requarantines, and keeps serving with
        zero corrupt bytes reaching an FFN dispatch."""
        return cls(seed=seed, corrupt_link_prob=corrupt_link_prob,
                   corrupt_host_prob=corrupt_host_prob)

    PRESETS = ("none", "flaky", "brownout", "stall", "outage",
               "disk_flaky", "disk_dead", "corrupt_disk", "corrupt_flaky")

    @classmethod
    def from_arg(cls, s: Optional[str]) -> Optional["FaultPlan"]:
        """Parse a CLI argument: a preset name, inline JSON (`{...}`), or a
        path to a JSON file of FaultPlan fields. Returns None for None/''."""
        if not s:
            return None
        if s == "none":
            return cls()
        if s == "flaky":
            return cls.flaky()
        if s == "brownout":
            return cls.brownout_preset()
        if s == "stall":
            return cls.stall()
        if s == "outage":
            return cls.total_outage()
        if s == "disk_flaky":
            return cls.disk_flaky()
        if s == "disk_dead":
            return cls.disk_dead()
        if s == "corrupt_disk":
            return cls.corrupt_disk()
        if s == "corrupt_flaky":
            return cls.corrupt_flaky()
        if s.lstrip().startswith("{"):
            return cls.from_json(s)
        if os.path.exists(s):
            with open(s) as f:
                return cls.from_json(f.read())
        raise ValueError(
            f"unknown fault plan {s!r}: expected one of {cls.PRESETS}, "
            f"inline JSON, or a JSON file path")

    def to_json(self) -> str:
        return json.dumps(asdict(self))

    @classmethod
    def from_json(cls, s: str) -> "FaultPlan":
        d = json.loads(s)
        for k in ("brownout", "outage", "predictor_blackout",
                  "disk_outage"):
            if k in d:
                d[k] = tuple(tuple(w) for w in d[k])
        return cls(**d)


class FaultInjector:
    """Order-independent fault draws for one `FaultPlan`.

    Every decision for a transfer is a pure function of
    `(plan.seed, salt, key, attempt)` — NOT of the sequence of prior calls
    — so the engine (which draws failures at issue time, before touching
    the device) and the simulator (which draws at modeled completion time)
    agree per-transfer, and wall-clock-dependent iteration boundaries in
    the serving loop cannot perturb outcomes."""

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self._tries: Dict[object, int] = {}     # per-(salt, key) attempt no.
        self.n_failures = 0
        self.n_stalls = 0

    def _draw(self, salt: int, key, attempt: int) -> float:
        if key is None:           # keyless transfer (writeback)
            li, e = 1 << 20, 0
        elif isinstance(key, tuple):
            li, e = key
        else:
            li, e = 0, int(key)
        seq = (self.plan.seed, salt, int(li), int(e), int(attempt))
        return float(np.random.default_rng(seq).random())

    def _next_attempt(self, salt: int, key) -> int:
        k = (salt, key)
        n = self._tries.get(k, 0)
        self._tries[k] = n + 1
        return n

    # ----------------------------------------------------------- failures
    def transfer_fails(self, key, now: float) -> bool:
        """One transfer *attempt* for `key` at link-clock `now`; each call
        consumes an attempt so bounded retries see fresh draws."""
        attempt = self._next_attempt(0, key)
        if _in_window(self.plan.outage, now):
            self.n_failures += 1
            return True
        if self.plan.fail_prob > 0.0 \
                and self._draw(0, key, attempt) < self.plan.fail_prob:
            self.n_failures += 1
            return True
        return False

    # ------------------------------------------------------- timing hooks
    def transfer_extra_s(self, key, start: float) -> float:
        """Injected stall added to a transfer's duration (link latency
        hook). Drawn once per transfer start."""
        if self.plan.stall_prob <= 0.0 or self.plan.stall_s <= 0.0:
            return 0.0
        attempt = self._next_attempt(1, key)
        if self._draw(1, key, attempt) < self.plan.stall_prob:
            self.n_stalls += 1
            return self.plan.stall_s
        return 0.0

    def bandwidth_factor(self, key, t: float) -> float:
        """Effective bandwidth multiplier at link-clock `t` (global derate
        x active brownout windows x per-transfer jitter)."""
        f = self.plan.bandwidth_factor
        for a, b, fac in self.plan.brownout:
            if a <= t < b:
                f *= fac
        if self.plan.jitter > 0.0:
            attempt = self._next_attempt(2, key)
            f *= 1.0 - self.plan.jitter * self._draw(2, key, attempt)
        return max(f, 1e-9)

    # ------------------------------------------------------- other signals
    def predictor_blackout(self, t: float) -> bool:
        return _in_window(self.plan.predictor_blackout, t)

    def link_degraded(self, t: float) -> bool:
        """Is the link *structurally* unhealthy at `t`? (outage, or
        effective bandwidth below half of nominal — jitter excluded).
        Used by admission brownout in the simulator mirror."""
        if _in_window(self.plan.outage, t):
            return True
        f = self.plan.bandwidth_factor
        for a, b, fac in self.plan.brownout:
            if a <= t < b:
                f *= fac
        return f < 0.5

    def attach_link(self, link) -> None:
        """Install bandwidth/latency hooks on a `TransferLink` so brownout,
        jitter, and stalls shape the modeled transfer durations."""
        link.bandwidth_hook = lambda tr, t: self.bandwidth_factor(tr.key, t)
        link.latency_hook = lambda tr, t: self.transfer_extra_s(tr.key, t)

    # --------------------------------------------------------- disk scope
    # Same machinery as the device link, on salts 3/4/5 so the two links'
    # draws are independent: one plan can fail a transfer on disk but not
    # PCIe for the same (key, attempt), and vice versa. The tiered expert
    # store takes this scope and the corruption draws through `disk_view`.
    def disk_transfer_fails(self, key, now: float) -> bool:
        attempt = self._next_attempt(3, key)
        if _in_window(self.plan.disk_outage, now):
            self.n_failures += 1
            return True
        if self.plan.disk_fail_prob > 0.0 \
                and self._draw(3, key, attempt) < self.plan.disk_fail_prob:
            self.n_failures += 1
            return True
        return False

    def disk_transfer_extra_s(self, key, start: float) -> float:
        if self.plan.disk_stall_prob <= 0.0 or self.plan.disk_stall_s <= 0.0:
            return 0.0
        attempt = self._next_attempt(4, key)
        if self._draw(4, key, attempt) < self.plan.disk_stall_prob:
            self.n_stalls += 1
            return self.plan.disk_stall_s
        return 0.0

    def disk_bandwidth_factor(self, key, t: float) -> float:
        f = self.plan.disk_bandwidth_factor
        if self.plan.disk_jitter > 0.0:
            attempt = self._next_attempt(5, key)
            f *= 1.0 - self.plan.disk_jitter * self._draw(5, key, attempt)
        return max(f, 1e-9)

    def disk_link_degraded(self, t: float) -> bool:
        return (_in_window(self.plan.disk_outage, t)
                or self.plan.disk_bandwidth_factor < 0.5)

    # ------------------------------------------------------ corrupt scope
    # Salts 6/7/8. `disk_record_corrupt` pins the attempt to 0: on-media
    # rot is a property of the RECORD, not of the read — every re-fetch of
    # a rotten record re-reads the same bad bytes, which is exactly what
    # makes bounded re-fetch exhaust into permanent quarantine. The other
    # two draw per attempt/visit, so a re-fetch usually heals.
    def disk_record_corrupt(self, key) -> bool:
        """Is this expert's on-disk record rotten? Pure per key."""
        p = self.plan.corrupt_disk_prob
        return p > 0.0 and self._draw(6, key, 0) < p

    def promotion_corrupt(self, key) -> bool:
        """Did this disk->host promotion's payload flip in transit? One
        draw per delivery attempt."""
        p = self.plan.corrupt_link_prob
        if p <= 0.0:
            return False
        return self._draw(7, key, self._next_attempt(7, key)) < p

    def host_copy_corrupt(self, key) -> bool:
        """Did this host-resident copy rot in RAM? One draw per scrubber
        visit."""
        p = self.plan.corrupt_host_prob
        if p <= 0.0:
            return False
        return self._draw(8, key, self._next_attempt(8, key)) < p

    def disk_view(self) -> "_DiskFaultView":
        """Injector facade for the disk link: exposes the standard surface
        (`transfer_fails`/`attach_link`/...) backed by the disk-scope
        fields, so `Prefetcher`'s retry machinery is reused unchanged by
        the disk->host promotion queue."""
        return _DiskFaultView(self)


class _DiskFaultView:
    """Adapter presenting `FaultInjector`'s disk scope through the
    device-injector interface (see `FaultInjector.disk_view`)."""

    def __init__(self, injector: "FaultInjector"):
        self._inj = injector
        self.plan = injector.plan

    def transfer_fails(self, key, now: float) -> bool:
        return self._inj.disk_transfer_fails(key, now)

    def transfer_extra_s(self, key, start: float) -> float:
        return self._inj.disk_transfer_extra_s(key, start)

    def bandwidth_factor(self, key, t: float) -> float:
        return self._inj.disk_bandwidth_factor(key, t)

    def predictor_blackout(self, t: float) -> bool:
        return self._inj.predictor_blackout(t)

    def link_degraded(self, t: float) -> bool:
        return self._inj.disk_link_degraded(t)

    def disk_record_corrupt(self, key) -> bool:
        return self._inj.disk_record_corrupt(key)

    def promotion_corrupt(self, key) -> bool:
        return self._inj.promotion_corrupt(key)

    def host_copy_corrupt(self, key) -> bool:
        return self._inj.host_copy_corrupt(key)

    def attach_link(self, link) -> None:
        link.bandwidth_hook = lambda tr, t: self.bandwidth_factor(tr.key, t)
        link.latency_hook = lambda tr, t: self.transfer_extra_s(tr.key, t)


@dataclass
class StepWatchdog:
    """EWMA step-deadline monitor with hysteresis.

    `observe(step_s)` folds healthy samples into an EWMA baseline; once a
    step's wall-time exceeds `trip_factor` x EWMA (after `warmup` samples)
    the watchdog trips — the engine collapses its speculative horizon to
    S=0 — and it only untrips after `recover_steps` consecutive samples
    back under `recover_factor` x EWMA (hysteresis, so a borderline step
    cannot flap the horizon every iteration). Tripped samples are not
    folded into the EWMA: a sustained brownout must not normalize itself
    into the baseline."""

    alpha: float = 0.2
    trip_factor: float = 4.0
    recover_factor: float = 1.5
    recover_steps: int = 3
    warmup: int = 3          # samples before trip decisions (jit compiles)

    ewma_s: float = field(default=0.0, init=False)
    n: int = field(default=0, init=False)
    tripped: bool = field(default=False, init=False)
    n_trips: int = field(default=0, init=False)
    _ok_streak: int = field(default=0, init=False)

    def observe(self, step_s: float) -> bool:
        """Feed one step wall-time; returns the current tripped state."""
        self.n += 1
        if self.n <= self.warmup:
            self.ewma_s = step_s if self.n == 1 \
                else (1 - self.alpha) * self.ewma_s + self.alpha * step_s
            return self.tripped
        if self.tripped:
            if step_s < self.recover_factor * self.ewma_s:
                self._ok_streak += 1
                if self._ok_streak >= self.recover_steps:
                    self.tripped = False
                    self._ok_streak = 0
            else:
                self._ok_streak = 0
            if not self.tripped:
                self.ewma_s = (1 - self.alpha) * self.ewma_s \
                    + self.alpha * step_s
            return self.tripped
        if self.ewma_s > 0.0 and step_s > self.trip_factor * self.ewma_s:
            self.tripped = True
            self.n_trips += 1
            self._ok_streak = 0
            return True
        self.ewma_s = (1 - self.alpha) * self.ewma_s + self.alpha * step_s
        return False
