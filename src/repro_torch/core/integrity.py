"""End-to-end expert integrity: verify / quarantine / re-fetch state.

The tiered store moves expert weights constantly (disk -> host -> device)
and the router trusts whatever bytes arrive. A *dead* link degrades
gracefully (`core.faults`); a *lying* one — bit-flips from flaky NVMe,
truncated mmap pages, DMA corruption — silently serves garbage weights
straight into the FFN path. This module is the bookkeeping half of the
defense:

- `export_expert_shards` stamps a CRC-32 per expert record into the
  shard manifest (stdlib ``zlib.crc32`` over the raw serde bytes);
- `HostTierModel` verifies every disk->host promotion against that
  checksum before the copy becomes host-resident, and in ``scrub`` mode
  re-verifies already-resident copies with a budgeted background
  scrubber;
- a failed verification opens a **healing episode**: the copy is
  discarded and re-fetched from disk (bounded by ``refetch_max``,
  riding the existing retry/backoff machinery). Transient corruption
  (payload flipped in transit, in-RAM rot) heals on a clean re-fetch —
  counted as a *requarantine*. Corruption that survives every re-fetch
  is on the medium itself: the expert is **permanently quarantined**
  and falls through to the degraded resident-only routing of a failed
  demand (dead-sentinel token drop). Corruption can therefore never reach
  logits and can never deadlock a decode step.

`IntegrityGuard` is pure bookkeeping: the tiered store checks real bytes
(CRC) and reports each outcome, so a backend that draws the outcomes from
the fault injector instead runs the same state machine and emits the
same `ServingReport` health fields.

Episode invariant:

    n_episodes == n_requarantined + len(quarantined) + len(healing)

every detected-corrupt copy settles exactly once, as heal-or-quarantine.
"""
from __future__ import annotations

from typing import Dict, Set, Tuple

Key = Tuple[int, int]                       # (moe_layer_index, expert_id)

VERIFY_MODES = ("off", "promote", "scrub")


class IntegrityGuard:
    """Verify/quarantine/re-fetch state machine for one host tier.

    Modes: ``off`` (zero-cost, pre-feature behavior), ``promote``
    (verify disk->host promotions on arrival), ``scrub`` (promote
    verification plus budgeted background re-verification of resident
    copies). The guard never touches bytes itself — the owning tier
    calls ``record_corrupt``/``record_clean`` with the outcome of its
    backend-specific verification."""

    def __init__(self, mode: str = "off", *, scrub_budget: int = 2,
                 refetch_max: int = 3):
        if mode not in VERIFY_MODES:
            raise ValueError(f"verify mode {mode!r} not in {VERIFY_MODES}")
        self.mode = mode
        self.scrub_budget = int(scrub_budget)
        self.refetch_max = int(refetch_max)
        # permanent quarantine: the on-medium record itself is bad; the
        # expert is routed around (dead-sentinel drop) forever
        self.quarantined: Set[Key] = set()
        # open healing episodes: key -> failed verifications so far
        self.healing: Dict[Key, int] = {}
        # health counters (mirrored into ServingReport by both backends)
        self.n_corrupt_detected = 0      # verifications that failed
        self.n_requarantined = 0         # episodes healed by a clean copy
        self.n_scrubbed = 0              # background re-verifications run
        self.n_episodes = 0              # healing episodes ever opened
        self.n_quarantine_denials = 0    # demands refused on quarantine

    # ------------------------------------------------------------ modes
    @property
    def enabled(self) -> bool:
        return self.mode != "off"

    @property
    def scrub_enabled(self) -> bool:
        return self.mode == "scrub"

    # ------------------------------------------------------- transitions
    def is_quarantined(self, key: Key) -> bool:
        return key in self.quarantined

    def record_corrupt(self, key: Key) -> int:
        """A verification failed. Opens (or continues) the key's healing
        episode; returns the episode's failure count so far — the caller
        quarantines once it exceeds ``refetch_max``."""
        self.n_corrupt_detected += 1
        if key not in self.healing:
            self.n_episodes += 1
            self.healing[key] = 0
        self.healing[key] += 1
        return self.healing[key]

    def record_clean(self, key: Key) -> None:
        """A verification passed. If the key had an open healing episode
        the clean copy closes it — a successful requarantine."""
        if self.healing.pop(key, None) is not None:
            self.n_requarantined += 1

    def quarantine(self, key: Key) -> None:
        """Permanently quarantine: every re-fetch re-verified corrupt, so
        the disk record itself is bad. Closes any open episode."""
        self.healing.pop(key, None)
        self.quarantined.add(key)

    # ------------------------------------------------------------ stats
    @property
    def n_quarantined_experts(self) -> int:
        return len(self.quarantined)

    def counters(self) -> Dict[str, float]:
        return dict(n_corrupt_detected=self.n_corrupt_detected,
                    n_requarantined=self.n_requarantined,
                    n_scrubbed=self.n_scrubbed,
                    n_quarantined_experts=self.n_quarantined_experts)
