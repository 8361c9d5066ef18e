"""Two-level LRU expert cache (paper §3.3.1).

Keys are (layer, expert) tuples. `LRU_high` holds experts with demonstrated
or predicted reuse; `LRU_low` holds cold experts. Evictions come from
`LRU_low` first; only when it is empty does `LRU_high` evict. Tier
assignments are re-evaluated as the step size S and the prediction set evolve
(`retier`). In-flight/pinned experts are never evicted.

This is the host-side replacement policy; the device-side slot buffer it
controls lives in `core/expert_buffer.py`.
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Hashable, Iterable, List, Optional, Set, Tuple

Key = Tuple[int, int]   # (layer, expert)


@dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0
    evictions: int = 0
    high_evictions: int = 0

    @property
    def miss_rate(self) -> float:
        n = self.hits + self.misses
        return self.misses / n if n else 0.0


class TwoLevelLRU:
    """Bounded set of resident experts with high/low reuse tiers."""

    def __init__(self, capacity: int):
        assert capacity >= 1
        self.capacity = capacity
        self.high: "OrderedDict[Key, None]" = OrderedDict()  # MRU at end
        self.low: "OrderedDict[Key, None]" = OrderedDict()
        self.pinned: Set[Key] = set()
        self.stats = CacheStats()

    # -- queries ---------------------------------------------------------
    def __contains__(self, key: Key) -> bool:
        return key in self.high or key in self.low

    def __len__(self) -> int:
        return len(self.high) + len(self.low)

    @property
    def free_slots(self) -> int:
        return self.capacity - len(self)

    def resident(self) -> List[Key]:
        return list(self.high) + list(self.low)

    # -- access ------------------------------------------------------------
    def touch(self, key: Key, *, high: bool = True) -> bool:
        """Record an access. Returns True on hit. A touched expert moves to
        the MRU end of its tier; promotion to high happens on reuse."""
        if key in self.high:
            self.high.move_to_end(key)
            self.stats.hits += 1
            return True
        if key in self.low:
            del self.low[key]
            tier = self.high if high else self.low
            tier[key] = None
            self.stats.hits += 1
            return True
        self.stats.misses += 1
        return False

    def insert(self, key: Key, *, high: bool = True) -> Optional[Key]:
        """Insert a new resident expert, evicting if at capacity.
        Returns the evicted key (or None)."""
        if key in self:
            self.touch(key, high=high)
            return None
        victim = None
        if len(self) >= self.capacity:
            victim = self.evict()
            if victim is None:
                raise RuntimeError("cache full of pinned experts")
        (self.high if high else self.low)[key] = None
        return victim

    def evict(self) -> Optional[Key]:
        """Evict preferentially from LRU_low (paper §3.3.1)."""
        for tier, is_high in ((self.low, False), (self.high, True)):
            for key in tier:           # LRU order (front = oldest)
                if key not in self.pinned:
                    del tier[key]
                    self.stats.evictions += 1
                    if is_high:
                        self.stats.high_evictions += 1
                    return key
        return None

    def remove(self, key: Key) -> None:
        self.high.pop(key, None)
        self.low.pop(key, None)
        self.pinned.discard(key)

    # -- pinning (in-flight transfers / currently-executing layer) ----------
    def pin(self, key: Key) -> None:
        self.pinned.add(key)

    def unpin(self, key: Key) -> None:
        self.pinned.discard(key)

    # -- tier maintenance (§3.3.1 "assignments are continuously updated") -----
    def retier(self, predicted: Iterable[Key], recent_layers: Iterable[int],
               current_layer: int) -> None:
        """Reassign tiers: experts predicted for imminent activation or used
        within `recent_layers` of the current layer go high; the rest demote
        to low. Called when S changes and after each prediction round."""
        pred = set(predicted)
        recent = set(recent_layers)
        moves_up = [k for k in self.low if k in pred or k[0] in recent]
        moves_down = [k for k in self.high
                      if k not in pred and k[0] not in recent]
        for k in moves_up:
            del self.low[k]
            self.high[k] = None
        for k in moves_down:
            del self.high[k]
            self.low[k] = None

    def protect_early_layers(self, s: int) -> None:
        """Paper §3.3.1: experts of the first S layers are reused at the next
        decoding step — keep them in the high tier so the sequential sweep
        does not evict them just before wrap-around."""
        early = [k for k in self.low if k[0] < s]
        for k in early:
            del self.low[k]
            self.high[k] = None
