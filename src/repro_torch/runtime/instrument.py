"""Dispatch accounting for the slot-path runtime."""
from __future__ import annotations

from dataclasses import dataclass


@dataclass
class Dispatcher:
    """Counted dispatch funnel: every per-layer function call the engine
    issues goes through one of these (`self._dispatch(fn, *args)`), so the
    dispatch count cannot drift from the calls actually made."""
    stats: object

    def __call__(self, fn, *args, **kwargs):
        self.stats.dispatches += 1
        return fn(*args, **kwargs)
