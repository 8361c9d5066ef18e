"""Dispatch accounting and host spans for the slot-path runtime.

`Dispatcher` is the counted dispatch funnel. `Tracer` times the engine's
and the server's host boundaries: each `with tracer.span(name, counter)`
site adds its wall time (`time.perf_counter_ns`) to a `SlotPathStats`
field, and, when a `SpanLog` is attached (`tracer.log`), also records the
span with its parent and attributes. Without a log a site costs two clock
reads and the counter.

Counted spans form two groups that never count twice: the step
(`step_host_s`: an engine entry such as `decode_step` or `prefill_chunk`)
and its parts (`pull_s`, `launch_s`, `residency_s`). Within a group only
the outermost open span counts, so the parts sum to at most the step.
"""
from __future__ import annotations

import os
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

STEP = "step_host_s"
HostSpan = Tuple[float, float, str]      # perf_counter seconds, label


class SpanLog:
    """Spans in memory, in the order they opened, bounded by `capacity`:
    past it, spans are counted in `dropped` and not kept. A record is
    [name, t0_ns, t1_ns (None while open), parent index (-1 at a root),
    attributes]. Export after the run (`chrome_events`, `leaf_spans`)."""

    def __init__(self, capacity: int = 1 << 20):
        self.capacity = int(capacity)
        self.records: List[list] = []
        self.dropped = 0
        self._stack: List[int] = []
        self._tid = threading.get_native_id()
        # (perf_counter_ns, time_ns) read together: the clocks' anchor
        self.anchor = (time.perf_counter_ns(), time.time_ns())

    def open(self, name: str, t0: int, attrs: Dict[str, Any]) -> int:
        if len(self.records) >= self.capacity:
            self.dropped += 1
            return -1
        parent = self._stack[-1] if self._stack else -1
        self.records.append([name, t0, None, parent, attrs])
        idx = len(self.records) - 1
        self._stack.append(idx)
        return idx

    def close(self, idx: int, t1: int) -> None:
        self.records[idx][2] = t1
        self._stack.pop()

    def chrome_events(self, base_ns: int) -> List[dict]:
        """Closed spans as Chrome-trace `X` events on the wall clock, in
        microseconds after `base_ns` (a `torch.profiler` trace's
        `baseTimeNanoseconds`). perf_counter times map linearly through
        the anchor taken when the log started and one taken now."""
        p0, w0 = self.anchor
        p1, w1 = time.perf_counter_ns(), time.time_ns()
        rate = (w1 - w0) / (p1 - p0) if p1 > p0 else 1.0
        pid = os.getpid()
        out = []
        for i, (name, t0, t1, parent, attrs) in enumerate(self.records):
            if t1 is None:
                continue
            out.append({"name": name, "ph": "X", "cat": "program",
                        "ts": (w0 + (t0 - p0) * rate - base_ns) / 1e3,
                        "dur": (t1 - t0) * rate / 1e3,
                        "pid": pid, "tid": self._tid,
                        "args": dict(attrs, span=i, parent=parent)})
        return out

    def leaf_spans(self) -> List[HostSpan]:
        """The innermost span at each instant, as non-overlapping
        (t0_s, t1_s, label) on `time.perf_counter` seconds, ordered by
        start. The label is `<outer>/<leaf>`, `<outer>` being the leaf's
        outermost enclosing span that is not a `serve.` one (the engine
        entry, e.g. `decode_step/residency`), or the leaf's own name where
        it is that span or a `serve.` span."""
        recs = self.records
        children: List[List[int]] = [[] for _ in recs]
        top: List[int] = []
        for i, (name, _, _, parent, _) in enumerate(recs):
            up = top[parent] if parent >= 0 else -1
            if parent >= 0:
                children[parent].append(i)
            top.append(up if up >= 0 or name.startswith("serve.") else i)
        out: List[HostSpan] = []
        for i, (name, t0, t1, _, _) in enumerate(recs):
            if t1 is None:
                continue
            label = (name if top[i] in (-1, i)
                     else f"{recs[top[i]][0]}/{name}")
            cur = t0
            for c in children[i]:
                c0, c1 = recs[c][1], recs[c][2]
                if c1 is None:
                    continue
                if c0 > cur:
                    out.append((cur * 1e-9, c0 * 1e-9, label))
                cur = max(cur, c1)
            if t1 > cur:
                out.append((cur * 1e-9, t1 * 1e-9, label))
        out.sort()
        return out


class Tracer:
    """The counters and the optional span log behind every host span of
    one engine and its server."""

    def __init__(self, stats):
        self.stats = stats
        self.log: Optional[SpanLog] = None
        self._open = {STEP: 0, "part": 0}    # counted spans open per group

    def span(self, name: str, counter: Optional[str] = None,
             **attrs) -> "Span":
        """A `with` site: `counter` names the `SlotPathStats` field that
        takes the span's seconds (None: the log alone)."""
        return Span(self, name, counter, attrs)


class Span:
    __slots__ = ("tracer", "name", "counter", "attrs", "t0", "log", "idx",
                 "group")

    def __init__(self, tracer: Tracer, name: str, counter: Optional[str],
                 attrs: Dict[str, Any]):
        self.tracer, self.name, self.counter = tracer, name, counter
        self.attrs = attrs
        self.group = None if counter is None else (
            STEP if counter == STEP else "part")

    def set(self, **attrs) -> None:
        """Attributes known only once the span's work has run."""
        self.attrs.update(attrs)

    def __enter__(self) -> "Span":
        tr = self.tracer
        if self.group is not None:
            tr._open[self.group] += 1
        self.t0 = time.perf_counter_ns()
        self.log = log = tr.log
        self.idx = -1 if log is None else log.open(self.name, self.t0,
                                                   self.attrs)
        return self

    def __exit__(self, *exc) -> None:
        t1 = time.perf_counter_ns()
        tr = self.tracer
        if self.group is not None:
            tr._open[self.group] -= 1
            if tr._open[self.group] == 0:
                setattr(tr.stats, self.counter,
                        getattr(tr.stats, self.counter)
                        + (t1 - self.t0) * 1e-9)
        if self.idx >= 0:
            self.log.close(self.idx, t1)


class Dispatcher:
    """Counted dispatch funnel: every per-layer function call the engine
    issues goes through one of these (`self._dispatch(fn, *args)`), so the
    dispatch count cannot drift from the calls actually made; the host
    time spent issuing them is `launch_s`."""

    def __init__(self, tracer: Tracer):
        self.tracer = tracer

    def __call__(self, fn, *args, **kwargs):
        self.tracer.stats.dispatches += 1
        with self.tracer.span("launch", "launch_s", fn=fn.__name__):
            return fn(*args, **kwargs)
