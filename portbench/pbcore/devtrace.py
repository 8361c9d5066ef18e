"""Reading a `torch.profiler` trace (its Chrome trace JSON) of the window.

The profiler records the device's activity only (kernels, copies, and the
CUDA calls that issued them), which costs the host little; what the host
was doing comes from the benchmark's own timestamps (`pbcore.timed`),
placed on the trace's clock by two `cudaDeviceSynchronize` calls issued
at known host times, when the trace starts and when it ends (the two
clocks may run at slightly different rates: the mapping is linear).

From the device's timeline, clipped to the window: the seconds in which
any device operation ran (`busy_s`), in which a kernel ran, and in which a
host-to-device copy ran while no kernel did (the exposed expert stall);
the device operations by total time; the gaps in which nothing ran, named
by what the host was doing then (a decode step, a prompt chunk or the
serve loop, and the CUDA call in flight, or "python").
"""
from __future__ import annotations

import bisect
import json
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

Interval = Tuple[float, float]

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
MARK = "cudaDeviceSynchronize"
HostSpan = Tuple[float, float, str]         # host seconds, name


def union(iv: List[Interval]) -> List[Interval]:
    out: List[Interval] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def length(iv: List[Interval]) -> float:
    return sum(b - a for a, b in iv)


def minus(a: List[Interval], b: List[Interval]) -> List[Interval]:
    """Union `a` less union `b` (both already unions)."""
    out: List[Interval] = []
    j = 0
    for s, e in a:
        cur = s
        while j < len(b) and b[j][1] <= cur:
            j += 1
        k = j
        while k < len(b) and b[k][0] < e:
            if b[k][0] > cur:
                out.append((cur, b[k][0]))
            cur = max(cur, b[k][1])
            k += 1
        if cur < e:
            out.append((cur, e))
    return out


class _Spans:
    """Intervals (start, end, name) that do not nest, searchable by a
    point."""

    def __init__(self, spans: List[Tuple[float, float, str]]):
        self.spans = sorted(spans)
        self.starts = [a for a, _, _ in self.spans]

    def at(self, t: float) -> Optional[str]:
        i = bisect.bisect_right(self.starts, t) - 1
        if i >= 0 and self.spans[i][1] >= t:
            return self.spans[i][2]
        return None


@dataclass
class TraceFacts:
    window_s: float
    busy_s: float
    kernel_s: float
    stall_s: float
    device_ops: List[Tuple[str, float]]
    idle_gaps: List[Tuple[str, float]]
    launches: List[Tuple[str, int]]      # how often each of device_ops ran


def analyse(path: str, marks_s: Tuple[float, float],
            host: List[HostSpan], top: int = 10) -> TraceFacts:
    """`marks_s`: the host times (perf_counter seconds) of the two marks,
    which bound the traced window; `host`: what the host was doing (decode
    steps, prompt chunks)."""
    with open(path) as f:
        evs = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    marks = sorted(e["ts"] for e in evs
                   if e.get("cat") in LAUNCH_CATS and e.get("name") == MARK)
    if len(marks) < 2:
        raise ValueError("the trace holds no window marks")
    w0, w1 = marks[0], marks[-1]
    rate = (w1 - w0) / (marks_s[1] - marks_s[0])      # trace us a host s

    def on_trace(spans: List[HostSpan]) -> List[Tuple[float, float, str]]:
        return [(w0 + (a - marks_s[0]) * rate, w0 + (b - marks_s[0]) * rate,
                 n) for a, b, n in spans]

    def clip(e) -> Optional[Interval]:
        a, b = max(e["ts"], w0), min(e["ts"] + e.get("dur", 0), w1)
        return (a, b) if b > a else None

    dev = [e for e in evs if e.get("cat") in DEVICE_CATS]
    all_iv, kern_iv, h2d_iv = [], [], []
    by_name: Dict[str, float] = {}
    count: Dict[str, int] = {}
    for e in dev:
        iv = clip(e)
        if iv is None:
            continue
        all_iv.append(iv)
        count[e["name"]] = count.get(e["name"], 0) + 1
        if e["cat"] == "kernel":
            kern_iv.append(iv)
        elif e["cat"] == "gpu_memcpy" and "HtoD" in e["name"]:
            h2d_iv.append(iv)
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + iv[1] - iv[0]
    busy, kern, h2d = union(all_iv), union(kern_iv), union(h2d_iv)

    launches = [e for e in evs if e.get("cat") in LAUNCH_CATS]
    spans = _Spans(on_trace(host))
    in_flight = _Spans([(e["ts"], e["ts"] + e.get("dur", 0), e["name"])
                        for e in launches])
    gaps: Dict[str, float] = {}
    for a, b in minus([(w0, w1)], busy):
        mid = (a + b) / 2
        name = (spans.at(mid) or "serve loop") + ": " + \
            (in_flight.at(mid) or "python")
        gaps[name] = gaps.get(name, 0.0) + (b - a)

    def ranked(d: Dict[str, float]) -> List[Tuple[str, float]]:
        return [(k, v * 1e-6) for k, v in
                sorted(d.items(), key=lambda kv: -kv[1])[:top]]

    ops = ranked(by_name)
    return TraceFacts(window_s=(w1 - w0) * 1e-6, busy_s=length(busy) * 1e-6,
                      kernel_s=length(kern) * 1e-6,
                      stall_s=length(minus(h2d, kern)) * 1e-6,
                      device_ops=ops, idle_gaps=ranked(gaps),
                      launches=[(n, count[n]) for n, _ in ops])
