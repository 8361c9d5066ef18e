"""The timed path: `ServingEngine.serve` over `SlotBufferEngine`, with the
window's stop and its timestamps taken from the benchmark's side.

`serve` serves its request list to completion and keeps no per-token
times, so the recorder wraps four of the program's calls on their
instances (nothing of the program is edited):

- `engine.decode_step`: a decode step starts;
- `batcher.step`: its tokens, just pulled to the host, are emitted;
- `engine.prefill_chunk`: one prompt chunk, with its real tokens;
- `server._emit_first_token`: a prompt's first token.

Each wrapper first checks the deadline: the first call after the window
has closed raises `WindowClosed`, which leaves `serve`. A token emitted
after the close is kept for the output check but counts in no rate. The
window opens at the end of a decode step, by the mix's rule (`opens`):
`first_decode`, or `all_decoding` (no prompt in flight, and every row the
scheduler will admit now is admitted). A traced run's trace ends at the first
decode step or prompt chunk `trace_s` seconds into the window.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple


class WindowClosed(Exception):
    """Raised from a wrapped call once the measured window has closed."""


@dataclass
class DecodeStep:
    t0: float
    t1: float
    rows: List[Tuple[int, int]]      # (request id, keys it attends to)


@dataclass
class Chunk:
    t0: float
    t1: float
    offset: int                      # prompt tokens before this chunk
    tokens: int                      # real tokens it ingested


@dataclass
class Recording:
    """What a run did, on the host's clock (`time.perf_counter`)."""
    decode: List[DecodeStep] = field(default_factory=list)
    chunks: List[Chunk] = field(default_factory=list)
    token_times: Dict[int, List[float]] = field(default_factory=dict)
    open_t: Optional[float] = None
    close_t: Optional[float] = None
    stats_open: Dict[str, float] = field(default_factory=dict)
    stats_last: Dict[str, float] = field(default_factory=dict)

    def in_window(self, t: float) -> bool:
        return self.open_t is not None and self.open_t < t <= self.close_t


class Recorder:
    """Installs the wrappers on one server and its engine."""

    def __init__(self, srv, window: dict, seconds: float,
                 on_open: Callable[[], None], trace_s: float = 0.0,
                 on_trace_end: Optional[Callable[[], None]] = None):
        self.srv = srv
        self.eng = srv.engine
        self.rule = window["opens"]
        if self.rule not in ("first_decode", "all_decoding"):
            raise ValueError(f"unknown window rule {self.rule!r}")
        self.seconds = float(seconds)
        self.on_open = on_open
        self.rec = Recording()
        self._decode_t0 = 0.0
        self._deferred = 0
        self._wrap_program()
        # the traced part of the window: its first `trace_s` seconds
        self.trace_s = float(trace_s)
        self.on_trace_end = on_trace_end

    # -- helpers ----------------------------------------------------------------
    def host_spans(self) -> List[Tuple[float, float, str]]:
        """What the host was doing, for the trace: decode steps (from the
        call to the token pull) and prompt chunks."""
        return ([(s.t0, s.t1, "decode step") for s in self.rec.decode]
                + [(c.t0, c.t1, "prompt chunk") for c in self.rec.chunks])

    def _late(self, t: float) -> bool:
        return self.rec.open_t is not None and t > self.rec.close_t

    def _deadline(self) -> None:
        t = time.perf_counter()
        if self._late(t):
            raise WindowClosed()
        if (self.on_trace_end is not None and self.rec.open_t is not None
                and t >= self.rec.open_t + self.trace_s):
            end, self.on_trace_end = self.on_trace_end, None
            end()

    def _note_stats(self, t: float) -> None:
        if self.rec.in_window(t):
            self.rec.stats_last = self.eng.stats.snapshot()

    # -- the wrappers -------------------------------------------------------------
    def _wrap_program(self) -> None:
        eng, srv, rec = self.eng, self.srv, self.rec
        decode_step, prefill_chunk = eng.decode_step, eng.prefill_chunk
        step, emit_first = srv.batcher.step, srv._emit_first_token

        def wrapped_decode(tok, state):
            self._deadline()
            self._decode_t0 = time.perf_counter()
            return decode_step(tok, state)

        def wrapped_step(next_tokens):
            t = time.perf_counter()
            if self._late(t):
                raise WindowClosed()
            rows = []
            for slot in next_tokens:
                req = srv.batcher.active[slot]
                rows.append((req.request_id, req.prompt_len + len(req.output)))
                rec.token_times.setdefault(req.request_id, []).append(t)
            rec.decode.append(DecodeStep(self._decode_t0, t, rows))
            self._note_stats(t)
            out = step(next_tokens)
            if rec.open_t is None:
                self._maybe_open(t)
            return out

        def wrapped_chunk(cursor):
            self._deadline()
            t0, o = time.perf_counter(), cursor.offset
            done = prefill_chunk(cursor)
            t1 = time.perf_counter()
            rec.chunks.append(Chunk(t0, t1, o, cursor.offset - o))
            self._note_stats(t1)
            if self._late(t1):
                raise WindowClosed()
            return done

        def wrapped_first(req, *args):
            emit_first(req, *args)
            t = time.perf_counter()
            rec.token_times.setdefault(req.request_id, []).append(t)
            if self._late(t):
                raise WindowClosed()

        eng.decode_step = wrapped_decode
        eng.prefill_chunk = wrapped_chunk
        srv.batcher.step = wrapped_step
        srv._emit_first_token = wrapped_first

    def _maybe_open(self, t: float) -> None:
        b = self.srv.batcher
        deferred = b.stats.admission_deferred
        refused = deferred > self._deferred
        self._deferred = deferred
        if self.rule == "all_decoding":
            if self.srv._prefills:
                return
            if b.waiting and len(b.active) < b.max_batch and not refused:
                return
        self.rec.open_t = t
        self.rec.close_t = t + self.seconds
        self.rec.stats_open = self.eng.stats.snapshot()
        self.rec.stats_last = dict(self.rec.stats_open)
        self.on_open()
