"""What a run measured, as the metric readers see it (`RunView`), and the
readers' shared arithmetic.

The window is the half-open interval (open, close] of the host's clock. A
token counts in it where its timestamp does, a decode step and a prompt
chunk where they end. An inter-token gap is one request's token less its
previous token; it counts where its later token does. Counters are the
engine's `SlotPathStats` at the last event inside the window less their
value at its opening.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property
from typing import Dict, List, Optional

import numpy as np

from pbcore import model as pbmodel
from pbcore import peaks
from pbcore.devtrace import TraceFacts
from pbcore.timed import Chunk, DecodeStep, Recording


@dataclass
class RunView:
    conf: dict
    rec: Recording
    seconds: float
    setup_s: float
    trace: Optional[TraceFacts] = None

    def _inside(self, t: float) -> bool:
        return self.rec.in_window(t)

    @cached_property
    def decode(self) -> List[DecodeStep]:
        return [s for s in self.rec.decode if self._inside(s.t1)]

    @cached_property
    def chunks(self) -> List[Chunk]:
        return [c for c in self.rec.chunks if self._inside(c.t1)]

    @cached_property
    def output_tokens(self) -> int:
        return sum(self._inside(t) for ts in self.rec.token_times.values()
                   for t in ts)

    @cached_property
    def gaps_s(self) -> List[float]:
        return [b - a for ts in self.rec.token_times.values()
                for a, b in zip(ts, ts[1:]) if self._inside(b)]

    @cached_property
    def counters(self) -> Dict[str, float]:
        return {k: self.rec.stats_last[k] - v
                for k, v in self.rec.stats_open.items()}

    @cached_property
    def window_flops(self) -> float:
        """Model FLOPs of every token the window computed: each decoding
        row of its decode steps and each prompt token of its chunks, at
        the context it attended to."""
        per_tok = pbmodel.active_flops_per_token(self.conf)
        ctxs = [ctx for s in self.decode for _, ctx in s.rows]
        for c in self.chunks:
            ctxs += range(c.offset + 1, c.offset + c.tokens + 1)
        if not ctxs:
            return 0.0
        attn = pbmodel.attention_flops(self.conf, 1)   # linear in context
        return per_tok * len(ctxs) + attn * float(np.sum(ctxs))


# -- the readers' arithmetic ----------------------------------------------------

def share(part: float, whole: float) -> Optional[float]:
    return 100.0 * part / whole if whole > 0 else None


def per_decode_step(run: RunView, counter: str) -> Optional[float]:
    n = len(run.decode)
    return run.counters[counter] / n if n else None


def swap_gb_per(run: RunView, tokens: int) -> Optional[float]:
    return run.counters["swap_bytes"] / 1e9 / tokens if tokens else None


def idle_share(run: RunView) -> Optional[float]:
    t = run.trace
    return None if t is None else share(t.window_s - t.kernel_s, t.window_s)


def stall_share(run: RunView) -> Optional[float]:
    t = run.trace
    return None if t is None else share(t.stall_s, t.window_s)


def mfu(run: RunView) -> Optional[float]:
    if not run.window_flops:
        return None
    return share(run.window_flops, run.seconds * peaks.BF16_FLOP_PER_S)
