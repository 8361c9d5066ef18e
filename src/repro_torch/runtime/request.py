"""Request objects for the serving runtime.

`Request` is the ONE request type across the serving stack: the real-engine
`runtime.serving.ServingEngine`, the latency simulator
(`simulator.serving.ServingRequest` subclasses it, adding replayed routing
traces), and `ContinuousBatcher` all operate on the same lifecycle fields,
and `core.metrics.request_metrics` turns any of them into the shared
`RequestMetrics` record.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

_ids = itertools.count()


@dataclass
class Request:
    # prompt ids; simulator requests replay pre-collected traces and may
    # carry only a length (prompt=None + explicit prompt_len)
    prompt: Optional[np.ndarray] = None      # (T,) int32 token ids
    max_new_tokens: int = 16
    temperature: float = 0.0                 # 0 = greedy
    eos_token: Optional[int] = None          # generation stops when sampled
    request_id: int = field(default_factory=lambda: next(_ids))
    arrival_s: float = 0.0
    prompt_len: int = 0                      # derived from prompt when given
    # admission-control estimate: predicted distinct experts per MoE layer
    # this request keeps hot (None = scheduler assumes top_k)
    predicted_ws: Optional[float] = None
    # SLO deadline relative to arrival: a request still QUEUED past
    # arrival_s + deadline_s is shed at admission instead of served late
    # (None = never shed). Admitted requests always run to completion.
    deadline_s: Optional[float] = None
    # filled by the engine / scheduler
    output: List[int] = field(default_factory=list)
    admitted_s: float = -1.0                 # left the queue, slot assigned
    prefill_done_s: float = -1.0             # prompt fully ingested (chunked
                                             # prefill spans iterations)
    first_token_s: float = -1.0              # prefill done, first token out
    finish_s: float = -1.0
    slot: int = -1

    def __post_init__(self) -> None:
        if self.prompt is not None and not self.prompt_len:
            self.prompt_len = int(len(self.prompt))

    @property
    def done(self) -> bool:
        if self.output and self.eos_token is not None \
                and self.output[-1] == self.eos_token:
            return True
        return len(self.output) >= self.max_new_tokens
