"""Token sampling on explicit `torch.Generator`s.

`sample` covers the single-stream engine (one temperature for the batch);
`sample_rows` gives every row its own generator and temperature, so a
request's sampled tokens do not depend on its batch neighbours. Rows with
temperature <= 0 take the argmax (first maximum on ties).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch


def _draw(logits: torch.Tensor, t: float,
          generator: Optional[torch.Generator]) -> torch.Tensor:
    probs = torch.softmax(logits.float() / t, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[..., 0]


def sample(logits: torch.Tensor, generator: Optional[torch.Generator] = None,
           temperature: float = 0.0) -> torch.Tensor:
    """logits: (B, V) -> (B,) int64; greedy at temperature <= 0."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    return _draw(logits, float(temperature), generator)


def sample_rows(logits: torch.Tensor,
                generators: Sequence[Optional[torch.Generator]],
                temperature: Sequence[float]) -> torch.Tensor:
    """Per-row sampling: row b draws from `generators[b]` at
    `temperature[b]` (greedy where <= 0)."""
    out = torch.argmax(logits, dim=-1)
    for b, t in enumerate(temperature):
        if t > 0.0:
            out[b] = _draw(logits[b:b + 1], float(t), generators[b])[0]
    return out
