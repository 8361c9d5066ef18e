"""Whether what the timed path served is right: every served token against
the plain reference's logits.

For each request that the run served a token to, the reference computes
the full forward pass over its prompt and its served tokens but the last,
and reads the logits at the positions that predicted each served token:
the prompt's last position (the chunked prefill's output) and every
decode step after it. A served token's gap is the reference's best logit
there less the reference's logit of the served token: 0 where the program
served the reference's greedy token, small where it took a near-tie, large
where something is wrong. The numbers compared are the run's widest gap
and its mean gap over every compared token, each where the cell's limits
file gives it a limit (`limits/<cell>.json`), and the count of tokens
compared against a floor. Greedy requests only.

The control (`control_gaps`) puts the reference computed through float8 in
the program's place: at the same positions it takes its own best token,
whose gap is read from the float32 reference the same way.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from reference import model as ref_model

Served = Tuple[np.ndarray, List[int]]      # (prompt ids, served tokens)


@dataclass
class Verdict:
    numbers: Dict[str, float]    # worst_logit_gap, mean_logit_gap
    tokens: int
    requests: int
    failed: int                  # requests past a limit
    limits: Dict[str, float]

    @property
    def correct(self) -> bool:
        return (self.tokens >= self.limits["min_tokens"] and self.failed == 0
                and all(self.numbers[k] <= v for k, v in self.limits.items()
                        if k in self.numbers))

    def checks(self) -> dict:
        out = {k: {"value": self.numbers[k], "limit": v}
               for k, v in self.limits.items() if k in self.numbers}
        out["tokens_compared"] = {"value": self.tokens,
                                  "limit": self.limits["min_tokens"]}
        return out


def _inputs(served: Sequence[Served]):
    seqs, positions, targets = [], [], []
    for prompt, out in served:
        ids = np.concatenate([np.asarray(prompt, np.int64),
                              np.asarray(out[:-1], np.int64)])
        p = len(prompt)
        seqs.append(torch.from_numpy(ids))
        positions.append(torch.arange(p - 1, p - 1 + len(out)))
        targets.append(torch.as_tensor(out, dtype=torch.long))
    return seqs, positions, targets


def _gaps(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    tokens = tokens.to(logits.device)
    return logits.max(-1).values - logits.gather(1, tokens[:, None])[:, 0]


def served_gaps(conf: dict, seed: int, served: Sequence[Served],
                device) -> List[np.ndarray]:
    """Each request's gaps of its served tokens, in serving order."""
    served = [s for s in served if len(s[1])]
    seqs, positions, targets = _inputs(served)
    ref = ref_model.logits_at(conf, seed, seqs, positions, device)
    return [_gaps(r, t).cpu().numpy() for r, t in zip(ref, targets)]


def control_gaps(conf: dict, seed: int, served: Sequence[Served],
                 device) -> List[np.ndarray]:
    """At the same positions, the gaps of the tokens that the reference
    through float8 puts first."""
    served = [s for s in served if len(s[1])]
    seqs, positions, _ = _inputs(served)
    ref = ref_model.logits_at(conf, seed, seqs, positions, device)
    low = ref_model.logits_at(conf, seed, seqs, positions, device, "fp8")
    return [_gaps(r, l.argmax(-1)).cpu().numpy() for r, l in zip(ref, low)]


def numbers(gaps: Sequence[np.ndarray]) -> Dict[str, float]:
    every = np.concatenate([g for g in gaps if len(g)] or [np.zeros(0)])
    if not len(every):
        return {"worst_logit_gap": float("inf"),
                "mean_logit_gap": float("inf")}
    return {"worst_logit_gap": float(every.max()),
            "mean_logit_gap": float(every.mean())}


def verdict(gaps: Sequence[np.ndarray], limits: Dict[str, float]) -> Verdict:
    """`limits`: `min_tokens` and a limit for each number compared."""
    gaps = [g for g in gaps if len(g)]
    worst = limits.get("worst_logit_gap", float("inf"))
    return Verdict(numbers=numbers(gaps),
                   tokens=int(sum(len(g) for g in gaps)),
                   requests=len(gaps),
                   failed=sum(float(g.max()) > worst for g in gaps),
                   limits=dict(limits))
