"""Plain PyTorch versions of the port's hand-written kernels.

Each follows its kernel's arithmetic, not a looser oracle: the CPU path of
the wrapper runs it, the tests hold it against the reference package, and
the card's smoke check holds the kernel against it on the same inputs.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def slot_ffn_ref(x: torch.Tensor, slot_of_expert: torch.Tensor,
                 s_gate: torch.Tensor, s_up: torch.Tensor,
                 s_down: torch.Tensor) -> torch.Tensor:
    """Expert SwiGLU FFN with weights read through the expert -> slot table.

    x: (E, C, D) per-expert dispatch buffer; slot_of_expert: (E,) integer
    slots in [0, S); slot buffers (S, D, F) / (S, F, D). Returns (E, C, D)
    float32. g and u in fp32, h = silu(g) * u rounded to x's dtype, then
    h @ Wd in fp32 — the rounding points of the slot-indirect kernel.
    """
    idx = slot_of_expert.long()
    xf = x.float()
    g = torch.bmm(xf, s_gate[idx].float())
    u = torch.bmm(xf, s_up[idx].float())
    h = (F.silu(g) * u).to(x.dtype)
    return torch.bmm(h.float(), s_down[idx].float())
