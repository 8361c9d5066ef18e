"""Core neural-net primitives (PyTorch), same arithmetic as the reference.

Every function keeps the reference's layouts and its rounding points:
normalisation and rotary embedding compute in fp32 and round back to the
input dtype once at the end.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm with fp32 accumulation."""
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float = 10000.0) -> torch.Tensor:
    """Rotary position embedding.

    x: (..., seq, heads, head_dim); positions: (..., seq) integer.
    """
    head_dim = x.shape[-1]
    half = head_dim // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    angles = positions[..., :, None].float() * freq      # (..., seq, half)
    cos = torch.cos(angles)[..., :, None, :]             # (..., seq, 1, half)
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    """Gated FFN: (silu(x@Wg) * (x@Wu)) @ Wd."""
    g = x @ w_gate
    u = x @ w_up
    return (F.silu(g) * u) @ w_down


# ---------------------------------------------------------------- init utils

def trunc_normal(shape, stddev: float, dtype=torch.bfloat16, *,
                 generator: Optional[torch.Generator] = None,
                 device="cpu") -> torch.Tensor:
    """Normal truncated at two standard deviations, scaled by `stddev`, drawn
    in fp32 on `device` from `generator` (the reference's init law; the draws
    themselves differ between frameworks)."""
    t = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return (t * stddev).to(dtype)


def dense_init(d_in: int, d_out: int, dtype=torch.bfloat16, **kw):
    return trunc_normal((d_in, d_out), d_in ** -0.5, dtype, **kw)


def embed_init(vocab: int, d: int, dtype=torch.bfloat16, **kw):
    return trunc_normal((vocab, d), 1.0, dtype, **kw)
