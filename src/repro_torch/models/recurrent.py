"""Recurrent blocks: RG-LRU (RecurrentGemma / Griffin).

The RG-LRU diagonal linear recurrence h_t = a_t * h_{t-1} + b_t runs as a
loop over time in fp32 (`rglru_scan`); every weight product of the block
runs outside it, over the whole sequence. The reference computes the same
recurrence as an associative scan, a tree of products: the two agree to
the last fp32 bits (1e-5 on the CPU tests), not bitwise.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models.layers import trunc_normal

_MAX_SQRT = 8.0  # Griffin's c: a = exp(-c * softplus(L) * r)


def init_rglru_block(d_model: int, lru_width: int, conv_width: int,
                     dtype=torch.bfloat16, **kw):
    """The block's weights with the reference's init law; `kw` carries
    `generator` and `device`. The recurrence's own parameters (`a_param`,
    the gate biases) stay fp32 in a bf16 model."""
    w = lru_width
    dev = kw.get("device", "cpu")
    a = torch.empty((w,), dtype=torch.float32, device=dev)
    a.uniform_(0.9, 0.999, generator=kw.get("generator"))
    return {
        "w_x": trunc_normal((d_model, w), d_model ** -0.5, dtype, **kw),
        "w_gate": trunc_normal((d_model, w), d_model ** -0.5, dtype, **kw),
        "conv_w": trunc_normal((conv_width, w), conv_width ** -0.5, dtype,
                               **kw),
        "conv_b": torch.zeros((w,), dtype=dtype, device=dev),
        "a_param": a,
        "w_input_gate": trunc_normal((w, w), w ** -0.5, dtype, **kw),
        "w_rec_gate": trunc_normal((w, w), w ** -0.5, dtype, **kw),
        "b_input_gate": torch.zeros((w,), dtype=torch.float32, device=dev),
        "b_rec_gate": torch.zeros((w,), dtype=torch.float32, device=dev),
        "w_out": trunc_normal((w, d_model), w ** -0.5, dtype, **kw),
    }


def _temporal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                   state: Optional[torch.Tensor] = None):
    """Causal depthwise temporal conv. x: (B, T, W); w: (K, W).

    Returns (y, new_state), the state being the trailing K - 1 inputs. The
    K taps are summed in x's dtype in tap order, as the reference does, so
    that bf16 results are bitwise its."""
    K = w.shape[0]
    if state is None:
        state = torch.zeros((x.shape[0], K - 1, x.shape[2]), dtype=x.dtype,
                            device=x.device)
    xp = torch.cat([state, x], dim=1)
    T = x.shape[1]
    y = sum(xp[:, i:i + T] * w[i] for i in range(K))
    new_state = xp[:, xp.shape[1] - (K - 1):]
    return y + b, new_state


def _rglru_coeffs(params, xb: torch.Tensor):
    """Per-step decay a_t and input b_t. xb: (B, T, W) fp32."""
    r = torch.sigmoid(xb @ params["w_rec_gate"].float()
                      + params["b_rec_gate"])
    i = torch.sigmoid(xb @ params["w_input_gate"].float()
                      + params["b_input_gate"])
    log_a = -_MAX_SQRT * r * F.softplus(params["a_param"])
    a = torch.exp(log_a)
    gated_x = xb * i
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) \
        * gated_x
    return a, b


def rglru_scan(a: torch.Tensor, b: torch.Tensor,
               h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t over axis 1 (time), sequentially in fp32;
    `h0` (B, W) is folded into the first input term, as the reference
    does. a, b: (B, T, W) -> h (B, T, W)."""
    b0 = b[:, 0] if h0 is None else torch.addcmul(b[:, 0], a[:, 0], h0)
    hs = [b0]
    for t in range(1, a.shape[1]):
        hs.append(torch.addcmul(b[:, t], a[:, t], hs[-1]))
    return torch.stack(hs, dim=1)


def rglru_block(params, x: torch.Tensor, *, conv_state=None, rec_state=None,
                decode: bool = False):
    """The Griffin recurrent block. x: (B, T, d) -> (out (B, T, d),
    conv_state (B, K-1, W), rec_state (B, W) fp32).

    decode=True: T == 1, one step from (conv_state, rec_state)."""
    xb = x @ params["w_x"]
    gate = F.gelu(x @ params["w_gate"], approximate="tanh")
    xb, conv_state = _temporal_conv(xb, params["conv_w"], params["conv_b"],
                                    conv_state)
    a, b = _rglru_coeffs(params, xb.float())
    if decode:
        h0 = rec_state if rec_state is not None else torch.zeros(
            (x.shape[0], a.shape[-1]), dtype=torch.float32, device=x.device)
        h = torch.addcmul(b[:, 0], a[:, 0], h0)    # the scan's step
        rec_state = h
        h = h[:, None]
    else:
        h = rglru_scan(a, b, rec_state)
        rec_state = h[:, -1]
    y = h.to(x.dtype) * gate
    return y @ params["w_out"], conv_state, rec_state
