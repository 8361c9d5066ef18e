"""xLSTM blocks: mLSTM (matrix memory) and sLSTM (scalar memory).

Exponential gating with max-state stabilisation (arXiv:2405.04517), as the
reference computes it. Prefill and training run a loop over time on fp32
states; every weight product except the sLSTM's small block-diagonal
recurrent `r_z` runs outside the loop, over the whole sequence
(`_mlstm_project`, `_slstm_project`), so a step is weight-free and the
backward pass accumulates no per-step weight gradients. Autograd runs
through the loop as it is.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.models.layers import rms_norm, trunc_normal

NEG_START = -1e30    # the stabiliser m's start value


class MLSTMState(NamedTuple):
    c: torch.Tensor   # (B, H, D, D) matrix memory
    n: torch.Tensor   # (B, H, D) normalizer
    m: torch.Tensor   # (B, H) stabilizer


class SLSTMState(NamedTuple):
    c: torch.Tensor   # (B, H, D)
    n: torch.Tensor   # (B, H, D)
    h: torch.Tensor   # (B, H, D) recurrent output
    m: torch.Tensor   # (B, H)


def init_mlstm_block(d_model: int, num_heads: int, proj_factor: float,
                     dtype=torch.bfloat16, **kw):
    """mLSTM weights with the reference's init law (`kw`: `generator`,
    `device`); the gate projections and biases stay fp32."""
    up = int(d_model * proj_factor)
    dev = kw.get("device", "cpu")
    f32 = torch.float32
    return {
        "w_up": trunc_normal((d_model, 2 * up), d_model ** -0.5, dtype, **kw),
        "w_q": trunc_normal((up, up), up ** -0.5, dtype, **kw),
        "w_k": trunc_normal((up, up), up ** -0.5, dtype, **kw),
        "w_v": trunc_normal((up, up), up ** -0.5, dtype, **kw),
        "w_i": trunc_normal((up, num_heads), up ** -0.5, f32, **kw),
        "w_f": trunc_normal((up, num_heads), up ** -0.5, f32, **kw),
        "b_i": torch.zeros((num_heads,), dtype=f32, device=dev),
        "b_f": torch.full((num_heads,), 3.0, dtype=f32, device=dev),
        "out_norm": torch.ones((up,), dtype=dtype, device=dev),
        "w_down": trunc_normal((up, d_model), up ** -0.5, dtype, **kw),
    }


def init_slstm_block(d_model: int, num_heads: int, proj_factor: float,
                     dtype=torch.bfloat16, **kw):
    """sLSTM weights and its gated FFN's (`kw`: `generator`, `device`);
    the gate projections, `r_z` and the biases stay fp32."""
    up = int(d_model * proj_factor)
    hd = d_model // num_heads
    dev = kw.get("device", "cpu")
    f32 = torch.float32
    return {
        "w_z": trunc_normal((d_model, d_model), d_model ** -0.5, dtype, **kw),
        "w_i": trunc_normal((d_model, num_heads), d_model ** -0.5, f32, **kw),
        "w_f": trunc_normal((d_model, num_heads), d_model ** -0.5, f32, **kw),
        "w_o": trunc_normal((d_model, d_model), d_model ** -0.5, dtype, **kw),
        "r_z": trunc_normal((num_heads, hd, hd), hd ** -0.5, f32, **kw),
        "b_i": torch.zeros((num_heads,), dtype=f32, device=dev),
        "b_f": torch.full((num_heads,), 3.0, dtype=f32, device=dev),
        "w_up": trunc_normal((d_model, up), d_model ** -0.5, dtype, **kw),
        "w_gate": trunc_normal((d_model, up), d_model ** -0.5, dtype, **kw),
        "w_down": trunc_normal((up, d_model), up ** -0.5, dtype, **kw),
    }


def _mlstm_project(params, num_heads: int, u: torch.Tensor):
    """Every weight product of the mLSTM for the whole sequence, outside
    the time loop. u: (B, T, up) -> q, k, v (B, T, H, D) in u's dtype and
    the i, f pre-activations (B, T, H) fp32."""
    B, T, up = u.shape
    H = num_heads
    D = up // H
    q = (u @ params["w_q"]).reshape(B, T, H, D)
    # the scale rounds to u's dtype first, as the reference's weak-typed
    # scalar does
    k = (u @ params["w_k"]).reshape(B, T, H, D) * torch.tensor(
        D ** -0.5, dtype=u.dtype, device=u.device)
    v = (u @ params["w_v"]).reshape(B, T, H, D)
    u32 = u.float()
    i_t = u32 @ params["w_i"] + params["b_i"]
    f_t = u32 @ params["w_f"] + params["b_f"]
    return q, k, v, i_t, f_t


def _mlstm_step(state: MLSTMState, qkvif):
    """One weight-free mLSTM step on precomputed projections: q, k, v
    (B, H, D), i, f (B, H). Returns (new state, h (B, H * D) in q's
    dtype)."""
    q, k, v, i_t, f_t = qkvif
    log_f = F.logsigmoid(f_t)      # the reference's -softplus(-f)
    m_new = torch.maximum(log_f + state.m, i_t)
    i_s = torch.exp(i_t - m_new)
    f_s = torch.exp(log_f + state.m - m_new)
    kf = k.float()
    vf = v.float()
    c_new = f_s[..., None, None] * state.c + i_s[..., None, None] * \
        (vf[..., :, None] * kf[..., None, :])
    n_new = f_s[..., None] * state.n + i_s[..., None] * kf
    qf = q.float()
    num = torch.einsum("bhde,bhe->bhd", c_new, qf)
    den = torch.maximum(torch.einsum("bhd,bhd->bh", n_new, qf).abs(),
                        torch.exp(-m_new))[..., None]
    B, H, D = q.shape
    h = (num / den).reshape(B, H * D)
    return MLSTMState(c_new, n_new, m_new), h.to(q.dtype)


def mlstm_zero_state(B: int, H: int, D: int, device) -> MLSTMState:
    """C and n at zero, m at NEG_START, fp32."""
    f32 = torch.float32
    return MLSTMState(torch.zeros((B, H, D, D), dtype=f32, device=device),
                      torch.zeros((B, H, D), dtype=f32, device=device),
                      torch.full((B, H), NEG_START, dtype=f32,
                                 device=device))


def mlstm_block(params, x: torch.Tensor, num_heads: int, *,
                state: Optional[MLSTMState] = None, decode: bool = False):
    """mLSTM block. x: (B, T, d) -> (out (B, T, d), state). decode=True:
    T == 1, one step from `state`."""
    B, T, d = x.shape
    u = x @ params["w_up"]
    up = u.shape[-1] // 2
    u, gate = u[..., :up], u[..., up:]
    H = num_heads
    if state is None:
        state = mlstm_zero_state(B, H, up // H, x.device)
    q, k, v, i_t, f_t = _mlstm_project(params, H, u)
    hs = []
    for t in range(1 if decode else T):
        state, h = _mlstm_step(state, (q[:, t], k[:, t], v[:, t], i_t[:, t],
                                       f_t[:, t]))
        hs.append(h)
    h = rms_norm(torch.stack(hs, dim=1), params["out_norm"])
    y = h * F.silu(gate)
    return y @ params["w_down"], state


def _slstm_project(params, num_heads: int, x: torch.Tensor):
    """The input-side weight products for the whole sequence (outside the
    loop): z (B, T, H, D) in x's dtype, i, f (B, T, H) and o (B, T, H, D)
    fp32."""
    B, T, d = x.shape
    H = num_heads
    D = d // H
    z_in = (x @ params["w_z"]).reshape(B, T, H, D)
    x32 = x.float()
    i_in = x32 @ params["w_i"] + params["b_i"]
    f_in = x32 @ params["w_f"] + params["b_f"]
    o_in = torch.sigmoid(x32 @ params["w_o"].float()).reshape(B, T, H, D)
    return z_in, i_in, f_in, o_in


def _slstm_step(params, state: SLSTMState, proj):
    """One sLSTM step on precomputed input projections: z (B, H, D), i, f
    (B, H), o (B, H, D); the recurrent `r_z` product runs here, in z's
    dtype. Returns (new state, h (B, H, D) fp32)."""
    z_in, i_t, f_t, o = proj
    dt = z_in.dtype
    z = z_in + torch.einsum("bhd,hde->bhe", state.h.to(dt),
                            params["r_z"].to(dt))
    z = torch.tanh(z.float())
    log_f = F.logsigmoid(f_t)      # the reference's -softplus(-f)
    m_new = torch.maximum(log_f + state.m, i_t)
    i_s = torch.exp(i_t - m_new)
    f_s = torch.exp(log_f + state.m - m_new)
    c_new = f_s[..., None] * state.c + i_s[..., None] * z
    n_new = f_s[..., None] * state.n + i_s[..., None]
    h_new = o * (c_new / torch.clamp(n_new, min=1e-6))
    return SLSTMState(c_new, n_new, h_new, m_new), h_new


def slstm_zero_state(B: int, H: int, D: int, device) -> SLSTMState:
    """c, n and h at zero, m at NEG_START, fp32."""
    z = torch.zeros((B, H, D), dtype=torch.float32, device=device)
    return SLSTMState(z, z, z, torch.full((B, H), NEG_START,
                                          dtype=torch.float32, device=device))


def slstm_block(params, x: torch.Tensor, num_heads: int, *,
                state: Optional[SLSTMState] = None, decode: bool = False):
    """sLSTM block and its gated FFN. x: (B, T, d) -> (out (B, T, d),
    state). decode=True: T == 1, one step from `state`."""
    B, T, d = x.shape
    H = num_heads
    if state is None:
        state = slstm_zero_state(B, H, d // H, x.device)
    z_in, i_in, f_in, o_in = _slstm_project(params, H, x)
    hs = []
    for t in range(1 if decode else T):
        state, h = _slstm_step(params, state, (z_in[:, t], i_in[:, t],
                                               f_in[:, t], o_in[:, t]))
        hs.append(h)
    h = torch.stack(hs, dim=1).reshape(B, T, d).to(x.dtype)
    u = F.gelu(h @ params["w_up"], approximate="tanh")
    g = h @ params["w_gate"]
    return (u * torch.sigmoid(g.float()).to(g.dtype)) @ params["w_down"], \
        state
