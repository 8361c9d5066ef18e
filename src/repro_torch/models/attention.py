"""Attention (GQA, global causal): chunked online-softmax prefill and
one-token decode.

`flash_attention` is plain PyTorch: it walks query and key/value blocks with
an online softmax, so the (T x S) score matrix is never materialised, and it
skips key blocks that causality masks out entirely. Layouts follow the
reference: q (B, T, Hq, D), k/v (B, S, Hkv, D). Sliding windows, logit
soft-capping and prefill continuation (`q_offset`) are not ported yet.
"""
from __future__ import annotations

import torch

from repro_torch.models.layers import rms_norm, rope

NEG_INF = -2.0 ** 30  # large-finite: avoids NaN from (-inf) - (-inf)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    q_chunk: int = 512, kv_chunk: int = 1024) -> torch.Tensor:
    """Causal online-softmax attention from position 0.

    q: (B, Tq, Hq, D); k, v: (B, S, Hkv, D); returns (B, Tq, Hq, D).
    Hq must be a multiple of Hkv (GQA).
    """
    B, Tq, Hq, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    Dv = v.shape[-1]
    G = Hq // Hkv
    q_chunk = min(q_chunk, Tq)
    kv_chunk = min(kv_chunk, S)
    dev = q.device
    out = torch.empty((B, Tq, Hq, Dv), dtype=q.dtype, device=dev)
    kf = k.float()
    vf = v.float()
    for q0 in range(0, Tq, q_chunk):
        q1 = min(q0 + q_chunk, Tq)
        qc = q1 - q0
        # (B, qc, Hkv, G, D) fp32, pre-scaled
        qblk = q[:, q0:q1].reshape(B, qc, Hkv, G, D).float() * D ** -0.5
        q_pos = torch.arange(q0, q1, device=dev)
        acc = torch.zeros((B, Hkv, G, qc, Dv), dtype=torch.float32, device=dev)
        m = torch.full((B, Hkv, G, qc), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((B, Hkv, G, qc), dtype=torch.float32, device=dev)
        # key blocks entirely in this query block's future are skipped
        for k0 in range(0, min(S, q1), kv_chunk):
            k1 = min(k0 + kv_chunk, S)
            k_pos = torch.arange(k0, k1, device=dev)
            s = torch.einsum("bqhgd,bkhd->bhgqk", qblk, kf[:, k0:k1])
            mask = k_pos[None, :] <= q_pos[:, None]
            s = torch.where(mask, s, torch.full_like(s, NEG_INF))
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            pv = torch.einsum("bhgqk,bkhd->bhgqd", p, vf[:, k0:k1])
            acc = acc * corr[..., None] + pv
            m = m_new
        o = acc / torch.clamp(l[..., None], min=1e-20)
        # (B, Hkv, G, qc, Dv) -> (B, qc, Hq, Dv)
        out[:, q0:q1] = o.permute(0, 3, 1, 2, 4).reshape(
            B, qc, Hq, Dv).to(q.dtype)
    return out


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor,
                     cache_len: torch.Tensor) -> torch.Tensor:
    """One-token attention against a KV cache.

    q: (B, 1, Hq, D); caches: (B, S, Hkv, D); cache_len: () or (B,) integer —
    number of valid cache entries *including* the current token's K/V
    (caller inserts before attending). Returns (B, 1, Hq, D).
    """
    B, _, Hq, D = q.shape
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    Dv = v_cache.shape[-1]
    G = Hq // Hkv
    dev = q.device
    cache_len = torch.as_tensor(cache_len, device=dev).reshape(-1).expand(B)
    qf = q.reshape(B, Hkv, G, D).float() * D ** -0.5
    s = torch.einsum("bhgd,bkhd->bhgk", qf, k_cache.float())
    valid = torch.arange(S, device=dev)[None, :] < cache_len[:, None]
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgk,bkhd->bhgd", p, v_cache.float())
    return out.reshape(B, 1, Hq, Dv).to(q.dtype)


def gqa_project_q(params, x: torch.Tensor, positions: torch.Tensor,
                  rope_theta: float, norm_eps: float = 1e-6) -> torch.Tensor:
    """Query projection + qk-norm + rope. x: (B, T, d) -> (B, T, Hq, D)."""
    q = torch.einsum("btd,dhk->bthk", x, params["wq"])
    if "q_norm" in params:
        q = rms_norm(q, params["q_norm"], norm_eps)
    if rope_theta > 0:
        q = rope(q, positions, rope_theta)
    return q


def gqa_project_kv(params, x: torch.Tensor, positions: torch.Tensor,
                   rope_theta: float, norm_eps: float = 1e-6):
    """Project k/v for cache insertion (decode path)."""
    k = torch.einsum("btd,dhk->bthk", x, params["wk"])
    v = torch.einsum("btd,dhk->bthk", x, params["wv"])
    if "k_norm" in params:
        k = rms_norm(k, params["k_norm"], norm_eps)
    if rope_theta > 0:
        k = rope(k, positions, rope_theta)
    return k, v


def gqa_out(params, mix: torch.Tensor) -> torch.Tensor:
    """Output projection (B, T, Hq, D) -> (B, T, d)."""
    return torch.einsum("bthk,hkd->btd", mix, params["wo"])
