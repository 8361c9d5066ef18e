"""Attention (global causal): GQA and multi-head latent attention (MLA),
each with a chunked online-softmax prefill and a one-token decode.

`flash_attention` is plain PyTorch: it walks query and key/value blocks with
an online softmax, so the (T x S) score matrix is never materialised, and it
skips key blocks that causality masks out entirely. Layouts follow the
reference: q (B, T, Hq, D), k/v (B, S, Hkv, D). `q_offset` resumes a
prefill at an absolute position (chunked prefill: `gqa_prefill_chunk`,
`mla_prefill_chunk`). Sliding windows and logit soft-capping are not
ported yet.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.decode_superkernel import fused_mla_decode_attention
from repro_torch.models.layers import rms_norm, rope, trunc_normal

NEG_INF = -2.0 ** 30  # large-finite: avoids NaN from (-inf) - (-inf)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    q_offset: int = 0, q_chunk: int = 512,
                    kv_chunk: int = 1024) -> torch.Tensor:
    """Causal online-softmax attention; q[:, 0] sits at absolute position
    `q_offset` and k/v rows at positions 0..S-1.

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
        q_pos = torch.arange(q_offset + q0, q_offset + q1, device=dev)
        acc = torch.zeros((B, Hkv, G, qc, Dv), dtype=torch.float32, device=dev)
        m = torch.full((B, Hkv, G, qc), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((B, Hkv, G, qc), dtype=torch.float32, device=dev)
        # key blocks entirely in this query block's future are skipped
        for k0 in range(0, min(S, q_offset + q1), kv_chunk):
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


def gqa_prefill_chunk(params, h: torch.Tensor, positions: torch.Tensor,
                      k_cache: torch.Tensor, v_cache: torch.Tensor,
                      cache_len: int, n_valid: int, *, rope_theta: float,
                      norm_eps: float = 1e-6):
    """One padded prompt chunk of GQA attention, resuming at `cache_len`.

    h: (B, C, d) normed hidden states whose first `n_valid` rows are real
    tokens; positions: (B, C) absolute positions cache_len .. cache_len +
    C - 1; caches (B, S, Hkv, D) addressed by absolute position (no ring
    reuse while a prompt is ingested). The real rows' K/V are written IN
    PLACE at positions cache_len .. cache_len + n_valid - 1 (the caches
    belong to one prefill cursor; padding rows write nothing), then the
    chunk's queries attend causally over the ingested prefix through
    `flash_attention(q_offset=cache_len)`, the monolithic prefill's
    function. Returns (mix (B, C, d), k_cache, v_cache)."""
    q = gqa_project_q(params, h, positions, rope_theta, norm_eps)
    k, v = gqa_project_kv(params, h, positions, rope_theta, norm_eps)
    end = cache_len + n_valid
    k_cache[:, cache_len:end] = k[:, :n_valid]
    v_cache[:, cache_len:end] = v[:, :n_valid]
    out = flash_attention(q, k_cache[:, :end], v_cache[:, :end],
                          q_offset=cache_len)
    return gqa_out(params, out), k_cache, v_cache


# ---------------------------------------------------------------------------
# Multi-head Latent Attention (DeepSeek-V2)
# ---------------------------------------------------------------------------

def init_mla_params(d_model: int, num_heads: int, mla, dtype=torch.bfloat16,
                    **kw):
    """MLA weights with the reference's init law; `kw` carries `generator`
    and `device`."""
    qk_head = mla.qk_nope_head_dim + mla.qk_rope_head_dim
    dev = kw.get("device", "cpu")
    p = {}
    if mla.q_lora_rank:
        p["wq_a"] = trunc_normal((d_model, mla.q_lora_rank), d_model ** -0.5,
                                 dtype, **kw)
        p["q_a_norm"] = torch.ones((mla.q_lora_rank,), dtype=dtype,
                                   device=dev)
        p["wq_b"] = trunc_normal((mla.q_lora_rank, num_heads, qk_head),
                                 mla.q_lora_rank ** -0.5, dtype, **kw)
    else:
        p["wq"] = trunc_normal((d_model, num_heads, qk_head),
                               d_model ** -0.5, dtype, **kw)
    # joint KV down-projection: latent + shared rope key
    p["wkv_a"] = trunc_normal(
        (d_model, mla.kv_lora_rank + mla.qk_rope_head_dim), d_model ** -0.5,
        dtype, **kw)
    p["kv_a_norm"] = torch.ones((mla.kv_lora_rank,), dtype=dtype, device=dev)
    p["wkv_b"] = trunc_normal(
        (mla.kv_lora_rank, num_heads, mla.qk_nope_head_dim + mla.v_head_dim),
        mla.kv_lora_rank ** -0.5, dtype, **kw)
    p["wo"] = trunc_normal((num_heads, mla.v_head_dim, d_model),
                           (num_heads * mla.v_head_dim) ** -0.5, dtype, **kw)
    return p


def _mla_q(params, x: torch.Tensor, positions: torch.Tensor, mla,
           rope_theta: float, norm_eps: float) -> torch.Tensor:
    """The MLA query (LoRA or dense projection), rope on its pe half.
    x: (B, T, d) -> (B, T, H, nope + rope)."""
    nope = mla.qk_nope_head_dim
    if "wq_a" in params:
        qa = rms_norm(torch.einsum("btd,dr->btr", x, params["wq_a"]),
                      params["q_a_norm"], norm_eps)
        q = torch.einsum("btr,rhk->bthk", qa, params["wq_b"])
    else:
        q = torch.einsum("btd,dhk->bthk", x, params["wq"])
    q_nope, q_pe = q[..., :nope], q[..., nope:]
    return torch.cat([q_nope, rope(q_pe, positions, rope_theta)], dim=-1)


def _mla_latent(params, x: torch.Tensor, positions: torch.Tensor, mla,
                rope_theta: float, norm_eps: float):
    """The compressed KV of x (B, T, d): the normed latent (B, T, R) and the
    shared rope key (B, T, 1, P), both in x's dtype — what the cache holds."""
    R = mla.kv_lora_rank
    kv_a = torch.einsum("btd,dr->btr", x, params["wkv_a"])
    c_kv = rms_norm(kv_a[..., :R], params["kv_a_norm"], norm_eps)
    k_pe = rope(kv_a[..., R:][..., None, :], positions, rope_theta)
    return c_kv, k_pe


def _mla_qkv(params, x: torch.Tensor, positions: torch.Tensor, mla,
             rope_theta: float, norm_eps: float):
    """q, k, v expanded from the latent (the prefill side), and the
    (latent, rope key) pair the cache stores."""
    nope, rope_d = mla.qk_nope_head_dim, mla.qk_rope_head_dim
    q = _mla_q(params, x, positions, mla, rope_theta, norm_eps)
    c_kv, k_pe = _mla_latent(params, x, positions, mla, rope_theta, norm_eps)
    kv = torch.einsum("btr,rhk->bthk", c_kv, params["wkv_b"])
    k_nope, v = kv[..., :nope], kv[..., nope:]
    B, S, H, _ = k_nope.shape
    k = torch.cat([k_nope, k_pe.expand(B, S, H, rope_d)], dim=-1)
    return q, k, v, (c_kv, k_pe)


def mla_attention(params, x: torch.Tensor, *, positions: torch.Tensor, mla,
                  rope_theta: float, norm_eps: float = 1e-6) -> torch.Tensor:
    """Causal MLA over the whole sequence. x: (B, T, d) -> (B, T, d).
    `flash_attention` scales by q's width ** -0.5, which is MLA's
    (nope + rope) ** -0.5, and takes v narrower than q/k."""
    q, k, v, _ = _mla_qkv(params, x, positions, mla, rope_theta, norm_eps)
    return gqa_out(params, flash_attention(q, k, v))


def mla_prefill_chunk(params, h: torch.Tensor, positions: torch.Tensor,
                      latent_cache: torch.Tensor, pe_cache: torch.Tensor,
                      cache_len: int, n_valid: int, *, mla, rope_theta: float,
                      norm_eps: float = 1e-6):
    """One padded prompt chunk of MLA attention, resuming at `cache_len`.

    h: (B, C, d) normed hidden states (first `n_valid` rows real);
    latent_cache: (B, S, R); pe_cache: (B, S, 1, P). The real rows' latent
    and rope key are written IN PLACE at their absolute positions (the
    caches belong to one prefill cursor; padding rows write nothing), K/V
    are re-expanded from the latent cache over the ingested prefix (the
    prefill-side expansion, not decode's absorption), and the chunk's
    queries attend with `flash_attention(q_offset=cache_len)`. Returns
    (mix (B, C, d), latent_cache, pe_cache)."""
    B = h.shape[0]
    nope, rope_d = mla.qk_nope_head_dim, mla.qk_rope_head_dim
    q = _mla_q(params, h, positions, mla, rope_theta, norm_eps)
    c_kv, k_pe = _mla_latent(params, h, positions, mla, rope_theta, norm_eps)
    end = cache_len + n_valid
    latent_cache[:, cache_len:end] = c_kv[:, :n_valid]
    pe_cache[:, cache_len:end] = k_pe[:, :n_valid]
    kv = torch.einsum("bsr,rhk->bshk", latent_cache[:, :end],
                      params["wkv_b"])
    k_nope, v = kv[..., :nope], kv[..., nope:]
    H = k_nope.shape[2]
    k = torch.cat([k_nope, pe_cache[:, :end].expand(B, end, H, rope_d)],
                  dim=-1)
    out = flash_attention(q, k, v, q_offset=cache_len)
    return gqa_out(params, out), latent_cache, pe_cache


def mla_decode(params, x: torch.Tensor, latent_cache: torch.Tensor,
               pe_cache: torch.Tensor, cache_len: torch.Tensor, *, mla,
               rope_theta: float, norm_eps: float = 1e-6,
               use_kernel: bool = False, max_len: Optional[int] = None):
    """One-token MLA decode over the compressed cache, weight-absorbed.

    x: (B, 1, d); latent_cache: (B, S, R); pe_cache: (B, S, 1, P);
    cache_len: () or (B,) int64, the positions cached before this token.
    The new latent / rope-key row lands at position `cache_len` of each row
    (positional, no ring) in NEW cache tensors. The key half of wkv_b is
    absorbed into the query and the value half into the output, both in
    fp32, so attention runs over R-wide latent rows:

      score[h, s] = ((q_nope[h] @ Wk[h]) . c[s] + q_pe[h] . pe[s]) * scale
      out         = ((sum_s p[h, s] c[s]) @ Wv[h]) @ Wo

    `use_kernel=True` inserts and attends in one `fused_mla_decode_attention`
    call (`max_len`: a host int bounding every `cache_len`, which spares the
    kernel's wrapper a device read of the lengths); otherwise the same in
    torch ops. Returns (out (B, 1, d) in x's
    dtype, new latent cache, new pe cache)."""
    B = x.shape[0]
    nope, rope_d = mla.qk_nope_head_dim, mla.qk_rope_head_dim
    clen = cache_len.reshape(-1).expand(B)
    positions = clen[:, None]
    c_new, pe_new = _mla_latent(params, x, positions, mla, rope_theta,
                                norm_eps)
    q = _mla_q(params, x, positions, mla, rope_theta, norm_eps)
    q_nope, q_pe = q[..., :nope], q[..., nope:]
    wk = params["wkv_b"][..., :nope]          # (R, H, nope)
    wv = params["wkv_b"][..., nope:]          # (R, H, v)
    scale = (nope + rope_d) ** -0.5
    q_abs = torch.einsum("bthk,rhk->bhr", q_nope.float(), wk.float())
    if use_kernel:
        ctx, latent_cache, pe_sq = fused_mla_decode_attention(
            q_abs.contiguous(), q_pe[:, 0].float().contiguous(),
            c_new[:, 0].contiguous(), pe_new[:, 0, 0].contiguous(),
            latent_cache, pe_cache[:, :, 0], cache_len, scale=scale,
            max_len=max_len)
        pe_cache = pe_sq[:, :, None]
    else:
        rows = torch.arange(B, device=x.device)
        latent_cache = latent_cache.clone()
        pe_cache = pe_cache.clone()
        latent_cache[rows, clen] = c_new[:, 0]
        pe_cache[rows, clen] = pe_new[:, 0]
        lat = latent_cache.float()
        s_nope = torch.einsum("bhr,bsr->bhs", q_abs, lat)
        s_pe = torch.einsum("bthk,bsxk->bhs", q_pe.float(), pe_cache.float())
        s = (s_nope + s_pe) * scale
        S = latent_cache.shape[1]
        valid = torch.arange(S, device=x.device)[None, :] < (clen + 1)[:, None]
        s = torch.where(valid[:, None, :], s, torch.full_like(s, NEG_INF))
        p = torch.softmax(s, dim=-1)
        ctx = torch.einsum("bhs,bsr->bhr", p, lat)
    out = torch.einsum("bhr,rhv->bhv", ctx, wv.float())
    out = torch.einsum("bhv,hvd->bd", out, params["wo"].float())[:, None, :]
    return out.to(x.dtype), latent_cache, pe_cache
