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


NEG_INF = -2.0 ** 30   # attention masking (the reference's large-finite)


def fused_moe_entry_ref(x: torch.Tensor, router_w: torch.Tensor,
                        logit_bias: torch.Tensor,
                        slot_of_expert: torch.Tensor, s_gate: torch.Tensor,
                        s_up: torch.Tensor, s_down: torch.Tensor, *,
                        top_k: int, norm_topk: bool = True):
    """Route + top-k + slot lookup + gate-weighted expert SwiGLU, with the
    decode superkernel's rounding points.

    x: (T, d); router_w: (d, E); logit_bias: (E,) additive; slot_of_expert:
    (E,) integer, -1 = not resident; slot buffers (S, d, f) / (S, f, d).
    Returns (y (T, d) float32, gates (T, k) float32, ids (T, k) int32).

    Logits, softmax and top-k in fp32, ties to the lowest expert id; the
    renormalising total summed in rank order. Gates of non-resident experts
    are zeroed and those assignments contribute nothing (no weights are
    read for them). g = x @ Wg and u = x @ Wu each round to x's dtype, as
    does h = silu(g) * u and the down-projection `part`; y sums
    gate * part in fp32 over each token's experts in ascending id, the
    order the reference kernel's expert grid accumulates in.
    """
    logits = x.float() @ router_w.float() + logit_bias.float()
    probs = torch.softmax(logits, dim=-1)
    s, i = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, ids = s[:, :top_k], i[:, :top_k]
    if norm_topk:
        total = torch.zeros_like(gates[:, :1])
        for j in range(top_k):
            total = total + gates[:, j:j + 1]
        gates = gates / torch.clamp(total, min=1e-9)
    slot_raw = slot_of_expert.long()[ids]                        # (T, k)
    resident = slot_raw >= 0
    gates = gates * resident.float()
    slot = torch.clamp(slot_raw, min=0)
    xf = x.float()
    g = torch.einsum("td,tkdf->tkf", xf, s_gate[slot].float()).to(x.dtype)
    u = torch.einsum("td,tkdf->tkf", xf, s_up[slot].float()).to(x.dtype)
    h = F.silu(g) * u
    part = torch.einsum("tkf,tkfd->tkd", h.float(),
                        s_down[slot].float()).to(x.dtype)
    order = torch.argsort(ids, dim=-1)          # ids are distinct per token
    y = torch.zeros((x.shape[0], x.shape[1]), dtype=torch.float32,
                    device=x.device)
    for j in range(top_k):
        idx = order[:, j:j + 1]
        gj = gates.gather(1, idx)                                 # (T, 1)
        pj = part.gather(1, idx[:, :, None].expand(-1, -1, x.shape[1]))[:, 0]
        keep = resident.gather(1, idx)
        y = y + torch.where(keep, gj * pj.float(), torch.zeros_like(y))
    return y, gates, ids.to(torch.int32)


def fused_decode_attention_ref(q: torch.Tensor, k_new: torch.Tensor,
                               v_new: torch.Tensor, k_cache: torch.Tensor,
                               v_cache: torch.Tensor, cache_len: torch.Tensor,
                               *, logit_softcap: float = 0.0, scale=None):
    """One-token GQA attention with the new K/V inserted into the ring.

    q: (B, 1, Hq, D); k_new/v_new: (B, 1, Hkv, D); caches (B, S, Hkv, D);
    cache_len: () or (B,) integer, the entries cached BEFORE this token.
    Returns (out (B, 1, Hq, D) in q's dtype, new k cache, new v cache): the
    caches are new tensors with row `cache_len % S` replaced, and the
    inputs are left as they were. Scores in fp32 with q scaled by
    `D ** -0.5` before the dot, optional softcap `c * tanh(s / c)`, masked
    softmax over the first `min(cache_len + 1, S)` positions.
    """
    B, _, Hq, D = q.shape
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    G = Hq // Hkv
    if scale is None:
        scale = D ** -0.5
    clen = cache_len.reshape(-1).expand(B).long()
    rows = torch.arange(B, device=q.device)
    slot = torch.remainder(clen, S)
    kc = k_cache.clone()
    vc = v_cache.clone()
    kc[rows, slot] = k_new[:, 0]
    vc[rows, slot] = v_new[:, 0]
    valid = torch.clamp(clen + 1, max=S)
    qf = q.reshape(B, Hkv, G, D).float() * scale
    s = torch.einsum("bhgd,bkhd->bhgk", qf, kc.float())
    if logit_softcap > 0.0:
        s = logit_softcap * torch.tanh(s / logit_softcap)
    mask = torch.arange(S, device=q.device)[None, :] < valid[:, None]
    s = torch.where(mask[:, None, None, :], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgk,bkhd->bhgd", p, vc.float())
    return out.reshape(B, 1, Hq, D).to(q.dtype), kc, vc


def fused_mla_decode_attention_ref(q_abs: torch.Tensor, q_pe: torch.Tensor,
                                   c_new: torch.Tensor, pe_new: torch.Tensor,
                                   latent: torch.Tensor, pe: torch.Tensor,
                                   cache_len: torch.Tensor, *, scale: float):
    """Weight-absorbed MLA decode attention with the new latent / rope-key
    row inserted at each row's position.

    q_abs: (B, H, R) (q_nope absorbed through wkv_b's key half); q_pe:
    (B, H, P); c_new: (B, R); pe_new: (B, P); latent: (B, S, R); pe:
    (B, S, P); cache_len: () or (B,) integer, the positions cached BEFORE
    this token, each < S. Returns (ctx (B, H, R) float32, new latent, new
    pe): the caches are new tensors with position `cache_len` replaced
    (positional, no ring) and the inputs are left as they were. Scores
    (q_abs . latent + q_pe . pe) * scale in fp32 from the fp32-cast caches,
    masked softmax over the first `cache_len + 1` positions, ctx the
    p-weighted sum of the fp32 latent rows.
    """
    B, H, R = q_abs.shape
    S = latent.shape[1]
    clen = cache_len.reshape(-1).expand(B).long()
    rows = torch.arange(B, device=q_abs.device)
    lat = latent.clone()
    pe2 = pe.clone()
    lat[rows, clen] = c_new
    pe2[rows, clen] = pe_new
    latf, pef = lat.float(), pe2.float()
    s = (torch.einsum("bhr,bsr->bhs", q_abs.float(), latf)
         + torch.einsum("bhp,bsp->bhs", q_pe.float(), pef)) * scale
    mask = torch.arange(S, device=q_abs.device)[None, :] < (clen + 1)[:, None]
    s = torch.where(mask[:, None, :], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhs,bsr->bhr", p, latf), lat, pe2
