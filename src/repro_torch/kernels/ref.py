"""Plain PyTorch versions of the port's hand-written kernels.

Each follows its kernel's arithmetic, not a looser oracle: the CPU path of
the wrapper runs it, the tests hold it against the reference package, and
the card's smoke check holds the kernel against it on the same inputs.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F


def expert_ffn_ref(x: torch.Tensor, w_gate: torch.Tensor,
                   w_up: torch.Tensor, w_down: torch.Tensor) -> torch.Tensor:
    """Grouped expert SwiGLU FFN with the kernel's rounding points.

    x: (E, C, D); w_gate / w_up: (E, D, F); w_down: (E, F, D). Returns
    (E, C, D) float32. g and u in fp32, h = silu(g) * u rounded to x's
    dtype (the TPU kernel's `.astype(x.dtype)`, which the reference's
    einsum oracle leaves out), then h @ Wd in fp32.
    """
    xf = x.float()
    g = torch.bmm(xf, w_gate.float())
    u = torch.bmm(xf, w_up.float())
    h = (F.silu(g) * u).to(x.dtype)
    return torch.bmm(h.float(), w_down.float())


def slot_ffn_ref(x: torch.Tensor, slot_of_expert: torch.Tensor,
                 s_gate: torch.Tensor, s_up: torch.Tensor,
                 s_down: torch.Tensor,
                 counts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Expert SwiGLU FFN with weights read through the expert -> slot table.

    x: (E, C, D) per-expert dispatch buffer; slot_of_expert: (E,) integer
    slots in [0, S); slot buffers (S, D, F) / (S, F, D). Returns (E, C, D)
    float32: `expert_ffn_ref` over the gathered weights, the rounding points
    of the slot-indirect kernel. With `counts` (E,), the rows of x[e] at or
    past counts[e] are zeros in the output, whatever x or the weights hold
    (the kernel leaves them unwritten).
    """
    idx = slot_of_expert.long()
    out = expert_ffn_ref(x, s_gate[idx], s_up[idx], s_down[idx])
    if counts is None:
        return out
    rows = torch.arange(x.shape[1], device=x.device)
    live = rows[None, :] < counts.to(x.device).long()[:, None]    # (E, C)
    return torch.where(live[..., None], out, out.new_zeros(()))


def tf32_split(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x = hi + lo for an fp32 tensor, as the f32 SwiGLU GEMM's 3xTF32
    products read them (`split_tf32` in csrc/swiglu_f32.cuh), bit for bit:
    hi rounded to TF32 (10 mantissa bits) to nearest with ties away from
    zero on the bit pattern, as `cvt.rna.tf32.f32` rounds a finite value or
    an infinity; lo = x - hi truncated to TF32, as the tensor cores read an
    fp32 register. A NaN from the subtraction is the GPU's canonical NaN
    0x7FFFFFFF, so a NaN x gives a NaN lo whatever hi became."""
    x = x.float().contiguous()
    hi = ((x.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)
    d = x - hi
    bits = torch.where(torch.isnan(d), 0x7FFFFFFF, d.view(torch.int32))
    return hi, (bits & ~0x1FFF).view(torch.float32)


TF32_STEP = 8   # reduction depth of one mma.sync.m16n8k8 TF32 product
TF32_PARTIAL = 16   # depth the tensor cores sum before each fp32 add


def _tf32_bmm(a: torch.Tensor, b: torch.Tensor, products: int
              ) -> torch.Tensor:
    """a @ b (batched, fp32) as the f32 GEMM forms it: k ascending; each
    16-deep partial sums, over its two 8-deep steps, lo_a.hi_b, hi_a.lo_b,
    hi_a.hi_b (3 products) or hi_a.hi_b alone (1 product), and is then
    added to an fp32 sum."""
    ah, al = tf32_split(a)
    bh, bl = tf32_split(b)
    out = a.new_zeros((a.shape[0], a.shape[1], b.shape[2]))
    for k0 in range(0, a.shape[2], TF32_PARTIAL):
        part = torch.zeros_like(out)
        for k1 in range(k0, min(k0 + TF32_PARTIAL, a.shape[2]), TF32_STEP):
            k = slice(k1, k1 + TF32_STEP)
            if products == 3:
                part = part + torch.bmm(al[..., k], bh[:, k])
                part = part + torch.bmm(ah[..., k], bl[:, k])
            part = part + torch.bmm(ah[..., k], bh[:, k])
        out = out + part
    return out


def expert_ffn_3xtf32(x: torch.Tensor, w_gate: torch.Tensor,
                      w_up: torch.Tensor, w_down: torch.Tensor, *,
                      products: int = 3) -> torch.Tensor:
    """Twin of the f32 path of the SwiGLU GEMM: `expert_ffn_ref`'s function
    in fp32 with every product formed from TF32 operands (`_tf32_bmm`).
    `products=1` is a single TF32 product, which misses the reference's
    2e-5; 3 (3xTF32) is what the kernel does."""
    xf = x.float()
    g = _tf32_bmm(xf, w_gate.float(), products)
    u = _tf32_bmm(xf, w_up.float(), products)
    return _tf32_bmm(F.silu(g) * u, w_down.float(), products)


FFN_BLOCK_M = 128   # rows per tile of the SwiGLU GEMM (csrc/swiglu_gemm.cuh)


def _expert_rows(counts, E: int, C: int) -> List[int]:
    if counts is None:
        return [C] * E
    return [min(max(int(c), 0), C) for c in counts]


def ffn_tile_schedule(counts, C: int, block_m: int = FFN_BLOCK_M
                      ) -> List[Tuple[int, int]]:
    """The (expert, m0) row tiles the SwiGLU GEMM computes for per-expert
    row counts (each clamped to [0, C]): experts in order, ceil(rows /
    block_m) tiles each, none for an expert with no rows. Each tile is
    computed once per column panel."""
    rows = _expert_rows(counts, len(counts), C)
    return [(e, m * block_m) for e, r in enumerate(rows)
            for m in range(-(-r // block_m))]


def ffn_block_tiles(counts, E: int, C: int, n_panels: int, block: int,
                    grid: int, block_m: int = FFN_BLOCK_M
                    ) -> List[Tuple[int, int, int]]:
    """Python twin of the SwiGLU GEMM's tile walk (`TileWalker` in
    csrc/swiglu_gemm.cuh): the (expert, panel, m0) output tiles that block
    `block` of a persistent grid of `grid` blocks computes, in order. The
    tile list runs expert by expert, panel by panel, m-tile fastest; block
    b takes tiles b, b + grid, ... `counts` None means C rows an expert."""
    m_tiles = [-(-r // block_m) for r in _expert_rows(counts, E, C)]
    out: List[Tuple[int, int, int]] = []
    e, start, t = 0, 0, block        # expert e's tiles start at `start`
    while e < E:
        if t >= start + m_tiles[e] * n_panels:
            start += m_tiles[e] * n_panels
            e += 1
            continue
        panel, m = divmod(t - start, m_tiles[e])
        out.append((e, panel, m * block_m))
        t += grid
    return out


TOPK_MASK = -1e30   # top-k masking value, as the reference kernel's


def topk_gating_ref(logits: torch.Tensor, k: int, norm: bool = True):
    """Softmax + top-k router gating with the kernel's selection rule.

    logits: (T, E), any float dtype. Returns (gates (T, k) float32,
    ids (T, k) int32). Softmax in fp32; then k rounds of max with the
    first (lowest-index) argmax, the chosen entry masked to -1e30. With
    `norm`, gates are divided by max(sum, 1e-9), the sum taken in rank
    order.
    """
    work = torch.softmax(logits.float(), dim=-1)
    T, E = work.shape
    iota = torch.arange(E, device=work.device).expand(T, E)
    vals, idxs = [], []
    total = torch.zeros((T, 1), dtype=torch.float32, device=work.device)
    for _ in range(k):
        v = work.amax(dim=-1, keepdim=True)
        idx = torch.where(work == v, iota, E).amin(dim=-1, keepdim=True)
        work = torch.where(iota == idx, torch.full_like(work, TOPK_MASK),
                           work)
        vals.append(v)
        idxs.append(idx)
        total = total + v
    gates = torch.cat(vals, dim=-1)
    if norm:
        gates = gates / torch.clamp(total, min=1e-9)
    return gates, torch.cat(idxs, dim=-1).to(torch.int32)


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


def _merge_splits(parts):
    """The split-S kernels' merge: the splits' (max, sum, partial output)
    combined in ascending split order, then normalised."""
    mx = parts[0][0]
    for m, _, _ in parts[1:]:
        mx = torch.maximum(mx, m)
    total = torch.zeros_like(parts[0][1])
    out = torch.zeros_like(parts[0][2])
    for m, l, acc in parts:
        w = torch.exp(m - mx)
        total = total + l * w
        out = out + acc * w[..., None]
    return out / torch.clamp(total, min=1e-20)[..., None]


GQA_SPLITS = 8    # blocks a (kv head, row) (csrc/fused_decode_attention.cu)
GQA_CHUNK = 32    # positions a chunk of a block's online softmax


def gqa_split_merge(q: torch.Tensor, k_new: torch.Tensor,
                    v_new: torch.Tensor, k_cache: torch.Tensor,
                    v_cache: torch.Tensor, cache_len: torch.Tensor, *,
                    logit_softcap: float = 0.0, scale=None,
                    splits: int = GQA_SPLITS, chunk: int = GQA_CHUNK):
    """Plain-torch twin of the split-S walk of `fused_decode_attention`'s
    kernel: the function of `fused_decode_attention_ref` computed the
    kernel's way. Split s of each (row, kv head) owns positions
    [s per, (s + 1) per), per = ceil(S / splits), and runs an online
    softmax over its attended positions in chunks of `chunk`; the splits'
    (max, sum, partial output) then merge in ascending split order.
    Returns (out in q's dtype, new k cache, new v cache)."""
    B, _, Hq, D = q.shape
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    G = Hq // Hkv
    if scale is None:
        scale = D ** -0.5
    clen = cache_len.reshape(-1).expand(B).long()
    rows = torch.arange(B, device=q.device)
    slot = torch.remainder(clen, S)
    kc, vc = k_cache.clone(), v_cache.clone()
    kc[rows, slot] = k_new[:, 0]
    vc[rows, slot] = v_new[:, 0]
    valid = torch.clamp(clen + 1, max=S)
    qf = q.reshape(B, Hkv, G, D).float() * scale
    kf, vf = kc.float(), vc.float()
    per = -(-S // splits)
    parts = []
    for s in range(splits):
        m = torch.full((B, Hkv, G), NEG_INF, device=q.device)
        l = torch.zeros((B, Hkv, G), device=q.device)
        acc = torch.zeros((B, Hkv, G, D), device=q.device)
        end = min((s + 1) * per, S)
        for c0 in range(min(s * per, S), end, chunk):
            c1 = min(c0 + chunk, end)
            sc = torch.einsum("bhgd,bjhd->bhgj", qf, kf[:, c0:c1])
            if logit_softcap > 0.0:
                sc = logit_softcap * torch.tanh(sc / logit_softcap)
            live = (torch.arange(c0, c1, device=q.device)[None, :]
                    < valid[:, None])[:, None, None, :]       # (B,1,1,n)
            mx = torch.where(live, sc, torch.full_like(sc, NEG_INF)).amax(-1)
            m_new = torch.maximum(m, mx)
            corr = torch.exp(m - m_new)
            p = torch.where(live, torch.exp(sc - m_new[..., None]),
                            torch.zeros_like(sc))
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhgj,bjhd->bhgd", p, vf[:, c0:c1])
            m = m_new
        parts.append((m, l, acc))
    out = _merge_splits(parts)
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


def moe_entry_work_list(ids, slot_of_expert, n_slots: int
                        ) -> List[Tuple[int, int, List[int]]]:
    """Python twin of the work list `fused_moe_entry`'s route launch builds
    on the device (`Work` in csrc/fused_moe_entry.cu): (expert, slot,
    assignments) for every expert that is routed and resident (slot in
    [0, n_slots)), in ascending id, its assignments t * k + j in ascending
    order; their grouped rows follow in that order. ids: (T, k) integers;
    slot_of_expert: (E,) integers. The expert passes walk it as
    `ffn_block_tiles` over the per-expert row counts (len(assignments), 0
    for every other expert), C = T."""
    flat = [int(e) for e in torch.as_tensor(ids).reshape(-1).tolist()]
    slots = [int(s) for s in torch.as_tensor(slot_of_expert).tolist()]
    out = []
    for e, s in enumerate(slots):
        rows = [i for i, v in enumerate(flat) if v == e]
        if 0 <= s < n_slots and rows:
            out.append((e, s, rows))
    return out


MLA_SPLITS = 8    # blocks a batch row (csrc/fused_mla_decode_attention.cu)
MLA_CHUNK = 32    # positions a chunk of a block's online softmax


def mla_split_merge(q_abs: torch.Tensor, q_pe: torch.Tensor,
                    c_new: torch.Tensor, pe_new: torch.Tensor,
                    latent: torch.Tensor, pe: torch.Tensor,
                    cache_len: torch.Tensor, *, scale: float,
                    splits: int = MLA_SPLITS, chunk: int = MLA_CHUNK):
    """Plain-torch twin of the split-S walk of `fused_mla_decode_attention`'s
    kernel: the function of `fused_mla_decode_attention_ref` computed the
    kernel's way. Split s of each row owns positions [s per, (s + 1) per),
    per = ceil(S / splits), and runs an online softmax over its attended
    positions in chunks of `chunk`; the splits' (max, sum, context) then
    merge in ascending split order. Returns (ctx fp32, new latent, new pe)."""
    B, S, R = latent.shape
    clen = cache_len.reshape(-1).expand(B).long()
    ins = torch.clamp(clen, -1, S)
    rows = torch.arange(B, device=latent.device)
    lat, pe2 = latent.clone(), pe.clone()
    fits = (ins >= 0) & (ins < S)
    lat[rows[fits], ins[fits]] = c_new[fits]
    pe2[rows[fits], ins[fits]] = pe_new[fits]
    valid = torch.clamp(ins + 1, max=S)
    q = torch.cat([q_abs, q_pe], -1).float()                  # (B, H, K)
    kv = torch.cat([lat, pe2], -1).float()                    # (B, S, K)
    H = q.shape[1]
    per = -(-S // splits)
    parts = []
    for s in range(splits):
        m = torch.full((B, H), NEG_INF, device=q.device)
        l = torch.zeros((B, H), device=q.device)
        acc = torch.zeros((B, H, R), device=q.device)
        end = min((s + 1) * per, S)
        for c0 in range(min(s * per, S), end, chunk):
            c1 = min(c0 + chunk, end)
            sc = torch.einsum("bhk,bjk->bhj", q, kv[:, c0:c1]) * scale
            live = (torch.arange(c0, c1, device=q.device)[None, :]
                    < valid[:, None])[:, None, :]             # (B, 1, n)
            mx = torch.where(live, sc, torch.full_like(sc, NEG_INF)).amax(-1)
            m_new = torch.maximum(m, mx)
            corr = torch.exp(m - m_new)
            p = torch.where(live, torch.exp(sc - m_new[..., None]),
                            torch.zeros_like(sc))
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhj,bjr->bhr", p, kv[:, c0:c1, :R])
            m = m_new
        parts.append((m, l, acc))
    return _merge_splits(parts), lat, pe2
