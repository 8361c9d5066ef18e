"""Plain reference of the served models, in float32 PyTorch.

A decoder of pre-norm blocks: RMSNorm, attention, RMSNorm, an FFN, each
added to the residual stream; then a final RMSNorm and the LM head. The
attention is grouped-query attention (with the query and key RMSNorm of
the configuration's `as_run.qk_norm`) or multi-head latent attention
(DeepSeek-V2: a joint key/value down-projection to a normed latent, a
shared rotary key, keys and values expanded from the latent). The FFN is
a SwiGLU, dense or a mixture of experts: a softmax router over every
routed expert, the top k by probability (ties to the lower id), their
gates renormalised where `norm_topk_prob` says so, plus the shared
experts. Rotary embeddings rotate the two halves of a head
(`as_run.rope`: "rotate_half").

It reads the configuration's published keys, computes every token of a
sequence (no cache, no slots, all experts available to the router) one
layer at a time over all sequences, drawing each layer's weights from the
seed with `weights.make_group` and freeing them after. Float32 matrix
products run with TF32 off. `precision="fp8"` is the control: every
matrix product whose weights the program serves in bf16 takes its two
operands through float8 e4m3 (a scale per activation row, one per weight
matrix), the nearest precision below bf16; the router and the attention
scores stay float32.

This file imports nothing of the program under test.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import torch

from reference.weights import Leaf, groups, make_group

E4M3_MAX = 448.0


@dataclass(frozen=True)
class Arch:
    layers: int
    d: int
    heads: int
    kv_heads: int
    head_dim: int
    vocab: int
    eps: float
    theta: float
    qk_norm: bool
    mla: Optional[Tuple[int, int, int, int]]   # (R, nope, rope, v)
    experts: int
    top_k: int
    norm_topk: bool
    d_expert: int
    shared: int
    dense_layers: int
    d_dense: int


def arch_of(conf: dict) -> Arch:
    """The architecture a configuration file states (published keys, as
    the program runs them, and `as_run` for what they leave open)."""
    as_run = conf.get("as_run", {})
    if conf.get("rope_scaling") not in (None, {}):
        raise ValueError("the reference has no rope scaling")
    if as_run.get("rope", "rotate_half") != "rotate_half":
        raise ValueError(f"unknown rope pairing {as_run.get('rope')!r}")
    d = int(conf["hidden_size"])
    heads = int(conf["num_attention_heads"])
    mla = None
    if conf.get("kv_lora_rank"):
        if conf.get("q_lora_rank"):
            raise ValueError("the reference has no query LoRA")
        mla = (int(conf["kv_lora_rank"]), int(conf["qk_nope_head_dim"]),
               int(conf["qk_rope_head_dim"]), int(conf["v_head_dim"]))
    experts = int(conf.get("n_routed_experts") or conf["num_experts"])
    d_expert = int(conf.get("moe_intermediate_size")
                   or conf["intermediate_size"])
    dense_layers = int(conf.get("first_k_dense_replace") or 0)
    return Arch(
        layers=int(conf["num_hidden_layers"]), d=d, heads=heads,
        kv_heads=int(conf.get("num_key_value_heads") or heads),
        head_dim=d // heads, vocab=int(conf["vocab_size"]),
        eps=float(conf["rms_norm_eps"]), theta=float(conf["rope_theta"]),
        qk_norm=as_run.get("qk_norm") == "per_head", mla=mla,
        experts=experts, top_k=int(conf["num_experts_per_tok"]),
        norm_topk=bool(conf.get("norm_topk_prob", False)),
        d_expert=d_expert, shared=int(conf.get("n_shared_experts") or 0),
        dense_layers=dense_layers,
        d_dense=int(conf["intermediate_size"]) if dense_layers else 0)


def layout(a: Arch) -> List[Leaf]:
    """Every weight's (path, shape, dtype), by the program's names."""
    bf, f32 = torch.bfloat16, torch.float32
    d, H = a.d, a.heads
    out: List[Leaf] = [("embed", (a.vocab, d), bf), ("final_norm", (d,), bf),
                       ("lm_head", (d, a.vocab), bf)]
    for i in range(a.layers):
        p = f"layers.{i}."
        out.append((p + "pre_norm", (d,), bf))
        if a.mla:
            R, nope, rope_d, v = a.mla
            out += [(p + "attn.wq", (d, H, nope + rope_d), bf),
                    (p + "attn.wkv_a", (d, R + rope_d), bf),
                    (p + "attn.kv_a_norm", (R,), bf),
                    (p + "attn.wkv_b", (R, H, nope + v), bf),
                    (p + "attn.wo", (H, v, d), bf)]
        else:
            D, Hk = a.head_dim, a.kv_heads
            out += [(p + "attn.wq", (d, H, D), bf),
                    (p + "attn.wk", (d, Hk, D), bf),
                    (p + "attn.wv", (d, Hk, D), bf),
                    (p + "attn.wo", (H, D, d), bf)]
            if a.qk_norm:
                out += [(p + "attn.q_norm", (D,), bf),
                        (p + "attn.k_norm", (D,), bf)]
        out.append((p + "ffn_norm", (d,), bf))
        if i < a.dense_layers:
            f = a.d_dense
            out += [(p + "ffn.w_gate", (d, f), bf), (p + "ffn.w_up", (d, f), bf),
                    (p + "ffn.w_down", (f, d), bf)]
            continue
        E, f = a.experts, a.d_expert
        out += [(p + "moe.router", (d, E), f32),
                (p + "moe.w_gate", (E, d, f), bf),
                (p + "moe.w_up", (E, d, f), bf),
                (p + "moe.w_down", (E, f, d), bf)]
        if a.shared:
            fs = a.shared * f
            out += [(p + "moe.shared.w_gate", (d, fs), bf),
                    (p + "moe.shared.w_up", (d, fs), bf),
                    (p + "moe.shared.w_down", (fs, d), bf)]
    return out


# -- arithmetic ---------------------------------------------------------------

def _q8(t: torch.Tensor, dim: Optional[int]) -> torch.Tensor:
    """t through float8 e4m3 and back, scaled so its largest magnitude
    (along `dim`, or over all of t) maps to e4m3's largest."""
    amax = (t.abs().amax() if dim is None
            else t.abs().amax(dim=dim, keepdim=True))
    scale = torch.clamp(amax, min=1e-12) / E4M3_MAX
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


class _Ops:
    def __init__(self, precision: str):
        if precision not in ("fp32", "fp8"):
            raise ValueError(f"unknown precision {precision!r}")
        self.fp8 = precision == "fp8"

    def lin(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """x (N, a) @ w (a, ...) in float32, or through e4m3."""
        w2 = w.float().reshape(w.shape[0], -1)
        if self.fp8:
            x, w2 = _q8(x, -1), _q8(w2, None)
        return (x @ w2).reshape(x.shape[0], *w.shape[1:])


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w.float()


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x (T, H, D) at positions pos (T,): the halves of each head rotate."""
    half = x.shape[-1] // 2
    freq = theta ** (-torch.arange(half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = pos.float()[:, None] * freq
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attend(q, k, v, scale: float) -> torch.Tensor:
    """Causal softmax attention. q (T, H, Dk), k (T, Hk, Dk), v (T, Hk, Dv)
    -> (T, H, Dv), a query head h reading kv head h // (H / Hk)."""
    T, H, _ = q.shape
    g = H // k.shape[1]
    k = k.repeat_interleave(g, dim=1)
    v = v.repeat_interleave(g, dim=1)
    s = torch.einsum("qhd,khd->hqk", q, k) * scale
    mask = torch.ones(T, T, dtype=torch.bool, device=q.device).tril()
    s = s.masked_fill(~mask, float("-inf"))
    return torch.einsum("hqk,khd->qhd", torch.softmax(s, dim=-1), v)


def _gqa(a: Arch, w, p: str, h: torch.Tensor, ops: _Ops) -> torch.Tensor:
    T = h.shape[0]
    pos = torch.arange(T, device=h.device)
    q = ops.lin(h, w[p + "attn.wq"])
    k = ops.lin(h, w[p + "attn.wk"])
    v = ops.lin(h, w[p + "attn.wv"])
    if a.qk_norm:
        q = rms_norm(q, w[p + "attn.q_norm"], a.eps)
        k = rms_norm(k, w[p + "attn.k_norm"], a.eps)
    q, k = rope(q, pos, a.theta), rope(k, pos, a.theta)
    o = _attend(q, k, v, a.head_dim ** -0.5)
    return ops.lin(o.reshape(T, -1), w[p + "attn.wo"].reshape(-1, a.d))


def _mla(a: Arch, w, p: str, h: torch.Tensor, ops: _Ops) -> torch.Tensor:
    R, nope, rope_d, vd = a.mla
    T = h.shape[0]
    pos = torch.arange(T, device=h.device)
    q = ops.lin(h, w[p + "attn.wq"])                      # (T, H, nope+rope)
    q = torch.cat([q[..., :nope], rope(q[..., nope:], pos, a.theta)], -1)
    kv_a = ops.lin(h, w[p + "attn.wkv_a"])                # (T, R + rope)
    c = rms_norm(kv_a[:, :R], w[p + "attn.kv_a_norm"], a.eps)
    k_pe = rope(kv_a[:, None, R:], pos, a.theta)          # (T, 1, rope)
    kv = ops.lin(c, w[p + "attn.wkv_b"])                  # (T, H, nope+v)
    k = torch.cat([kv[..., :nope], k_pe.expand(T, a.heads, rope_d)], -1)
    o = _attend(q, k, kv[..., nope:], (nope + rope_d) ** -0.5)
    return ops.lin(o.reshape(T, -1), w[p + "attn.wo"].reshape(-1, a.d))


def _swiglu(x, wg, wu, wd, ops: _Ops) -> torch.Tensor:
    return ops.lin(torch.nn.functional.silu(ops.lin(x, wg)) * ops.lin(x, wu),
                   wd)


def _moe(a: Arch, w, p: str, x: torch.Tensor, ops: _Ops) -> torch.Tensor:
    """x (N, d): every token routed over all experts; each expert computes
    its tokens; each token's k contributions summed in a fixed order."""
    N = x.shape[0]
    probs = torch.softmax(x @ w[p + "moe.router"].float(), dim=-1)
    gates, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, ids = gates[:, :a.top_k], ids[:, :a.top_k]
    if a.norm_topk:
        gates = gates / gates.sum(-1, keepdim=True)
    flat = ids.reshape(-1)
    order = torch.argsort(flat, stable=True)
    counts = torch.bincount(flat, minlength=a.experts).tolist()
    rows = torch.empty(N * a.top_k, a.d, dtype=torch.float32,
                       device=x.device)
    tok = order // a.top_k
    start = 0
    for e, n in enumerate(counts):
        if n:
            sel = order[start:start + n]
            rows[sel] = _swiglu(x[tok[start:start + n]],
                                w[p + "moe.w_gate"][e], w[p + "moe.w_up"][e],
                                w[p + "moe.w_down"][e], ops)
            start += n
    contrib = rows.reshape(N, a.top_k, a.d) * gates[..., None]
    out = contrib[:, 0]
    for j in range(1, a.top_k):
        out = out + contrib[:, j]
    if a.shared:
        out = out + _swiglu(x, w[p + "moe.shared.w_gate"],
                            w[p + "moe.shared.w_up"],
                            w[p + "moe.shared.w_down"], ops)
    return out


@contextlib.contextmanager
def _no_tf32() -> Iterator[None]:
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def logits_at(conf: dict, seed: int, seqs: Sequence[torch.Tensor],
              positions: Sequence[torch.Tensor], device,
              precision: str = "fp32") -> List[torch.Tensor]:
    """For each token sequence (T_i,), its logits (len(positions_i), V),
    float32, at `positions_i`: the logits that predict the token after
    each of those positions."""
    a = arch_of(conf)
    ops = _Ops(precision)
    lay = groups(layout(a))
    with torch.no_grad(), _no_tf32():
        top = make_group(seed, "top", lay["top"], device, a.layers)
        hs = [top["embed"][s.to(device)].float() for s in seqs]
        del top
        for i in range(a.layers):
            w: Dict[str, torch.Tensor] = {}
            for g in ("rest", "router", "experts"):
                key = f"layers.{i}.{g}"
                if key in lay:
                    w.update(make_group(seed, key, lay[key], device,
                                          a.layers))
            p = f"layers.{i}."
            mix = _mla if a.mla else _gqa
            hs = [h + mix(a, w, p, rms_norm(h, w[p + "pre_norm"], a.eps), ops)
                  for h in hs]
            sizes = [h.shape[0] for h in hs]
            x = torch.cat(hs)
            n = rms_norm(x, w[p + "ffn_norm"], a.eps)
            if i < a.dense_layers:
                x = x + _swiglu(n, w[p + "ffn.w_gate"], w[p + "ffn.w_up"],
                                w[p + "ffn.w_down"], ops)
            else:
                x = x + _moe(a, w, p, n, ops)
            hs = list(torch.split(x, sizes))
            del w, x, n
        top = make_group(seed, "top", lay["top"], device, a.layers)
        out = []
        for h, pos in zip(hs, positions):
            hn = rms_norm(h[pos.to(device)], top["final_norm"], a.eps)
            out.append(ops.lin(hn, top["lm_head"]))
        return out
