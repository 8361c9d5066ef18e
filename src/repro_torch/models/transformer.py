"""Decoder stack of every architecture the reference runs. A layer's
mixer is GQA (or MHA) or MLA attention, global or sliding-window, with
logit soft-caps and post-norms (gemma2); recurrentgemma's RG-LRU block
(`models.recurrent`); or xLSTM's mLSTM / sLSTM block (`models.xlstm`).
Whisper's decoder layers add cross-attention to the encoder's output
(`Model.encode`) and its embeddings sinusoidal absolute positions. The
FFN is a MoE (routed experts, optionally shared experts) or a dense gated
FFN (SwiGLU; GELU-gated for the encoder-decoder); embeddings tied or
untied; inputs tokens or input embeddings (llava).

The port's parameter tree is flat: ``{"embed", "final_norm", ["lm_head"],
"layers": [one dict per absolute layer], ["encoder": {"layers": [...],
"final_norm"}]}`` (no ``lm_head`` when the embeddings are tied) — the
reference's stacked ``unit`` lists and encoder layers, which it scans for
compile time, are unstacked once, by `repro_torch.bridge` or by
`Model.init`. Per-layer dicts keep the reference's keys and layouts.

Entry points:
- `Model.forward`      full-sequence hidden states (training; `remat=`)
- `Model.prefill`      full-sequence + populated caches
- `Model.decode_step`  one token against the cache
- `Model.encode`       the encoder stack (whisper)
used by `runtime.engine`: `layer_forward`, `layer_prefill`,
`layer_prefill_chunk`, `layer_decode` (each also works on FFN-stripped params from
`split_ffn_params`), `init_layer_cache` and `Model.embed` / `Model.logits`.
Decode never writes a cache in place: each step returns new cache tensors,
so a saved state stays valid (decode rollback and branching rely on it).
`layer_prefill_chunk` does write in place, into caches that belong to one
prefill cursor and are copied when the prompt is committed to a batch row.
Attention layers decode through their decode kernel (`use_kernel=True`);
the recurrent mixers and cross-attention run plain PyTorch on every
device, as the reference computes them outside its kernels.

On a mesh (`distributed.sharding.mesh_context`, params from
`distribute_params`, inputs DTensors sharded over the batch axes) the
same entry points run SPMD, with the reference's sharding hooks at its
sites (`gather_for_compute` at each layer's entry, `constrain` on the
residual stream). Each mixer and FFN runs as a region on local shards
(`sharding.region`): attention over the rank's heads, a dense FFN over its
hidden units, each all-reduced over ``model``; the MoE FFN expert-parallel
(`moe._moe_mesh`); the embedding vocab-parallel. The recurrent mixers and
cross-attention have no tensor-parallel rule here: their weights are
gathered over ``model`` first. Without a mesh nothing of this runs.
"""
from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.sharding import BATCH, Out
from repro_torch.kernels.decode_superkernel import fused_decode_attention
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import recurrent as rec_mod
from repro_torch.models import xlstm as xlstm_mod
from repro_torch.models.layers import (dense_init, embed_init, rms_norm,
                                       softcap, swiglu)


class LayerSpec(NamedTuple):
    kind: str          # attn | rec | mlstm | slstm
    window: int        # sliding window (0 = global)
    is_moe: bool       # MoE FFN; otherwise a dense SwiGLU FFN
    layer_idx: int     # absolute depth index (first occurrence)


# Parameter keys that belong to a layer's FFN half.
FFN_PARAM_KEYS = ("ffn_norm", "moe", "ffn", "post_ffn_norm")


def split_ffn_params(p, spec: LayerSpec):
    """(attention-only params, FFN-stripped spec) for a layer param dict."""
    stripped = {k: v for k, v in p.items() if k not in FFN_PARAM_KEYS}
    return stripped, LayerSpec(spec.kind, spec.window, False, spec.layer_idx)


def build_layout(cfg: ModelConfig):
    """Layout: (prefix, unit, num_units, tail) — the reference's pattern
    decomposition (prefix = leading aperiodic layers, unit = smallest
    repeating pattern, tail = remainder)."""
    kinds = [cfg.layer_kind(i) for i in range(cfg.num_layers)]
    windows = [cfg.attn_window(i) if kinds[i] == "attn" else 0
               for i in range(cfg.num_layers)]
    moes = [cfg.is_moe_layer(i) for i in range(cfg.num_layers)]
    specs = [LayerSpec(kinds[i], windows[i], moes[i], i)
             for i in range(cfg.num_layers)]
    prefix: List[LayerSpec] = []
    if cfg.moe is not None and cfg.moe.first_dense_layers:
        prefix = specs[:cfg.moe.first_dense_layers]
        specs = specs[cfg.moe.first_dense_layers:]

    def key(s: LayerSpec):
        return (s.kind, s.window, s.is_moe)

    n = len(specs)
    period = max(n, 1)
    for p in range(1, n + 1):
        k = n // p
        if k >= 1 and all(key(specs[i]) == key(specs[i % p])
                          for i in range(k * p)):
            period = p
            break
    num_units = n // period if n else 0
    unit = specs[:period] if n else []
    tail = specs[num_units * period:]
    return prefix, unit, num_units, tail


def all_specs(cfg: ModelConfig) -> List[LayerSpec]:
    """One spec per absolute layer, in depth order."""
    prefix, unit, num_units, tail = build_layout(cfg)
    return list(prefix) + list(unit) * num_units + list(tail)


def _zc(cfg: ModelConfig) -> bool:
    """Gemma-family norms are zero-centred ((1 + w) x̂) and its embeddings
    scaled by sqrt(d)."""
    return cfg.name.startswith(("gemma", "recurrentgemma"))


def _norm(x: torch.Tensor, w: torch.Tensor, cfg: ModelConfig):
    return rms_norm(x, w, cfg.norm_eps, zero_centered=_zc(cfg))


def _ring_size(spec: LayerSpec, max_seq: int) -> int:
    """Rows of a GQA layer's K/V ring: a window layer keeps its window."""
    return min(max_seq, spec.window) if spec.window else max_seq


ENCODER_SPEC = LayerSpec("attn", 0, False, 0)   # every encoder layer's


def sinusoidal_pos(positions: torch.Tensor, d_model: int) -> torch.Tensor:
    """Sinusoidal absolute position embedding, fp32. positions: (...,)
    integer -> (..., d_model): [sin, cos] halves."""
    half = d_model // 2
    dev = positions.device
    log_base = torch.log(torch.tensor(10000.0, device=dev))
    freq = torch.exp(-log_base * torch.arange(half, dtype=torch.float32,
                                              device=dev) / half)
    ang = positions[..., None].float() * freq
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ---------------------------------------------------------------------------
# Per-layer parameter init
# ---------------------------------------------------------------------------

def init_layer(cfg: ModelConfig, spec: LayerSpec, dtype,
               with_cross: Optional[bool] = None, **kw):
    """One layer's params; `kw` carries `generator` and `device`.
    `with_cross` (default: the model is an encoder-decoder) adds the
    cross-attention and its norm."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    dev = kw.get("device", "cpu")
    ones = lambda: torch.ones((d,), dtype=dtype, device=dev)  # noqa: E731
    p: Dict[str, Any] = {"pre_norm": ones()}
    if spec.kind == "attn" and cfg.attention == "mla":
        p["attn"] = attn_mod.init_mla_params(d, cfg.num_heads, cfg.mla,
                                             dtype, **kw)
    elif spec.kind == "attn":
        p["attn"] = attn_mod.init_gqa_params(
            d, cfg.num_heads, cfg.num_kv_heads, hd, dtype,
            qk_norm=cfg.qk_norm, **kw)
    elif spec.kind == "rec":
        p["rec"] = rec_mod.init_rglru_block(d, cfg.lru_width or d,
                                            cfg.conv1d_width, dtype, **kw)
    elif spec.kind == "mlstm":
        p["mix"] = xlstm_mod.init_mlstm_block(d, cfg.num_heads,
                                              cfg.proj_factor, dtype, **kw)
    elif spec.kind == "slstm":
        p["mix"] = xlstm_mod.init_slstm_block(d, cfg.num_heads,
                                              cfg.proj_factor, dtype, **kw)
    else:
        raise ValueError(spec.kind)
    if cfg.is_encoder_decoder if with_cross is None else with_cross:
        p["cross_norm"] = ones()
        p["cross"] = attn_mod.init_gqa_params(d, cfg.num_heads,
                                              cfg.num_kv_heads, hd, dtype,
                                              **kw)
    has_ffn = spec.is_moe or cfg.d_ff > 0
    if has_ffn:
        p["ffn_norm"] = ones()
        if spec.is_moe:
            p["moe"] = moe_mod.init_moe_params(d, cfg.moe, dtype, **kw)
        else:
            p["ffn"] = {"w_gate": dense_init(d, cfg.d_ff, dtype, **kw),
                        "w_up": dense_init(d, cfg.d_ff, dtype, **kw),
                        "w_down": dense_init(cfg.d_ff, d, dtype, **kw)}
    if cfg.attn_logit_softcap > 0:   # gemma-2 family: post-norms too
        p["post_attn_norm"] = ones()
        if has_ffn:
            p["post_ffn_norm"] = ones()
    return p


# ---------------------------------------------------------------------------
# Per-layer forward (train / prefill path)
# ---------------------------------------------------------------------------

def _ffn_part(p, cfg: ModelConfig, x: torch.Tensor,
              capacity: Optional[int] = None,
              router_sink: Optional[list] = None) -> torch.Tensor:
    """x + FFN: MoE (capacity-buffer grouped over the layer's own experts,
    shared experts included) or dense SwiGLU, then the post-FFN norm where
    the layer has one. x: (B, T, d). FFN-stripped params pass x through. A
    MoE layer without a `capacity` appends its router output (every
    token's) to `router_sink` when one is given."""
    if "ffn_norm" not in p:
        return x
    h2 = _norm(x, p["ffn_norm"], cfg)
    if "ffn" in p:
        f = p["ffn"]
        act = "gelu" if cfg.family == "encdec" else "silu"
        ff = swiglu(h2, f["w_gate"], f["w_up"], f["w_down"], act=act)
    elif capacity is None:
        ff, r = moe_mod.moe_grouped(p["moe"], h2, cfg.moe)
        if router_sink is not None:
            router_sink.append(r)
    else:
        B = x.shape[0]
        out, _ = moe_mod.moe_grouped(p["moe"], h2.reshape(B, -1), cfg.moe,
                                     capacity=capacity)
        ff = out.reshape(B, 1, -1)
    if "post_ffn_norm" in p:
        ff = _norm(ff, p["post_ffn_norm"], cfg)
    return shd.constrain(x + ff, ("data", None, None))


def _post_attn(p, cfg: ModelConfig, x: torch.Tensor,
               mix: torch.Tensor) -> torch.Tensor:
    """x + the mixer's output, through the post-attention norm where the
    layer has one."""
    if "post_attn_norm" in p:
        mix = _norm(mix, p["post_attn_norm"], cfg)
    return x + mix


def _mix_prefill(p, cfg: ModelConfig, spec: LayerSpec, h: torch.Tensor,
                 positions: torch.Tensor, causal: bool = True,
                 kv_slice: Optional[slice] = None):
    """The layer's mixer over the whole normed sequence h (B, T, d).
    Returns (mix (B, T, d), what the cache keeps): attention (GQA or MLA,
    the layer's window and soft-cap) its T rows by cache name; a recurrent
    mixer its final state by cache name. `kv_slice`: the K/V heads the
    attention reads (a rank's query heads on a mesh, `_kv_slice`); the
    cache rows keep all of them."""
    if shd.is_dtensor(h):
        return _mix_prefill_mesh(p, cfg, spec, h, positions, causal)
    if spec.kind == "rec":
        mix, conv, rec = rec_mod.rglru_block(p["rec"], h)
        return mix, {"conv": conv, "rec": rec}
    if spec.kind == "mlstm":
        mix, st = xlstm_mod.mlstm_block(p["mix"], h, cfg.num_heads)
        return mix, st._asdict()
    if spec.kind == "slstm":
        mix, st = xlstm_mod.slstm_block(p["mix"], h, cfg.num_heads)
        return mix, st._asdict()
    if spec.kind != "attn":
        raise ValueError(spec.kind)
    if cfg.attention == "mla":
        q, k, v, (c_kv, k_pe) = attn_mod._mla_qkv(
            p["attn"], h, positions, cfg.mla, cfg.rope_theta, cfg.norm_eps)
        rows = {"latent": c_kv, "pe": k_pe}
        # q's width is nope + rope, so flash_attention's q-width ** -0.5
        # is MLA's scale; v (v_head_dim) may be narrower than q and k
        mix = attn_mod.flash_attention(q, k, v, causal=causal,
                                       window=spec.window)
    else:
        q = attn_mod.gqa_project_q(p["attn"], h, positions, cfg.rope_theta,
                                   cfg.norm_eps)
        k, v = attn_mod.gqa_project_kv(p["attn"], h, positions,
                                       cfg.rope_theta, cfg.norm_eps)
        rows = {"k": k, "v": v}
        if kv_slice is not None:
            k, v = k[:, :, kv_slice], v[:, :, kv_slice]
        mix = attn_mod.flash_attention(q, k, v, causal=causal,
                                       window=spec.window,
                                       logit_softcap=cfg.attn_logit_softcap)
    return attn_mod.gqa_out(p["attn"], mix), rows


# ---------------------------------------------------------------------------
# The mixers on a mesh
# ---------------------------------------------------------------------------

def _mixer_params(p):
    return {k: p[k] for k in ("attn", "rec", "mix") if k in p}


def _kv_slice(attn) -> Tuple[bool, Optional[slice]]:
    """(tensor-parallel, kv heads) of an attention layer on a mesh. Its
    query heads (wq / wq_b, wo) are sharded over ``model`` when they divide;
    GQA K/V heads when theirs do too. Query heads sharded without their
    K/V heads read the slice of K/V heads their group needs; a split that
    leaves no whole groups gathers the weights instead (not
    tensor-parallel)."""
    q_sharded = shd.model_dim(attn["wo"]) == 0
    if not q_sharded or "wk" not in attn or shd.model_dim(attn["wk"]) == 1:
        return True, None
    mesh = attn["wo"].device_mesh
    m, r = shd.axis_size(mesh, "model"), shd.model_rank(mesh)
    H, Hkv = attn["wo"].shape[0], attn["wk"].shape[1]
    G, hl = H // Hkv, H // m
    if hl % G and G % hl:
        return False, None
    return True, slice(r * hl // G, ((r + 1) * hl - 1) // G + 1)


def _mix_out(cfg: ModelConfig, spec: LayerSpec, p, tp: bool):
    """The region outputs of a mixer: (mix, its cache rows)."""
    if spec.kind != "attn":
        return Out((BATCH,)), Out((BATCH,))
    attn = p["attn"]
    partial = tp and shd.model_dim(attn["wo"]) == 0
    heads = "model" if tp and cfg.attention != "mla" and \
        shd.model_dim(attn["wk"]) == 1 else None
    return Out((BATCH,), partial), Out((BATCH, None, heads))


def _mix_prefill_mesh(p, cfg, spec, h, positions, causal):
    tp, kvs = _kv_slice(p["attn"]) if spec.kind == "attn" else (False, None)
    return shd.region(
        lambda p_, h_, pos_: _mix_prefill(p_, cfg, spec, h_, pos_, causal,
                                          kvs),
        _mixer_params(p), h, positions, like=h,
        out=_mix_out(cfg, spec, p, tp), tp=tp)


def _cross_kv(p, enc_out: torch.Tensor):
    """The cross-attention's K/V of the encoder output (B, S, d)."""
    if shd.is_dtensor(enc_out):
        return shd.region(lambda c, e: _cross_kv({"cross": c}, e),
                          p["cross"], enc_out, like=enc_out,
                          out=Out((BATCH,)), tp=False)
    return (torch.einsum("bsd,dhk->bshk", enc_out, p["cross"]["wk"]),
            torch.einsum("bsd,dhk->bshk", enc_out, p["cross"]["wv"]))


def _cross_part(p, cfg: ModelConfig, x: torch.Tensor, xk, xv,
                enc_pos) -> torch.Tensor:
    """x + cross-attention (bidirectional, no rope) of x's rows over the
    encoder's K/V; its norm is never zero-centred."""
    if shd.is_dtensor(x):
        return shd.region(
            lambda c, n, x_, k_, v_, e_: _cross_part(
                {"cross": c, "cross_norm": n}, cfg, x_, k_, v_, e_),
            p["cross"], p["cross_norm"], x, xk, xv, enc_pos, like=x,
            out=Out((BATCH,)), tp=False)
    hc = rms_norm(x, p["cross_norm"], cfg.norm_eps)
    return x + attn_mod.gqa_attention(
        p["cross"], hc, positions=enc_pos, rope_theta=0.0, causal=False,
        kv_override=(xk, xv, enc_pos))


def layer_forward(p, cfg: ModelConfig, spec: LayerSpec, x: torch.Tensor,
                  positions: torch.Tensor, *, causal: bool = True,
                  enc_out: Optional[torch.Tensor] = None,
                  enc_pos: Optional[torch.Tensor] = None,
                  router_sink: Optional[list] = None) -> torch.Tensor:
    """Full-sequence layer (train / prefill without a cache). x: (B, T,
    d). `causal=False` for the encoder; `enc_out` (B, S, d) / `enc_pos`
    (B, S) feed a decoder layer's cross-attention."""
    p = shd.gather_for_compute(p)   # FSDP: weight all-gather
    mix, _ = _mix_prefill(p, cfg, spec, _norm(x, p["pre_norm"], cfg),
                          positions, causal)
    x = shd.constrain(_post_attn(p, cfg, x, mix), ("data", None, None))
    if enc_out is not None and "cross" in p:
        x = _cross_part(p, cfg, x, *_cross_kv(p, enc_out), enc_pos)
    return _ffn_part(p, cfg, x, router_sink=router_sink)


# ---------------------------------------------------------------------------
# Caches
# ---------------------------------------------------------------------------

def init_layer_cache(cfg: ModelConfig, spec: LayerSpec, batch: int,
                     max_seq: int, dtype, device="cpu", src_len: int = 0):
    """GQA: a K/V ring {"k", "v"} (B, size, Hkv, D), size = max_seq, or
    the window for a window layer when that is smaller. MLA: the
    positional compressed cache {"latent": (B, S, R), "pe": (B, S, 1, P)}.
    RG-LRU: {"conv": (B, K-1, W), "rec": (B, W) fp32}; mLSTM / sLSTM their
    fp32 states, m at -1e30. An encoder-decoder layer adds the cross K/V
    {"xk", "xv"} (B, src_len, Hkv, D) when `src_len` is given."""
    z = lambda *s, dt=dtype: torch.zeros(  # noqa: E731
        s, dtype=dt, device=device)
    H, hd = cfg.num_heads, cfg.resolved_head_dim
    if spec.kind == "rec":
        w = cfg.lru_width or cfg.d_model
        c = {"conv": z(batch, cfg.conv1d_width - 1, w),
             "rec": z(batch, w, dt=torch.float32)}
    elif spec.kind == "mlstm":
        D = int(cfg.d_model * cfg.proj_factor) // H
        c = xlstm_mod.mlstm_zero_state(batch, H, D, device)._asdict()
    elif spec.kind == "slstm":
        c = xlstm_mod.slstm_zero_state(batch, H, cfg.d_model // H,
                                       device)._asdict()
    elif cfg.attention == "mla":
        c = {"latent": z(batch, max_seq, cfg.mla.kv_lora_rank),
             "pe": z(batch, max_seq, 1, cfg.mla.qk_rope_head_dim)}
    else:
        shape = (batch, _ring_size(spec, max_seq), cfg.num_kv_heads, hd)
        c = {"k": z(*shape), "v": z(*shape)}
    if cfg.is_encoder_decoder and src_len:
        c["xk"] = z(batch, src_len, cfg.num_kv_heads, hd)
        c["xv"] = z(batch, src_len, cfg.num_kv_heads, hd)
    return c


def layer_prefill(p, cfg: ModelConfig, spec: LayerSpec, x: torch.Tensor,
                  positions: torch.Tensor, max_seq: int, *,
                  enc_out: Optional[torch.Tensor] = None,
                  enc_pos: Optional[torch.Tensor] = None,
                  router_sink: Optional[list] = None):
    """Like layer_forward but also returns a populated cache entry. A GQA
    ring the prompt fills (T >= its size) keeps the last `size` rows, row
    at position t in slot t % size (the ring decode continues); a
    recurrent mixer keeps its state after the prompt; a decoder layer with
    `enc_out` keeps the cross K/V {"xk", "xv"}."""
    p = shd.gather_for_compute(p)
    mix, rows = _mix_prefill(p, cfg, spec, _norm(x, p["pre_norm"], cfg),
                             positions)
    x = shd.constrain(_post_attn(p, cfg, x, mix), ("data", None, None))
    cache = _cache_of_rows(cfg, spec, rows, max_seq) \
        if spec.kind == "attn" else rows
    if enc_out is not None and "cross" in p:
        cache["xk"], cache["xv"] = _cross_kv(p, enc_out)
        x = _cross_part(p, cfg, x, cache["xk"], cache["xv"], enc_pos)
    return _ffn_part(p, cfg, x, router_sink=router_sink), cache


def _cache_of_rows(cfg: ModelConfig, spec: LayerSpec, rows, max_seq: int):
    """An attention layer's cache holding a prompt's K/V (or latent) rows
    (B, T, ...): a GQA ring the prompt fills keeps its last rows, row t in
    slot t % size. On a mesh, built from each rank's rows."""
    first = next(iter(rows.values()))
    if shd.is_dtensor(first):
        return shd.region(
            lambda r: _cache_of_rows(cfg, spec, r, max_seq), rows,
            like=first, out={n: Out(shd.spec_of(r)) for n, r in rows.items()})
    B, T = first.shape[:2]
    cache = init_layer_cache(cfg, spec, B, max_seq, first.dtype,
                             first.device)
    for name, r in rows.items():
        size = cache[name].shape[1]
        if T >= size and name in ("k", "v"):
            slots = torch.arange(T - size, T, device=r.device) % size
            cache[name][:, slots] = r[:, T - size:]
        else:
            cache[name][:, :T] = r
    return cache


def layer_prefill_chunk(p, cfg: ModelConfig, spec: LayerSpec,
                        x: torch.Tensor, positions: torch.Tensor, cache,
                        cache_len: int, n_valid: int):
    """One padded prompt chunk through a layer, resuming at `cache_len`.

    x: (B, C, d) chunk whose first `n_valid` rows are real tokens (the rest
    padding: their K/V are not written and their outputs are garbage the
    caller ignores); positions: (B, C) absolute; cache: this layer's cache
    (from `init_layer_cache`, holding the earlier chunks), which the real
    rows are written into IN PLACE — it belongs to one prefill cursor.
    Returns (x, cache). Chunks address the cache by absolute position, so
    only global self-attention layers take them: recurrent mixers (which
    carry their state through the whole prompt), sliding windows and
    cross-attention layers raise."""
    if spec.kind != "attn":
        raise NotImplementedError(
            f"chunked prefill supports attention layers only, got {spec.kind}")
    if spec.window:
        raise NotImplementedError(
            "chunked prefill requires global attention (ring-wrapped sliding-"
            "window caches lose the absolute positions chunks address)")
    if "cross" in p:
        raise NotImplementedError(
            "chunked prefill takes no cross-attention layer")
    p = shd.gather_for_compute(p)
    h = _norm(x, p["pre_norm"], cfg)
    if cfg.attention == "mla":
        mix, _, _ = attn_mod.mla_prefill_chunk(
            p["attn"], h, positions, cache["latent"], cache["pe"], cache_len,
            n_valid, mla=cfg.mla, rope_theta=cfg.rope_theta,
            norm_eps=cfg.norm_eps)
    else:
        mix, _, _ = attn_mod.gqa_prefill_chunk(
            p["attn"], h, positions, cache["k"], cache["v"], cache_len,
            n_valid, rope_theta=cfg.rope_theta,
            logit_softcap=cfg.attn_logit_softcap, norm_eps=cfg.norm_eps)
    x = shd.constrain(_post_attn(p, cfg, x, mix), ("data", None, None))
    return _ffn_part(p, cfg, x), cache


def attn_decode(p, cfg: ModelConfig, spec: LayerSpec, x: torch.Tensor,
                cache, cache_len: torch.Tensor, use_kernel: bool = False,
                max_len: Optional[int] = None,
                kv_slice: Optional[slice] = None):
    """The attention half of a one-token layer step on the layer's input x
    (B, 1, d). Returns (out (B, 1, d), new_cache): the attention's output
    after the pre-norm and the output projection, before the post-norm and
    the residual add.

    `cache_len` is a () tensor (all rows at one position) or a (B,) tensor
    (each row at its own position). GQA: the new token's K/V goes to ring
    slot `cache_len % size` of each row (a window layer's ring is its
    window, so it attends to the last `size` positions); MLA: its latent /
    rope-key row goes to position `cache_len` (no ring). Either way into
    NEW cache tensors: the input cache is left as it was.

    `use_kernel=True` runs the insert and the attention in one
    `fused_decode_attention` (GQA) or `fused_mla_decode_attention` (MLA)
    call, which writes the new caches itself (on CPU tensors the wrapper
    runs its plain version); `max_len`, a host int that bounds every
    `cache_len`, lets the MLA kernel's wrapper check the room in the cache
    without reading the lengths from the device. `kv_slice` (GQA on a
    mesh, `_kv_slice`): the K/V heads this rank's query heads read; the
    attention reads contiguous copies of those heads (through the kernel
    when `use_kernel`), and the new row still goes into every head of the
    cache."""
    if shd.is_dtensor(x):
        return _attn_decode_mesh(p, cfg, spec, x, cache, cache_len,
                                 use_kernel, max_len)
    B = x.shape[0]
    h = _norm(x, p["pre_norm"], cfg)
    if cfg.attention == "mla":
        out, lat, pe = attn_mod.mla_decode(
            p["attn"], h, cache["latent"], cache["pe"], cache_len,
            mla=cfg.mla, rope_theta=cfg.rope_theta, norm_eps=cfg.norm_eps,
            use_kernel=use_kernel, max_len=max_len)
        return out, dict(cache, latent=lat, pe=pe)
    size = cache["k"].shape[1]
    clen = cache_len.reshape(-1).expand(B)
    positions = clen[:, None]
    q = attn_mod.gqa_project_q(p["attn"], h, positions, cfg.rope_theta,
                               cfg.norm_eps)
    k, v = attn_mod.gqa_project_kv(p["attn"], h, positions,
                                   cfg.rope_theta, cfg.norm_eps)
    if use_kernel and kv_slice is None:
        mix, kc, vc = fused_decode_attention(
            q.contiguous(), k.contiguous(), v.contiguous(), cache["k"],
            cache["v"], cache_len,
            logit_softcap=cfg.attn_logit_softcap)
        return attn_mod.gqa_out(p["attn"], mix), dict(cache, k=kc, v=vc)
    rows = torch.arange(B, device=x.device)
    slot = torch.remainder(clen, size)
    kc = cache["k"].clone()
    vc = cache["v"].clone()
    kc[rows, slot] = k[:, 0]
    vc[rows, slot] = v[:, 0]
    if use_kernel:
        # the kernel over copies of the rank's K/V heads (it inserts the
        # new row into its copies itself)
        sl = lambda t: t[:, :, kv_slice].contiguous()  # noqa: E731
        mix, _, _ = fused_decode_attention(
            q.contiguous(), sl(k), sl(v), sl(cache["k"]), sl(cache["v"]),
            cache_len, logit_softcap=cfg.attn_logit_softcap)
    else:
        valid = torch.clamp(clen + 1, max=size)
        ka, va = (kc, vc) if kv_slice is None else \
            (kc[:, :, kv_slice], vc[:, :, kv_slice])
        mix = attn_mod.decode_attention(
            q, ka, va, valid, logit_softcap=cfg.attn_logit_softcap)
    return attn_mod.gqa_out(p["attn"], mix), dict(cache, k=kc, v=vc)


def _cache_out(cache, own: Out, names):
    """Region outputs of a layer cache: `own` for the entries the layer's
    mixer writes, each other entry as it came."""
    return {n: own if n in names else
            (Out(shd.spec_of(c)) if shd.is_dtensor(c) else None)
            for n, c in cache.items()}


def _attn_decode_mesh(p, cfg, spec, x, cache, cache_len, use_kernel,
                      max_len):
    """`attn_decode` on a mesh: the rank's heads over its batch rows, the
    cache first laid out as that needs (K/V heads as wk's, the latent
    whole over ``model``)."""
    tp, kvs = _kv_slice(p["attn"])
    mix_out, rows_out = _mix_out(cfg, spec, p, tp)
    own = ("latent", "pe") if cfg.attention == "mla" else ("k", "v")
    cache = {n: shd.relayout(c, rows_out.spec, x) if n in own else c
             for n, c in cache.items()}
    return shd.region(
        lambda p_, x_, c_, l_: attn_decode(p_, cfg, spec, x_, c_, l_,
                                           use_kernel, max_len, kvs),
        {"attn": p["attn"], "pre_norm": p["pre_norm"]}, x, cache, cache_len,
        like=x, out=(mix_out, _cache_out(cache, rows_out, own)), tp=tp)


def _recurrent_decode(p, cfg: ModelConfig, spec: LayerSpec,
                      x: torch.Tensor, cache):
    """The mixer half of a one-token step of a recurrent layer (RG-LRU,
    mLSTM or sLSTM) on the layer's input x (B, 1, d), plain PyTorch.
    Returns (out (B, 1, d) before the residual add, new_cache); the input
    cache is left as it was."""
    if shd.is_dtensor(x):
        own = [n for n in cache if n not in ("xk", "xv")]
        return shd.region(
            lambda p_, x_, c_: _recurrent_decode(p_, cfg, spec, x_, c_),
            {k: p[k] for k in ("pre_norm", "rec", "mix") if k in p}, x,
            cache, like=x,
            out=(Out((BATCH,)), _cache_out(cache, Out((BATCH,)), own)),
            tp=False)
    h = _norm(x, p["pre_norm"], cfg)
    if spec.kind == "rec":
        out, conv, rec = rec_mod.rglru_block(
            p["rec"], h, conv_state=cache["conv"], rec_state=cache["rec"],
            decode=True)
        return out, dict(cache, conv=conv, rec=rec)
    if spec.kind == "mlstm":
        st = xlstm_mod.MLSTMState(cache["c"], cache["n"], cache["m"])
        out, st = xlstm_mod.mlstm_block(p["mix"], h, cfg.num_heads,
                                        state=st, decode=True)
    elif spec.kind == "slstm":
        st = xlstm_mod.SLSTMState(cache["c"], cache["n"], cache["h"],
                                  cache["m"])
        out, st = xlstm_mod.slstm_block(p["mix"], h, cfg.num_heads,
                                        state=st, decode=True)
    else:
        raise ValueError(spec.kind)
    return out, dict(cache, **st._asdict())


def layer_decode(p, cfg: ModelConfig, spec: LayerSpec, x: torch.Tensor,
                 cache, cache_len: torch.Tensor, use_kernel: bool = False,
                 max_len: Optional[int] = None, *,
                 src_len: Optional[int] = None):
    """One-token layer step. x: (B, 1, d). Returns (x, new_cache); the
    attention and its arguments as `attn_decode`, a recurrent mixer as
    `_recurrent_decode`. A decoder layer whose cache holds the cross K/V
    attends to its first `src_len` rows (default: all of them), plain."""
    p = shd.gather_for_compute(p)
    if spec.kind == "attn":
        out, cache = attn_decode(p, cfg, spec, x, cache, cache_len,
                                 use_kernel, max_len)
    else:
        out, cache = _recurrent_decode(p, cfg, spec, x, cache)
    x = shd.constrain(_post_attn(p, cfg, x, out), ("data", None, None))
    if "xk" in cache and "cross" in p:
        slen = cache["xk"].shape[1] if src_len is None else src_len
        x = _cross_decode(p, cfg, x, cache["xk"], cache["xv"], slen)
    return _decode_ffn(p, cfg, x), cache


def _cross_decode(p, cfg: ModelConfig, x: torch.Tensor, xk, xv,
                  src_len: int) -> torch.Tensor:
    """x + the one-token cross-attention over the first `src_len` rows of
    the cached encoder K/V."""
    if shd.is_dtensor(x):
        return shd.region(
            lambda c, n, x_, k_, v_: _cross_decode(
                {"cross": c, "cross_norm": n}, cfg, x_, k_, v_, src_len),
            p["cross"], p["cross_norm"], x, xk, xv, like=x,
            out=Out((BATCH,)), tp=False)
    hc = rms_norm(x, p["cross_norm"], cfg.norm_eps)
    cmix, _, _ = attn_mod.gqa_decode(p["cross"], hc, xk, xv, src_len,
                                     rope_theta=0.0, cross=True)
    return x + cmix


def _decode_ffn(p, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """The FFN half of a one-token step; a MoE layer's capacity is sized to
    the expected load (4x slack), not the worst case."""
    B, m = x.shape[0], cfg.moe
    cap = None if m is None else \
        min(B * m.top_k, max(8, -(-B * m.top_k // m.num_experts) * 4))
    return _ffn_part(p, cfg, x, capacity=cap)


# ---------------------------------------------------------------------------
# Whole model
# ---------------------------------------------------------------------------

class Model:
    """Config-driven LM: embedding, layer specs, LM head, and the encoder
    stack of an encoder-decoder (whisper)."""

    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        self.specs = all_specs(cfg)
        self.dtype = torch.bfloat16 if cfg.dtype == "bfloat16" \
            else torch.float32

    # -- init -----------------------------------------------------------------
    def init(self, generator: Optional[torch.Generator] = None,
             device="cuda") -> Dict[str, Any]:
        """Random params with the reference's init law, drawn on `device`
        from `generator` (which must live on that device). Tied models have
        no `lm_head`: the head is the embedding's transpose."""
        dev = resolve_device(device)
        cfg, dt = self.cfg, self.dtype
        kw = dict(generator=generator, device=dev)
        ones = lambda: torch.ones((cfg.d_model,), dtype=dt,  # noqa: E731
                                  device=dev)
        params: Dict[str, Any] = {
            "embed": embed_init(cfg.vocab_size, cfg.d_model, dt, **kw),
            "final_norm": ones(),
        }
        if not cfg.tie_embeddings:
            params["lm_head"] = dense_init(cfg.d_model, cfg.vocab_size, dt,
                                           **kw)
        params["layers"] = [init_layer(cfg, s, dt, **kw) for s in self.specs]
        if cfg.is_encoder_decoder:
            params["encoder"] = {
                "layers": [init_layer(cfg, ENCODER_SPEC, dt, with_cross=False,
                                      **kw)
                           for _ in range(cfg.encoder_layers)],
                "final_norm": ones()}
        return params

    # -- embedding / head -------------------------------------------------------
    def embed(self, params, tokens: torch.Tensor,
              positions: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Token embeddings; the gemma family scales them by sqrt(d) in the
        params' dtype, as the reference does; with absolute positions
        (whisper) the sinusoids of `positions` (default 0..T-1) are added
        in the params' dtype. On a mesh (DTensor tokens), see
        `_embed_mesh`."""
        if shd.is_dtensor(tokens):
            return self._embed_mesh(params, tokens, positions)
        return self._embed_finish(params["embed"][tokens], positions)

    def _embed_finish(self, x: torch.Tensor,
                      positions: Optional[torch.Tensor]) -> torch.Tensor:
        if _zc(self.cfg):
            x = x * torch.tensor(self.cfg.d_model ** 0.5, dtype=x.dtype,
                                 device=x.device)
        if self.cfg.abs_pos:
            if positions is None:
                positions = torch.arange(x.shape[-2], device=x.device)
            x = x + sinusoidal_pos(positions, self.cfg.d_model).to(x.dtype)
        return x

    def _embed_mesh(self, params, tokens, positions):
        """Vocab-parallel lookup: each rank looks up the tokens in its rows
        of the embedding (sharded over ``model``, gathered over ``data``),
        zeros for the others', and one all-reduce over ``model`` sums the
        rows (exact: one rank holds each). Then the scale and positions."""
        emb = shd.constrain(params["embed"], ("model", None))
        split = shd.model_dim(emb) == 0
        V_loc = emb.to_local().shape[0]
        v0 = shd.model_rank(emb.device_mesh) * V_loc if split else 0

        def rows(e, t):
            inr = (t >= v0) & (t < v0 + V_loc)
            r = e[torch.where(inr, t - v0, torch.zeros_like(t))]
            return torch.where(inr[..., None], r, torch.zeros_like(r))

        x = shd.region(rows, emb, tokens, like=tokens,
                       out=Out((BATCH,), partial=split))
        if positions is not None:
            positions = shd.batch_like(positions, tokens)
        return shd.region(self._embed_finish, x, positions, like=x,
                          out=Out((BATCH,)))

    def final_hidden(self, params, h: torch.Tensor) -> torch.Tensor:
        return _norm(h, params["final_norm"], self.cfg)

    def lm_head_weight(self, params) -> torch.Tensor:
        """(d, V): the embedding's transpose when tied."""
        return params["embed"].T if self.cfg.tie_embeddings \
            else params["lm_head"]

    def logits(self, params, h: torch.Tensor) -> torch.Tensor:
        """Final norm + LM head (+ the final soft-cap); the product rounds
        to the params' dtype before widening to fp32, as the reference's
        does. On a mesh the head is gathered over ``data`` and the logits
        stay sharded over ``model`` by vocabulary."""
        if shd.is_dtensor(h):
            w = shd.constrain(self.lm_head_weight(params), (None, "model"))
            return shd.region(
                lambda h_, w_: softcap((h_ @ w_).float(),
                                       self.cfg.final_logit_softcap),
                self.final_hidden(params, h), w, like=h,
                out=Out((BATCH, "model" if shd.model_dim(w) == 1 else None)))
        out = (self.final_hidden(params, h)
               @ self.lm_head_weight(params)).float()
        return softcap(out, self.cfg.final_logit_softcap)

    # -- encoder (whisper) ------------------------------------------------------
    def encode(self, params, frames: torch.Tensor) -> torch.Tensor:
        """frames: (B, S, d), the frontend's frame embeddings (the mel and
        conv frontend is a stub, as in the reference). The encoder layers
        attend bidirectionally; returns the normed output (B, S, d)."""
        cfg = self.cfg
        enc = params["encoder"]
        B, S, _ = frames.shape
        positions = torch.arange(S, device=frames.device)[None].expand(B, S)
        x = frames
        if shd.is_dtensor(frames):
            positions = shd.batch_like(positions, frames)
            if cfg.abs_pos:
                x = shd.region(
                    lambda f, pos: f + sinusoidal_pos(
                        pos, cfg.d_model).to(f.dtype),
                    frames, positions, like=frames, out=Out((BATCH,)))
        elif cfg.abs_pos:
            x = x + sinusoidal_pos(positions, cfg.d_model).to(x.dtype)
        for lp in enc["layers"]:
            x = layer_forward(lp, cfg, ENCODER_SPEC, x, positions,
                              causal=False)
        return rms_norm(x, enc["final_norm"], cfg.norm_eps)

    def _inputs(self, params, tokens, embeds, enc_out):
        x = self.embed(params, tokens) if embeds is None else embeds
        x = shd.constrain(x, ("data", None, None))
        B, T, _ = x.shape
        positions = torch.arange(T, device=x.device)[None, :].expand(B, T)
        enc = {}
        if enc_out is not None:
            S = enc_out.shape[1]
            enc = {"enc_out": enc_out, "enc_pos": torch.arange(
                S, device=x.device)[None, :].expand(B, S)}
        if shd.is_dtensor(x):
            positions = shd.batch_like(positions, x)
            if enc:
                enc["enc_pos"] = shd.batch_like(enc["enc_pos"], x)
        return x, positions, enc

    # -- full-sequence forward ---------------------------------------------------
    def forward(self, params, tokens: Optional[torch.Tensor] = None, *,
                embeds: Optional[torch.Tensor] = None,
                enc_out: Optional[torch.Tensor] = None,
                remat: bool = False) -> torch.Tensor:
        """Final hidden states (B, T, d), before the final norm. `embeds`
        (B, T, d) stand in for the tokens (llava's backbone); `enc_out`
        (B, S, d), `encode`'s output, feeds the cross-attention;
        `remat=True` recomputes each layer's activations in the backward
        pass (`torch.utils.checkpoint`, one layer a segment)."""
        cfg = self.cfg
        x, positions, enc = self._inputs(params, tokens, embeds, enc_out)
        for p, spec in zip(params["layers"], self.specs):
            if remat and torch.is_grad_enabled():
                x = torch.utils.checkpoint.checkpoint(
                    layer_forward, p, cfg, spec, x, positions,
                    use_reentrant=False, **enc)
            else:
                x = layer_forward(p, cfg, spec, x, positions, **enc)
        return x

    # -- prefill ----------------------------------------------------------------
    def prefill(self, params, tokens: Optional[torch.Tensor] = None, *,
                embeds: Optional[torch.Tensor] = None, max_seq: int,
                enc_out: Optional[torch.Tensor] = None):
        """Run the prompt, returning (last logits (B, V) fp32, cache); the
        cache is {"layers": [one per layer], "len": () int64 tensor}; with
        `enc_out` each layer's cache holds its cross K/V."""
        x, positions, enc = self._inputs(params, tokens, embeds, enc_out)
        caches = []
        for p, spec in zip(params["layers"], self.specs):
            x, c = layer_prefill(p, self.cfg, spec, x, positions, max_seq,
                                 **enc)
            caches.append(c)
        T = x.shape[1]
        return self.logits(params, x[:, -1]), {
            "layers": caches,
            "len": torch.tensor(T, dtype=torch.long, device=x.device)}

    # -- cache allocation ---------------------------------------------------------
    def init_cache(self, batch: int, max_seq: int, device="cuda",
                   src_len: int = 0):
        """An empty cache for decode_step (nothing cached yet); `src_len`
        sizes an encoder-decoder's (zero) cross K/V."""
        dev = resolve_device(device)
        return {"layers": [init_layer_cache(self.cfg, s, batch, max_seq,
                                            self.dtype, dev, src_len)
                           for s in self.specs],
                "len": torch.zeros((), dtype=torch.long, device=dev)}

    # -- decode step ----------------------------------------------------------------
    def decode_step(self, params, token: torch.Tensor, cache, *,
                    src_len: Optional[int] = None):
        """token: (B,) int (or (B, d) embeds) at position `cache["len"]`.
        Returns (logits (B, V) fp32, new cache); the input cache is left as
        it was. Each attention layer's insert and attention run in its
        decode kernel (on CPU tensors, the kernel's plain version); the
        recurrent mixers and cross-attention (over `src_len` source rows,
        default all) run plain."""
        cache_len = cache["len"]
        if token.dim() == 1:
            pos = cache_len.reshape(-1, 1).expand(token.shape[0], 1)
            x = self.embed(params, token[:, None], positions=pos)
        else:
            x = token[:, None, :]
        new = []
        for p, spec, c in zip(params["layers"], self.specs, cache["layers"]):
            x, c2 = layer_decode(p, self.cfg, spec, x, c, cache_len,
                                 use_kernel=True, src_len=src_len)
            new.append(c2)
        return self.logits(params, x[:, 0]), {"layers": new,
                                              "len": cache_len + 1}
