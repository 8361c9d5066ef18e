"""Decoder stack for the slot-buffer runtime: global-attention layers (GQA
or MLA) with a MoE FFN (routed experts, optionally shared experts) or a
dense SwiGLU FFN — olmoe- and DeepSeek-V2-style stacks; other layer kinds
are not ported yet.

The port's parameter tree is flat: ``{"embed", "final_norm", "lm_head",
"layers": [one dict per absolute layer]}`` — the reference's stacked
``unit`` lists are unstacked once, by `repro_torch.bridge` or by
`Model.init`. Per-layer dicts keep the reference's keys and layouts.

Entry points used by `runtime.engine`: `layer_forward`, `layer_prefill`,
`layer_prefill_chunk`, `layer_decode` (each also works on FFN-stripped params from
`split_ffn_params`), `init_layer_cache` and `Model.embed` / `Model.logits`.
Decode never writes a cache in place: each step returns new cache tensors,
so a saved state stays valid (decode rollback and branching rely on it).
`layer_prefill_chunk` does write in place, into caches that belong to one
prefill cursor and are copied when the prompt is committed to a batch row.
"""
from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.kernels.decode_superkernel import fused_decode_attention
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models.layers import (dense_init, embed_init, rms_norm,
                                       swiglu, trunc_normal)


class LayerSpec(NamedTuple):
    kind: str          # attn (the only kind the port runs so far)
    window: int        # sliding window (0 = global, the only one ported)
    is_moe: bool       # MoE FFN; otherwise a dense SwiGLU FFN
    layer_idx: int     # absolute depth index (first occurrence)


# Parameter keys that belong to a layer's FFN half.
FFN_PARAM_KEYS = ("ffn_norm", "moe", "ffn")


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


def _check_supported(cfg: ModelConfig, spec: LayerSpec) -> None:
    """The port runs global-attention GQA or MLA layers with a MoE or dense
    SwiGLU FFN, pre-norm, untied embeddings, in MoE models; anything else
    raises rather than run wrong."""
    if (spec.kind != "attn" or cfg.attention not in ("gqa", "mla")
            or spec.window):
        raise NotImplementedError(
            f"{cfg.name} layer {spec.layer_idx}: the port runs global GQA "
            f"or MLA attention only, got {spec}")
    if (cfg.moe is None or cfg.is_encoder_decoder or cfg.abs_pos
            or cfg.attn_logit_softcap or cfg.tie_embeddings
            or cfg.name.startswith(("gemma", "recurrentgemma"))):
        raise NotImplementedError(f"{cfg.name}: not ported yet")


# ---------------------------------------------------------------------------
# Per-layer parameter init
# ---------------------------------------------------------------------------

def init_layer(cfg: ModelConfig, spec: LayerSpec, dtype, **kw):
    """One layer's params; `kw` carries `generator` and `device`."""
    _check_supported(cfg, spec)
    d, hd = cfg.d_model, cfg.resolved_head_dim
    H, Hkv = cfg.num_heads, cfg.num_kv_heads
    dev = kw.get("device", "cpu")
    if cfg.attention == "mla":
        attn = attn_mod.init_mla_params(d, H, cfg.mla, dtype, **kw)
    else:
        attn = {
            "wq": trunc_normal((d, H, hd), d ** -0.5, dtype, **kw),
            "wk": trunc_normal((d, Hkv, hd), d ** -0.5, dtype, **kw),
            "wv": trunc_normal((d, Hkv, hd), d ** -0.5, dtype, **kw),
            "wo": trunc_normal((H, hd, d), (H * hd) ** -0.5, dtype, **kw),
        }
        if cfg.qk_norm:
            attn["q_norm"] = torch.ones((hd,), dtype=dtype, device=dev)
            attn["k_norm"] = torch.ones((hd,), dtype=dtype, device=dev)
    p = {"pre_norm": torch.ones((d,), dtype=dtype, device=dev),
         "attn": attn,
         "ffn_norm": torch.ones((d,), dtype=dtype, device=dev)}
    if spec.is_moe:
        p["moe"] = moe_mod.init_moe_params(d, cfg.moe, dtype, **kw)
    else:
        p["ffn"] = {"w_gate": dense_init(d, cfg.d_ff, dtype, **kw),
                    "w_up": dense_init(d, cfg.d_ff, dtype, **kw),
                    "w_down": dense_init(cfg.d_ff, d, dtype, **kw)}
    return p


# ---------------------------------------------------------------------------
# Per-layer forward (prefill path)
# ---------------------------------------------------------------------------

def _ffn_part(p, cfg: ModelConfig, x: torch.Tensor,
              capacity: Optional[int] = None) -> torch.Tensor:
    """x + FFN: MoE (capacity-buffer grouped over the layer's own experts,
    shared experts included) or dense SwiGLU. x: (B, T, d). FFN-stripped
    params pass x through."""
    if "ffn_norm" not in p:
        return x
    h2 = rms_norm(x, p["ffn_norm"], cfg.norm_eps)
    if "ffn" in p:
        f = p["ffn"]
        return x + swiglu(h2, f["w_gate"], f["w_up"], f["w_down"])
    if capacity is None:
        ff, _ = moe_mod.moe_grouped(p["moe"], h2, cfg.moe)
        return x + ff
    B = x.shape[0]
    out, _ = moe_mod.moe_grouped(p["moe"], h2.reshape(B, -1), cfg.moe,
                                 capacity=capacity)
    return x + out.reshape(B, 1, -1)


def _attn_prefill(p, cfg: ModelConfig, spec: LayerSpec, x: torch.Tensor,
                  positions: torch.Tensor):
    """Pre-norm self-attention (GQA or MLA) over the whole sequence.
    Returns (x + attention, {cache name: the T rows the cache keeps})."""
    _check_supported(cfg, spec)
    h = rms_norm(x, p["pre_norm"], cfg.norm_eps)
    if cfg.attention == "mla":
        q, k, v, (c_kv, k_pe) = attn_mod._mla_qkv(
            p["attn"], h, positions, cfg.mla, cfg.rope_theta, cfg.norm_eps)
        rows = {"latent": c_kv, "pe": k_pe}
    else:
        q = attn_mod.gqa_project_q(p["attn"], h, positions, cfg.rope_theta,
                                   cfg.norm_eps)
        k, v = attn_mod.gqa_project_kv(p["attn"], h, positions,
                                       cfg.rope_theta, cfg.norm_eps)
        rows = {"k": k, "v": v}
    # MLA: q's width is nope + rope, so flash_attention's q-width ** -0.5
    # is MLA's scale; v (v_head_dim) may be narrower than q and k
    mix = attn_mod.flash_attention(q, k, v)
    return x + attn_mod.gqa_out(p["attn"], mix), rows


def layer_forward(p, cfg: ModelConfig, spec: LayerSpec, x: torch.Tensor,
                  positions: torch.Tensor) -> torch.Tensor:
    """Full-sequence layer (prefill without a cache). x: (B, T, d)."""
    x, _ = _attn_prefill(p, cfg, spec, x, positions)
    return _ffn_part(p, cfg, x)


# ---------------------------------------------------------------------------
# Caches
# ---------------------------------------------------------------------------

def init_layer_cache(cfg: ModelConfig, spec: LayerSpec, batch: int,
                     max_seq: int, dtype, device="cpu"):
    """GQA: a K/V ring {"k", "v"} (B, S, Hkv, D). MLA: the positional
    compressed cache {"latent": (B, S, R), "pe": (B, S, 1, P)}."""
    _check_supported(cfg, spec)
    z = lambda *s: torch.zeros(s, dtype=dtype, device=device)  # noqa: E731
    if cfg.attention == "mla":
        return {"latent": z(batch, max_seq, cfg.mla.kv_lora_rank),
                "pe": z(batch, max_seq, 1, cfg.mla.qk_rope_head_dim)}
    shape = (batch, max_seq, cfg.num_kv_heads, cfg.resolved_head_dim)
    return {"k": z(*shape), "v": z(*shape)}


def layer_prefill(p, cfg: ModelConfig, spec: LayerSpec, x: torch.Tensor,
                  positions: torch.Tensor, max_seq: int):
    """Like layer_forward but also returns a populated cache entry."""
    B, T, _ = x.shape
    x, rows = _attn_prefill(p, cfg, spec, x, positions)
    cache = init_layer_cache(cfg, spec, B, max_seq, x.dtype, x.device)
    for name, r in rows.items():    # T <= max_seq: no ring wrap yet
        cache[name][:, :T] = r
    return _ffn_part(p, cfg, x), cache


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
    only global attention layers take them: other mixers and sliding
    windows raise."""
    if spec.kind != "attn":
        raise NotImplementedError(
            f"chunked prefill supports attention layers only, got {spec.kind}")
    if spec.window:
        raise NotImplementedError(
            "chunked prefill requires global attention (ring-wrapped sliding-"
            "window caches lose the absolute positions chunks address)")
    _check_supported(cfg, spec)
    h = rms_norm(x, p["pre_norm"], cfg.norm_eps)
    if cfg.attention == "mla":
        mix, _, _ = attn_mod.mla_prefill_chunk(
            p["attn"], h, positions, cache["latent"], cache["pe"], cache_len,
            n_valid, mla=cfg.mla, rope_theta=cfg.rope_theta,
            norm_eps=cfg.norm_eps)
    else:
        mix, _, _ = attn_mod.gqa_prefill_chunk(
            p["attn"], h, positions, cache["k"], cache["v"], cache_len,
            n_valid, rope_theta=cfg.rope_theta, norm_eps=cfg.norm_eps)
    return _ffn_part(p, cfg, x + mix), cache


def layer_decode(p, cfg: ModelConfig, spec: LayerSpec, x: torch.Tensor,
                 cache, cache_len: torch.Tensor, use_kernel: bool = False,
                 max_len: Optional[int] = None):
    """One-token layer step. x: (B, 1, d). Returns (x, new_cache).

    `cache_len` is a () tensor (all rows at one position) or a (B,) tensor
    (each row at its own position). GQA: the new token's K/V goes to ring
    slot `cache_len % size` of each row; MLA: its latent / rope-key row goes
    to position `cache_len` (no ring). Either way into NEW cache tensors:
    the input cache is left as it was.

    `use_kernel=True` runs the insert and the attention in one
    `fused_decode_attention` (GQA) or `fused_mla_decode_attention` (MLA)
    call, which writes the new caches itself; `max_len`, a host int that
    bounds every `cache_len`, lets the MLA kernel's wrapper check the room
    in the cache without reading the lengths from the device."""
    _check_supported(cfg, spec)
    B = x.shape[0]
    h = rms_norm(x, p["pre_norm"], cfg.norm_eps)
    if cfg.attention == "mla":
        mix, lat, pe = attn_mod.mla_decode(
            p["attn"], h, cache["latent"], cache["pe"], cache_len,
            mla=cfg.mla, rope_theta=cfg.rope_theta, norm_eps=cfg.norm_eps,
            use_kernel=use_kernel, max_len=max_len)
        return _decode_ffn(p, cfg, x + mix), dict(cache, latent=lat, pe=pe)
    size = cache["k"].shape[1]
    clen = cache_len.reshape(-1).expand(B)
    positions = clen[:, None]
    q = attn_mod.gqa_project_q(p["attn"], h, positions, cfg.rope_theta,
                               cfg.norm_eps)
    k, v = attn_mod.gqa_project_kv(p["attn"], h, positions, cfg.rope_theta,
                                   cfg.norm_eps)
    if use_kernel:
        mix, kc, vc = fused_decode_attention(
            q.contiguous(), k.contiguous(), v.contiguous(), cache["k"],
            cache["v"], cache_len,
            logit_softcap=cfg.attn_logit_softcap)
    else:
        rows = torch.arange(B, device=x.device)
        slot = torch.remainder(clen, size)
        kc = cache["k"].clone()
        vc = cache["v"].clone()
        kc[rows, slot] = k[:, 0]
        vc[rows, slot] = v[:, 0]
        valid = torch.clamp(clen + 1, max=size)
        mix = attn_mod.decode_attention(q, kc, vc, valid)
    x = x + attn_mod.gqa_out(p["attn"], mix)
    return _decode_ffn(p, cfg, x), dict(cache, k=kc, v=vc)


def _decode_ffn(p, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """The FFN half of a one-token step; a MoE layer's capacity is sized to
    the expected load (4x slack), not the worst case."""
    B, m = x.shape[0], cfg.moe
    cap = min(B * m.top_k, max(8, -(-B * m.top_k // m.num_experts) * 4))
    return _ffn_part(p, cfg, x, capacity=cap)


# ---------------------------------------------------------------------------
# Whole model
# ---------------------------------------------------------------------------

class Model:
    """Config-driven decoder-only LM (embedding, layer specs, LM head)."""

    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        self.specs = all_specs(cfg)
        for s in self.specs:
            _check_supported(cfg, s)
        self.dtype = torch.bfloat16 if cfg.dtype == "bfloat16" \
            else torch.float32

    def init(self, generator: Optional[torch.Generator] = None,
             device="cuda") -> Dict[str, Any]:
        """Random params with the reference's init law, drawn on `device`
        from `generator` (which must live on that device)."""
        dev = resolve_device(device)
        cfg, dt = self.cfg, self.dtype
        kw = dict(generator=generator, device=dev)
        params: Dict[str, Any] = {
            "embed": embed_init(cfg.vocab_size, cfg.d_model, dt, **kw),
            "final_norm": torch.ones((cfg.d_model,), dtype=dt, device=dev),
            "lm_head": dense_init(cfg.d_model, cfg.vocab_size, dt, **kw),
        }
        params["layers"] = [init_layer(cfg, s, dt, **kw) for s in self.specs]
        return params

    def embed(self, params, tokens: torch.Tensor) -> torch.Tensor:
        return params["embed"][tokens]

    def logits(self, params, h: torch.Tensor) -> torch.Tensor:
        """Final norm + LM head; the product rounds to the params' dtype
        before widening to fp32, as the reference's does."""
        h = rms_norm(h, params["final_norm"], self.cfg.norm_eps)
        return (h @ params["lm_head"]).float()
