"""Decode superkernels: the per-layer decode hot path of the segment-fused
engine in three kernels.

- `fused_moe_entry`: router logits (+ an additive bias), softmax, top-k,
  the expert -> slot lookup with the dead-sentinel rule and the
  gate-weighted expert SwiGLU through the slot buffer.
- `fused_decode_attention`: one-token GQA attention that inserts the new
  K/V row into the ring at `cache_len % S` (into new cache tensors) and
  runs an online softmax over the filled prefix.
- `fused_mla_decode_attention`: weight-absorbed MLA decode attention that
  inserts the new latent / rope-key row at position `cache_len` (into new
  cache tensors) and runs an online softmax over the filled prefix.

On a CUDA tensor each wrapper launches its hand-written Hopper kernel
(`csrc/fused_moe_entry.cu`, `csrc/fused_decode_attention.cu`,
`csrc/fused_mla_decode_attention.cu`) on the current stream, or raises; on
a CPU tensor it runs the plain version in `kernels.ref`, which follows the
kernel's rounding points. Any other device raises. Each wrapper counts the
calls that launched its kernel in `.launches` (one per call, though
`fused_moe_entry` is three CUDA launches). bf16 and f32 run on the card, as
in the reference; any other dtype raises.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch
from torch._subclasses.fake_tensor import is_fake

from repro_torch.kernels.build import LIBS
from repro_torch.kernels.ref import (fused_decode_attention_ref,
                                     fused_mla_decode_attention_ref,
                                     fused_moe_entry_ref)
from repro_torch.kernels.slot_gather import KERNEL_DTYPES

MAX_TOKENS = 1024        # fused_moe_entry: tokens per call (a decode batch)
MAX_EXPERTS = 256
MAX_TOP_K = 16
MAX_GROUP = 16           # fused_decode_attention: query heads per kv head
MAX_HEAD_DIM = 256
MAX_LATENT = 512         # fused_mla_decode_attention: latent width R
MAX_ROPE = 128           # rope key width P


def _device(x: torch.Tensor, name: str) -> str:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cuda or cpu, not {x.device}")
    return x.device.type


def _need(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must be {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def _check_cache_len(cache_len: torch.Tensor, B: int, dev) -> None:
    if (cache_len.dtype != torch.int64 or cache_len.device != dev
            or cache_len.numel() not in (1, B)
            or not cache_len.is_contiguous()):
        raise TypeError(f"cache_len must be a contiguous int64 () or ({B},) "
                        f"tensor on {dev}")


def _check_moe(x, router_w, logit_bias, slot_of_expert, s_gate, s_up,
               s_down, top_k):
    if x.dim() != 2 or router_w.dim() != 2 or s_gate.dim() != 3:
        raise ValueError("x must be (T, d), router_w (d, E), slot buffers "
                         "(S, d, f) / (S, f, d)")
    T, d = x.shape
    E = router_w.shape[1]
    S, _, f = s_gate.shape
    dev = x.device
    if x.dtype not in KERNEL_DTYPES:
        raise TypeError(f"x must be bfloat16 or float32, got {x.dtype}")
    _need(x, "x", x.dtype, (T, d), dev)
    _need(router_w, "router_w", torch.float32, (d, E), dev)
    _need(logit_bias, "logit_bias", torch.float32, (E,), dev)
    _need(slot_of_expert, "slot_of_expert", torch.int32, (E,), dev)
    _need(s_gate, "s_gate", x.dtype, (S, d, f), dev)
    _need(s_up, "s_up", x.dtype, (S, d, f), dev)
    _need(s_down, "s_down", x.dtype, (S, f, d), dev)
    if not 1 <= T <= MAX_TOKENS:
        raise ValueError(f"T={T} tokens: the kernel takes 1..{MAX_TOKENS}")
    if not 1 <= top_k <= min(E, MAX_TOP_K) or E > MAX_EXPERTS or E % 4:
        raise ValueError(f"top_k={top_k} of E={E} experts: the kernel takes "
                         f"E <= {MAX_EXPERTS}, a multiple of 4, top_k <= "
                         f"{MAX_TOP_K}")
    if d % 8 or f % 8:
        raise ValueError(f"d={d} and f={f} must be multiples of 8 "
                         "(16-byte loads)")
    route_bytes = (d + 8192 + 8 * E) * 4 + T * top_k * 4 + E * 4
    if route_bytes > 230400:
        raise ValueError(f"d={d}, T={T}, top_k={top_k}: the route launch's "
                         "shared memory does not fit a block")


def fused_moe_entry(x: torch.Tensor, router_w: torch.Tensor,
                    logit_bias: torch.Tensor, slot_of_expert: torch.Tensor,
                    s_gate: torch.Tensor, s_up: torch.Tensor,
                    s_down: torch.Tensor, *, top_k: int,
                    norm_topk: bool = True):
    """x: (T, d) tokens, bf16 or f32; router_w: (d, E) fp32; logit_bias:
    (E,) fp32 (zeros: plain routing); slot_of_expert: (E,) int32, -1 = not
    resident; slot buffers (S, d, f) / (S, f, d) of x's dtype.

    Returns (y (T, d) fp32, gates (T, top_k) fp32 zeroed for non-resident
    experts, ids (T, top_k) int32). Non-resident experts are never read.
    g, u, h and the down-projection round to x's dtype (none in f32)."""
    if _device(x, "fused_moe_entry") == "cpu":
        return fused_moe_entry_ref(x, router_w, logit_bias, slot_of_expert,
                                   s_gate, s_up, s_down, top_k=top_k,
                                   norm_topk=norm_topk)
    _check_moe(x, router_w, logit_bias, slot_of_expert, s_gate, s_up, s_down,
               top_k)
    T, d = x.shape
    E = router_w.shape[1]
    S, _, f = s_gate.shape
    dev = x.device
    y = torch.empty((T, d), dtype=torch.float32, device=dev)
    gates = torch.empty((T, top_k), dtype=torch.float32, device=dev)
    ids = torch.empty((T, top_k), dtype=torch.int32, device=dev)
    lib = LIBS.get("fused_moe_entry")
    f32 = int(x.dtype == torch.float32)
    scratch = torch.empty(
        lib.fused_moe_entry_scratch_bytes(T, d, E, top_k, f, f32),
        dtype=torch.uint8, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.fused_moe_entry_launch(
        x.data_ptr(), router_w.data_ptr(), logit_bias.data_ptr(),
        slot_of_expert.data_ptr(), s_gate.data_ptr(), s_up.data_ptr(),
        s_down.data_ptr(), gates.data_ptr(), ids.data_ptr(),
        scratch.data_ptr(), y.data_ptr(), T, d, E, top_k, f, S,
        int(norm_topk), f32, stream)
    if err != 0:
        raise RuntimeError(f"fused_moe_entry launch failed with CUDA error "
                           f"{err}")
    fused_moe_entry.launches += 1
    return y, gates, ids


fused_moe_entry.launches = 0


def fused_decode_attention(q: torch.Tensor, k_new: torch.Tensor,
                           v_new: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor, cache_len: torch.Tensor, *,
                           logit_softcap: float = 0.0, scale=None):
    """q: (B, 1, Hq, D); k_new / v_new: (B, 1, Hkv, D); caches (B, S, Hkv, D),
    all of one dtype, bf16 or f32; cache_len: () or (B,) int64, the entries
    cached BEFORE this token (the port's `DecodeState.cache_len`, passed as
    it is: a () tensor is read with stride 0).

    Returns (out (B, 1, Hq, D), new k cache, new v cache). The input caches
    are left as they were."""
    if _device(q, "fused_decode_attention") == "cpu":
        return fused_decode_attention_ref(q, k_new, v_new, k_cache, v_cache,
                                          cache_len,
                                          logit_softcap=logit_softcap,
                                          scale=scale)
    if q.dim() != 4 or k_cache.dim() != 4:
        raise ValueError("q must be (B, 1, Hq, D), caches (B, S, Hkv, D)")
    B, _, Hq, D = q.shape
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    dev = q.device
    if q.dtype not in KERNEL_DTYPES:
        raise TypeError(f"q must be bfloat16 or float32, got {q.dtype}")
    _need(q, "q", q.dtype, (B, 1, Hq, D), dev)
    for name, t in (("k_new", k_new), ("v_new", v_new)):
        _need(t, name, q.dtype, (B, 1, Hkv, D), dev)
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache)):
        _need(t, name, q.dtype, (B, S, Hkv, D), dev)
    _check_cache_len(cache_len, B, dev)
    if Hq % Hkv or not 1 <= Hq // Hkv <= MAX_GROUP:
        raise ValueError(f"Hq={Hq} must be 1..{MAX_GROUP} times Hkv={Hkv}")
    if D % 8 or not 8 <= D <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {D} must be a multiple of 8, at most "
                         f"{MAX_HEAD_DIM}")
    out = torch.empty_like(q)
    kc = torch.empty_like(k_cache)
    vc = torch.empty_like(v_cache)
    if scale is None:
        scale = D ** -0.5
    lib = LIBS.get("fused_decode_attention")
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.fused_decode_attention_launch(
        q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), k_cache.data_ptr(),
        v_cache.data_ptr(), cache_len.data_ptr(),
        0 if cache_len.numel() == 1 else 1, out.data_ptr(), kc.data_ptr(),
        vc.data_ptr(), B, S, Hkv, Hq // Hkv, D, ctypes.c_float(scale),
        ctypes.c_float(logit_softcap), int(q.dtype == torch.float32), stream)
    if err != 0:
        raise RuntimeError(f"fused_decode_attention launch failed with CUDA "
                           f"error {err}")
    fused_decode_attention.launches += 1
    return out, kc, vc


fused_decode_attention.launches = 0


def fused_mla_decode_attention(q_abs: torch.Tensor, q_pe: torch.Tensor,
                               c_new: torch.Tensor, pe_new: torch.Tensor,
                               latent: torch.Tensor, pe: torch.Tensor,
                               cache_len: torch.Tensor, *, scale: float,
                               max_len: Optional[int] = None):
    """q_abs: (B, H, R) fp32 (q_nope absorbed through wkv_b's key half);
    q_pe: (B, H, P) fp32; c_new: (B, R) / pe_new: (B, P), this token's
    latent and rope key; latent: (B, S, R) / pe: (B, S, P) caches, the four
    of one dtype, bf16 or f32; cache_len: () or (B,) int64, the positions
    cached BEFORE this token. Any number of heads H (the kernel takes them
    16 to a block); R and P are bounded by the block's shared memory.

    Returns (ctx (B, H, R) fp32, new latent, new pe): the new row lands at
    position `cache_len` of each row (positional, no ring); the input
    caches are left as they were. Raises if the cache has no room for the
    token: with `max_len`, a host int the caller knows bounds every
    `cache_len` from above (the engine's host mirror of the lengths), if
    max_len >= S, without reading the device; without it, if any
    `cache_len` is outside [0, S), which on CUDA reads the lengths back to
    the host (one synchronisation per call). Whatever the lengths, the
    kernel reads only positions < S and writes only the new caches and ctx."""
    if latent.dim() != 3 or q_abs.dim() != 3:
        raise ValueError("q_abs must be (B, H, R), latent (B, S, R)")
    B, S, R = latent.shape
    H, P = q_abs.shape[1], pe.shape[-1]
    cpu = _device(q_abs, "fused_mla_decode_attention") == "cpu"
    if not cpu:
        dev = q_abs.device
        _need(q_abs, "q_abs", torch.float32, (B, H, R), dev)
        _need(q_pe, "q_pe", torch.float32, (B, H, P), dev)
        if latent.dtype not in KERNEL_DTYPES:
            raise TypeError(f"latent must be bfloat16 or float32, got "
                            f"{latent.dtype}")
        _need(c_new, "c_new", latent.dtype, (B, R), dev)
        _need(pe_new, "pe_new", latent.dtype, (B, P), dev)
        _need(latent, "latent", latent.dtype, (B, S, R), dev)
        _need(pe, "pe", latent.dtype, (B, S, P), dev)
        _check_cache_len(cache_len, B, dev)
        if H < 1:
            raise ValueError(f"H={H} heads: the kernel takes at least one")
        if R % 8 or not 8 <= R <= MAX_LATENT or P % 8 \
                or not 8 <= P <= MAX_ROPE:
            raise ValueError(f"latent width {R} and rope width {P} must be "
                             f"multiples of 8, at most {MAX_LATENT} / "
                             f"{MAX_ROPE}")
    if max_len is not None:
        if max_len >= S:
            raise ValueError(f"cache_len up to {max_len} does not fit a "
                             f"cache of {S} positions")
    elif not is_fake(cache_len):     # a fake tensor has no lengths to read
        lo, hi = (int(v) for v in
                  torch.stack(torch.aminmax(cache_len)).tolist())
        if lo < 0 or hi >= S:
            raise ValueError(f"cache_len in [{lo}, {hi}] does not fit a cache "
                             f"of {S} positions")
    if cpu:
        return fused_mla_decode_attention_ref(q_abs, q_pe, c_new, pe_new,
                                              latent, pe, cache_len,
                                              scale=scale)
    return _launch_mla(q_abs, q_pe, c_new, pe_new, latent, pe, cache_len,
                       scale)


def _launch_mla(q_abs, q_pe, c_new, pe_new, latent, pe, cache_len, scale):
    """Enqueue the kernel on checked inputs and count the launch."""
    B, S, R = latent.shape
    H, P = q_abs.shape[1], pe.shape[-1]
    dev = q_abs.device
    ctx = torch.empty((B, H, R), dtype=torch.float32, device=dev)
    lat = torch.empty_like(latent)
    pe2 = torch.empty_like(pe)
    lib = LIBS.get("fused_mla_decode_attention")
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.fused_mla_decode_attention_launch(
        q_abs.data_ptr(), q_pe.data_ptr(), c_new.data_ptr(),
        pe_new.data_ptr(), latent.data_ptr(), pe.data_ptr(),
        cache_len.data_ptr(), 0 if cache_len.numel() == 1 else 1,
        ctx.data_ptr(), lat.data_ptr(), pe2.data_ptr(), B, S, H, R, P,
        ctypes.c_float(scale), int(latent.dtype == torch.float32), stream)
    if err != 0:
        raise RuntimeError(f"fused_mla_decode_attention launch failed with "
                           f"CUDA error {err}")
    fused_mla_decode_attention.launches += 1
    return ctx, lat, pe2


fused_mla_decode_attention.launches = 0
