"""Card-only tests of the port: each CUDA kernel against its plain version
(and against itself, for determinism), the wrappers' checks, and the slot
paths (unfused and superkernel, whole-prompt and chunked prefill) against
their fully-resident oracles with asynchronous swap-ins. They skip without a CUDA device; on a machine
with one (and the CUDA toolkit), run them with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

This file imports no JAX: the card's machine need not have it.
"""
import bisect
import ctypes
import json

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, get_smoke_config, reduce_config
from repro_torch.kernels import decode_superkernel as dsk
from repro_torch.kernels import ops, slot_gather
from repro_torch.kernels.ref import (expert_ffn_ref,
                                     fused_decode_attention_ref,
                                     fused_mla_decode_attention_ref,
                                     fused_moe_entry_ref, slot_ffn_ref,
                                     topk_gating_ref)
from repro_torch.models import moe
from repro_torch.models.transformer import Model, layer_decode
from repro_torch.runtime.engine import DecodeState, SlotBufferEngine
from repro_torch.runtime.instrument import SpanLog
from repro_torch.runtime.request import Request
from repro_torch.runtime.serving import EngineServingConfig, ServingEngine

pytestmark = pytest.mark.cuda
TOL = 2e-2


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.Generator(device="cuda").manual_seed(0)


def _inputs(g, E, C, D, F, S):
    x = torch.randn((E, C, D), generator=g, device="cuda").bfloat16()
    w = lambda *s: (torch.randn(s, generator=g, device="cuda")  # noqa: E731
                    * s[-2] ** -0.5).bfloat16()
    slot = torch.randint(0, S, (E,), generator=g, device="cuda",
                         dtype=torch.int32)
    return x, slot, w(S, D, F), w(S, D, F), w(S, F, D)


@pytest.mark.parametrize("shape", [(64, 32, 2048, 1024, 256),
                                   (64, 1024, 2048, 1024, 64),
                                   (3, 5, 96, 40, 4), (2, 70, 136, 72, 3)])
def test_slot_ffn_kernel_matches_plain_version(gen, shape):
    args = _inputs(gen, *shape)
    before = slot_gather.slot_ffn.launches
    got = slot_gather.slot_ffn(*args)
    again = slot_gather.slot_ffn(*args)
    want = slot_ffn_ref(*args)
    torch.cuda.synchronize()
    assert slot_gather.slot_ffn.launches == before + 2
    torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)
    assert torch.equal(got, again), "the kernel must be deterministic"


def test_slot_ffn_wrapper_rejects_what_the_kernel_does_not_take(gen):
    x, slot, wg, wu, wd = _inputs(gen, 2, 4, 64, 32, 3)
    with pytest.raises(TypeError):
        slot_gather.slot_ffn(x.half(), slot, wg.half(), wu.half(), wd.half())
    with pytest.raises(TypeError):
        slot_gather.slot_ffn(x.float(), slot, wg, wu, wd)
    with pytest.raises(TypeError):
        slot_gather.slot_ffn(x, slot.long(), wg, wu, wd)
    with pytest.raises(ValueError):
        slot_gather.slot_ffn(x, slot, wg.transpose(1, 2), wu, wd)
    x2, slot2, wg2, wu2, wd2 = _inputs(gen, 2, 4, 60, 32, 3)
    with pytest.raises(ValueError):
        slot_gather.slot_ffn(x2, slot2, wg2, wu2, wd2)


def _routed_inputs(g, B, T, k, E, D, F, S):
    """A dispatch buffer, clamped slot table and row counts as
    `moe_slotbuf(use_kernel=True)` builds them, with half the experts
    resident (routed ones among the absent)."""
    n = B * T
    x = torch.randn((n, D), generator=g, device="cuda").bfloat16()
    _, ids = moe.top_k_first_max(
        torch.randn((n, E), generator=g, device="cuda"), k)
    buf, *_, counts = moe._dispatch_gather(x, ids, E, n * k)
    perm = torch.randperm(S, generator=g, device="cuda")[:E].int()
    resident = torch.rand(E, generator=g, device="cuda") < 0.5
    table = torch.where(resident, perm, -1)
    counts = moe.slot_ffn_row_counts(counts, table, n * k)
    w = lambda *s: (torch.randn(s, generator=g, device="cuda")  # noqa: E731
                    * s[-2] ** -0.5).bfloat16()
    slot = torch.clamp(table, min=0).int()
    return (buf.contiguous(), slot, w(S, D, F), w(S, D, F), w(S, F, D)), counts


@pytest.mark.parametrize("shape", [(4, 1, 8, 64, 2048, 1024, 256),
                                   (1, 128, 8, 64, 2048, 1024, 256),
                                   (1, 32, 8, 64, 2048, 1024, 256),
                                   (1, 5, 2, 3, 96, 40, 4),
                                   (1, 128, 6, 64, 2048, 1408, 416)],
                         ids=["decode", "prefill", "chunk", "ragged",
                              "deepseek_prefill"])
def test_slot_ffn_kernel_with_counts_matches_plain_version(gen, shape):
    args, counts = _routed_inputs(gen, *shape)
    before = slot_gather.slot_ffn.launches
    got = slot_gather.slot_ffn(*args, counts=counts)
    again = slot_gather.slot_ffn(*args, counts=counts)
    every_row = slot_gather.slot_ffn(*args)
    want = slot_ffn_ref(*args, counts=counts)
    torch.cuda.synchronize()
    assert slot_gather.slot_ffn.launches == before + 3
    live = (torch.arange(args[0].shape[1], device="cuda")[None, :]
            < counts.long()[:, None])[..., None]
    assert int(counts.sum()) > 0
    counted = lambda y: torch.where(live, y, 0)  # noqa: E731
    torch.testing.assert_close(counted(got), want, rtol=TOL, atol=TOL)
    assert torch.equal(counted(got), counted(again)), "not deterministic"
    assert torch.equal(counted(got), counted(every_row)), \
        "a counted row must not depend on whether the others are computed"


def test_moe_slotbuf_kernel_finite_over_nan_filled_memory(gen):
    """With counts, rows of absent experts and rows past a count are never
    written: after the caching allocator has been filled with NaN and
    freed, the kernel path's output is still finite and agrees with the
    einsum path."""
    from repro_torch.models.moe import init_moe_params
    cfg = get_config("olmoe-1b-7b")
    M, d, T, S = cfg.moe, cfg.d_model, 48, 17
    p = init_moe_params(d, M, generator=gen, device="cuda")
    table = torch.full((M.num_experts,), -1, dtype=torch.int32,
                       device="cuda")
    live = torch.randperm(M.num_experts, generator=gen,
                          device="cuda")[:S - 1]
    table[live] = torch.arange(1, S, dtype=torch.int32, device="cuda")
    slots = {k: torch.full((S,) + p[k].shape[1:], float("nan"),
                           dtype=p[k].dtype, device="cuda")
             for k in ("w_gate", "w_up", "w_down")}
    for k in slots:
        slots[k][table[live].long()] = p[k][live]
    x = torch.randn((T, d), generator=gen, device="cuda").bfloat16()
    junk = [torch.full((1 << n,), float("nan"), device="cuda")
            for n in range(10, 27) for _ in range(4)]
    del junk
    got, r = moe.moe_slotbuf(p, slots, table, x, M, capacity=T * M.top_k,
                             use_kernel=True)
    want, _ = moe.moe_slotbuf(p, slots, table, x, M, capacity=T * M.top_k,
                              use_kernel=False)
    torch.cuda.synchronize()
    assert (table[r.expert_ids] < 0).any(), "no routed expert is absent"
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), want.float(), rtol=5e-2,
                               atol=5e-2)


def test_slot_path_bitwise_vs_oracle_on_the_card(gen):
    cfg = get_smoke_config("olmoe-1b-7b")
    model = Model(cfg)
    params = model.init(gen, device="cuda")
    eng = SlotBufferEngine(cfg, params, model, n_slots_per_layer=4,
                           use_kernel=True, step_size=1, pregate_margin=0)
    rng = np.random.default_rng(0)
    for _ in range(2):
        prompt = rng.integers(0, cfg.vocab_size, (2, 9))
        lg, st = eng.prefill(prompt)
        lr, sr = eng.reference_prefill(prompt)
        assert torch.equal(lg, lr)
        tok = lr.argmax(-1)
        for _ in range(8):
            lg, st = eng.decode_step(tok, st)
            lr, sr = eng.reference_decode_step(tok, sr)
            assert torch.equal(lg, lr)
            tok = lr.argmax(-1)
    eng.synchronize()
    assert eng.stats.evictions > 0 and eng.stats.copy_s > 0


# ---------------------------------------------------------------------------
# decode superkernels
# ---------------------------------------------------------------------------

def _moe_args(g, T, d, E, f, S, n_resident):
    dev = "cuda"
    w = lambda *s: (torch.randn(s, generator=g, device=dev)  # noqa: E731
                    * s[-2] ** -0.5).bfloat16()
    x = torch.randn((T, d), generator=g, device=dev).bfloat16()
    rw = torch.randn((d, E), generator=g, device=dev) * d ** -0.5
    bias = torch.randn(E, generator=g, device=dev) * 0.5
    soe = torch.full((E,), -1, dtype=torch.int32, device=dev)
    live = torch.randperm(E, generator=g, device=dev)[:n_resident]
    soe[live] = torch.randperm(S, generator=g, device=dev)[:n_resident].int()
    return x, rw, bias, soe, w(S, d, f), w(S, d, f), w(S, f, d)


@pytest.mark.parametrize("case", [(4, 2048, 64, 1024, 256, 64, 8),
                                  (4, 2048, 64, 1024, 256, 16, 8),
                                  (5, 48, 8, 72, 6, 5, 2)],
                         ids=["decode_all_resident", "decode_16_resident",
                              "off_tile"])
def test_fused_moe_entry_kernel_matches_plain_version(gen, case):
    T, d, E, f, S, n_res, k = case
    args = _moe_args(gen, T, d, E, f, S, n_res)
    before = dsk.fused_moe_entry.launches
    y, g, i = dsk.fused_moe_entry(*args, top_k=k)
    y2, g2, i2 = dsk.fused_moe_entry(*args, top_k=k)
    yr, gr, ir = fused_moe_entry_ref(*args, top_k=k)
    torch.cuda.synchronize()
    assert dsk.fused_moe_entry.launches == before + 2
    assert torch.equal(i, ir)
    torch.testing.assert_close(g, gr, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(y, yr, rtol=TOL, atol=TOL)
    assert torch.equal(y, y2) and torch.equal(g, g2) and torch.equal(i, i2)


@pytest.mark.parametrize("softcap", [0.0, 30.0])
@pytest.mark.parametrize("case", [([0, 63, 128, 255], 16, 16),
                                  ([256, 300, 511, 1000], 16, 16),
                                  ([17, 255, 0, 90], 16, 4)],
                         ids=["decode", "wrapped", "gqa_G4"])
def test_fused_decode_attention_kernel_matches_plain_version(gen, case,
                                                             softcap):
    clens, Hq, Hkv = case
    B, S, D = len(clens), 256, 128
    r = lambda *s: torch.randn(s, generator=gen,  # noqa: E731
                               device="cuda").bfloat16()
    args = (r(B, 1, Hq, D), r(B, 1, Hkv, D), r(B, 1, Hkv, D),
            r(B, S, Hkv, D), r(B, S, Hkv, D),
            torch.tensor(clens, device="cuda"))
    old = [a.clone() for a in args[3:5]]
    before = dsk.fused_decode_attention.launches
    o, kc, vc = dsk.fused_decode_attention(*args, logit_softcap=softcap)
    o2, _, _ = dsk.fused_decode_attention(*args, logit_softcap=softcap)
    orf, kr, vr = fused_decode_attention_ref(*args, logit_softcap=softcap)
    torch.cuda.synchronize()
    assert dsk.fused_decode_attention.launches == before + 2
    assert torch.equal(kc, kr) and torch.equal(vc, vr)
    assert torch.equal(args[3], old[0]) and torch.equal(args[4], old[1])
    torch.testing.assert_close(o.float(), orf.float(), rtol=TOL, atol=TOL)
    assert torch.equal(o, o2), "the kernel must be deterministic"


def test_superkernel_wrappers_reject_what_the_kernels_do_not_take(gen):
    x, rw, bias, soe, sg, su, sd = _moe_args(gen, 4, 64, 8, 32, 4, 4)
    with pytest.raises(TypeError):
        dsk.fused_moe_entry(x.half(), rw, bias, soe, sg.half(), su.half(),
                            sd.half(), top_k=2)
    with pytest.raises(TypeError):
        dsk.fused_moe_entry(x.float(), rw, bias, soe, sg, su, sd, top_k=2)
    with pytest.raises(TypeError):
        dsk.fused_moe_entry(x, rw, bias, soe.long(), sg, su, sd, top_k=2)
    with pytest.raises(ValueError):
        dsk.fused_moe_entry(x, rw, bias, soe, sg.transpose(1, 2), su, sd,
                            top_k=2)
    with pytest.raises(ValueError):
        dsk.fused_moe_entry(x, rw.cpu(), bias, soe, sg, su, sd, top_k=2)
    wide = torch.zeros((4, 128), device="cuda").bfloat16()[:, ::2]
    with pytest.raises(ValueError):
        dsk.fused_moe_entry(wide, rw, bias, soe, sg, su, sd, top_k=2)
    r = lambda *s: torch.randn(s, generator=gen,  # noqa: E731
                               device="cuda").bfloat16()
    q, kn, vn = r(2, 1, 4, 32), r(2, 1, 2, 32), r(2, 1, 2, 32)
    kc, vc = r(2, 16, 2, 32), r(2, 16, 2, 32)
    clen = torch.tensor([3, 9], device="cuda")
    with pytest.raises(TypeError):
        dsk.fused_decode_attention(q.half(), kn.half(), vn.half(), kc.half(),
                                   vc.half(), clen)
    with pytest.raises(TypeError):
        dsk.fused_decode_attention(q.float(), kn, vn, kc, vc, clen)
    with pytest.raises(TypeError):
        dsk.fused_decode_attention(q, kn, vn, kc, vc, clen.int())
    with pytest.raises(ValueError):
        dsk.fused_decode_attention(q, kn, vn, kc[:, :8], vc, clen)
    with pytest.raises(ValueError):
        dsk.fused_decode_attention(q, kn.cpu(), vn, kc, vc, clen)
    with pytest.raises(ValueError):
        dsk.fused_decode_attention(q, kn, vn, kc.transpose(1, 2)
                                   .contiguous().transpose(1, 2), vc, clen)


def sk_reference_decode_step(eng, tok, state, tail_kernel=True):
    """The fully-resident oracle of the superkernel path: the engine's own
    segment functions over every expert of each layer with the identity
    slot table, then its trailing dense layers where it has them, each
    through `layer_decode` (their attention kernels when `tail_kernel`,
    else the plain path), and the model's logits."""
    segs, tail = eng._sk_segments()
    caches, clen = list(state.caches), state.cache_len
    x = torch.as_tensor(tok, device=eng.device)
    logits = None
    for li, seg in enumerate(segs):
        x, _, new_cs, logits = eng._sk_seg(
            seg, [eng._p[j] for j in seg], [caches[j] for j in seg], x, clen,
            eng._full_experts(li), eng._ident_map, eng._router_stack[:0],
            eng._zero_bias, first=li == 0,
            with_logits=li == len(segs) - 1 and not tail)
        for jj, aj in enumerate(seg):
            caches[aj] = new_cs[jj]
    for j in tail:      # layer by layer, not through the engine's tail
        x, caches[j] = layer_decode(eng._p[j], eng.cfg, eng.specs[j], x,
                                    caches[j], clen, use_kernel=tail_kernel)
    if tail:
        logits = eng.model.logits(eng.params, x[:, -1])
    return logits, DecodeState(caches, clen + 1, pos=state.pos + 1)


def test_superkernel_slot_path_bitwise_vs_oracle_on_the_card(gen):
    cfg = reduce_config(get_config("olmoe-1b-7b"), layers=4, d_model=64,
                        heads=4, kv_heads=4, d_ff=128, vocab=512, experts=8,
                        top_k=2, d_expert=32)
    model = Model(cfg)
    params = model.init(gen, device="cuda")
    eng = SlotBufferEngine(cfg, params, model, n_slots_per_layer=3,
                           use_kernel=True, use_superkernel=True, max_seq=64,
                           step_size=1, pregate_margin=0)
    rng = np.random.default_rng(0)
    n0 = dsk.fused_moe_entry.launches
    for _ in range(2):
        prompt = rng.integers(0, cfg.vocab_size, (2, 9))
        lg, st = eng.prefill(prompt)
        lr, sr = eng.reference_prefill(prompt)
        assert torch.equal(lg, lr)
        tok = lr.argmax(-1)
        for _ in range(8):
            lg, st = eng.decode_step(tok, st)
            lr, sr = sk_reference_decode_step(eng, tok, sr)
            assert torch.equal(lg, lr)
            tok = lr.argmax(-1)
    eng.synchronize()
    assert dsk.fused_moe_entry.launches > n0
    assert eng.stats.replays > 0 and eng.stats.evictions > 0


# ---------------------------------------------------------------------------
# MLA decode attention (DeepSeek-V2-Lite)
# ---------------------------------------------------------------------------

def _mla_args(g, clens, S, H, R, P):
    dev = "cuda"
    B = len(clens)
    f = lambda *s: torch.randn(s, generator=g, device=dev)  # noqa: E731
    return (f(B, H, R) * 0.3, f(B, H, P) * 0.3, f(B, R).bfloat16(),
            f(B, P).bfloat16(), f(B, S, R).bfloat16(), f(B, S, P).bfloat16(),
            torch.tensor(clens, device=dev))


@pytest.mark.parametrize("case", [([0, 63, 128, 255], 256, 16, 512, 64),
                                  ([255], 256, 16, 512, 64),
                                  ([3, 0, 31], 32, 4, 32, 8),
                                  ([100, 7], 130, 3, 40, 16)],
                         ids=["deepseek_decode", "deepseek_S-1", "reduced",
                              "off_tile"])
def test_fused_mla_decode_attention_kernel_matches_plain_version(gen, case):
    """Caches bitwise equal, ctx within 2e-4 (fp32 throughout; only the
    summation order differs)."""
    clens, S, H, R, P = case
    args = _mla_args(gen, clens, S, H, R, P)
    scale = 192 ** -0.5
    old = [a.clone() for a in args[4:6]]
    before = dsk.fused_mla_decode_attention.launches
    ctx, lat, pe = dsk.fused_mla_decode_attention(*args, scale=scale)
    ctx2, _, _ = dsk.fused_mla_decode_attention(*args, scale=scale)
    cr, lr, pr = fused_mla_decode_attention_ref(*args, scale=scale)
    torch.cuda.synchronize()
    assert dsk.fused_mla_decode_attention.launches == before + 2
    assert torch.equal(lat, lr) and torch.equal(pe, pr)
    assert torch.equal(args[4], old[0]) and torch.equal(args[5], old[1])
    torch.testing.assert_close(ctx, cr, rtol=2e-4, atol=2e-4)
    assert torch.equal(ctx, ctx2), "the kernel must be deterministic"


def test_fused_mla_decode_attention_wrapper_rejects(gen):
    q, qp, cn, pn, lat, pe, clen = _mla_args(gen, [3, 9], 16, 4, 32, 8)
    call = dsk.fused_mla_decode_attention
    with pytest.raises(TypeError):
        call(q.bfloat16(), qp, cn, pn, lat, pe, clen, scale=0.2)
    with pytest.raises(TypeError):
        call(q, qp, cn.half(), pn.half(), lat.half(), pe.half(), clen,
             scale=0.2)
    with pytest.raises(TypeError):
        call(q, qp, cn.float(), pn, lat, pe, clen, scale=0.2)
    with pytest.raises(TypeError):
        call(q, qp, cn, pn, lat, pe, clen.int(), scale=0.2)
    with pytest.raises(ValueError):
        call(q, qp, cn, pn, lat[:, :8], pe, clen, scale=0.2)
    with pytest.raises(ValueError):
        call(q, qp, cn, pn, lat, pe.cpu(), clen, scale=0.2)
    with pytest.raises(ValueError):
        call(q.transpose(1, 2).contiguous().transpose(1, 2), qp, cn, pn, lat,
             pe, clen, scale=0.2)
    for bad in ([3, 16], [-1, 2]):
        with pytest.raises(ValueError, match="does not fit"):
            call(q, qp, cn, pn, lat, pe, torch.tensor(bad, device="cuda"),
                 scale=0.2)
    with pytest.raises(ValueError, match="does not fit"):
        call(q, qp, cn, pn, lat, pe, torch.tensor(16, device="cuda"),
             scale=0.2)


@pytest.mark.parametrize("superkernel", [False, True],
                         ids=["unfused", "superkernel"])
def test_deepseek_slot_paths_bitwise_vs_oracle_on_the_card(gen, superkernel):
    """Reduced DeepSeek-V2-Lite (1 dense + 3 MoE layers, MLA, shared
    experts) on both decode paths against their fully-resident oracles."""
    cfg = reduce_config(get_config("deepseek-v2-lite"), layers=4, d_model=64,
                        heads=4, kv_heads=4, d_ff=128, vocab=512, experts=8,
                        top_k=2, d_expert=32)
    model = Model(cfg)
    params = model.init(gen, device="cuda")
    eng = SlotBufferEngine(cfg, params, model, n_slots_per_layer=3,
                           use_kernel=True, use_superkernel=superkernel,
                           max_seq=64, step_size=1, pregate_margin=0)
    step_ref = (lambda t, s: sk_reference_decode_step(eng, t, s)) \
        if superkernel else eng.reference_decode_step
    rng = np.random.default_rng(0)
    n0 = dsk.fused_mla_decode_attention.launches
    for _ in range(2):
        prompt = rng.integers(0, cfg.vocab_size, (2, 9))
        lg, st = eng.prefill(prompt)
        lr, sr = eng.reference_prefill(prompt)
        assert torch.equal(lg, lr)
        tok = lr.argmax(-1)
        for _ in range(8):
            lg, st = eng.decode_step(tok, st)
            lr, sr = step_ref(tok, sr)
            assert torch.equal(lg, lr)
            for a, b in zip(st.caches, sr.caches):
                assert torch.equal(a["latent"], b["latent"])
            tok = lr.argmax(-1)
    eng.synchronize()
    assert (dsk.fused_mla_decode_attention.launches > n0) == superkernel
    assert eng.stats.replays > 0 and eng.stats.evictions > 0


# ---------------------------------------------------------------------------
# the kernel API: topk_gating and expert_ffn
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,E,k", [(4, 64, 8), (100, 16, 4), (33, 128, 8),
                                   (256, 256, 8), (7, 8, 8), (5, 256, 256)])
def test_topk_kernel_matches_plain_version(gen, T, E, k, dtype):
    logits = torch.randn((T, E), generator=gen, device="cuda").to(dtype)
    for norm in (True, False):
        before = ops.topk.launches
        g, i = ops.topk(logits, k, norm=norm)
        gr, ir = topk_gating_ref(logits, k, norm)
        torch.cuda.synchronize()
        assert ops.topk.launches == before + 1
        assert torch.equal(i, ir)
        torch.testing.assert_close(g, gr, rtol=1e-5, atol=1e-6)
    if k == E:                   # every index once; the mask never wins
        assert torch.equal(i.sort(-1).values,
                           torch.arange(E, device="cuda",
                                        dtype=torch.int32).expand(T, E))


def test_topk_kernel_ties_go_to_the_lowest_index(gen):
    tied = torch.zeros((4, 64), device="cuda")
    g, i = ops.topk(tied, 8)
    assert torch.equal(i, torch.arange(8, device="cuda",
                                       dtype=torch.int32).expand(4, 8))
    torch.testing.assert_close(g, torch.full_like(g, 1 / 8), rtol=1e-6,
                               atol=0)
    pairs = torch.randn((9, 32), generator=gen, device="cuda")
    pairs = pairs.repeat_interleave(2, dim=1)            # E = 64, tied pairs
    g, i = ops.topk(pairs, 6)
    gr, ir = topk_gating_ref(pairs, 6)
    assert torch.equal(i, ir) and bool((i[:, 0::2] % 2 == 0).all())
    torch.testing.assert_close(g, gr, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("E,k", [(8, 8), (60, 4), (64, 8), (128, 8),
                                 (256, 16)])
@pytest.mark.parametrize("kind", ["negative", "large", "tied_rows"])
def test_topk_kernel_at_every_lane_width(gen, E, k, dtype, kind):
    """Each of the kernel's widths (1, 2, 4 and 8 entries a lane, and E = 60
    with a ragged last lane) on logits far below zero, of large magnitude
    (a probability that underflows to 0 still ranks above a chosen entry),
    and with whole rows tied: ids equal to the plain version's."""
    x = torch.randn((65, E), generator=gen, device="cuda")
    if kind == "negative":
        x = x - 80.0
    elif kind == "large":
        x = x * 1e3
    else:
        x[::3] = 0.0                    # every third row tied throughout
        x[1::3] = -7.5
    x = x.to(dtype)
    g, i = ops.topk(x, k)
    gr, ir = topk_gating_ref(x, k)
    torch.cuda.synchronize()
    assert g.is_contiguous() and i.is_contiguous()
    assert torch.equal(i, ir)
    torch.testing.assert_close(g, gr, rtol=1e-5, atol=1e-6)
    if kind == "tied_rows":
        want = torch.arange(k, device="cuda", dtype=torch.int32)
        assert torch.equal(i[::3], want.expand_as(i[::3]))


def test_topk_kernel_takes_no_rows(gen):
    g, i = ops.topk(torch.zeros((0, 64), device="cuda"), 8)
    assert g.shape == (0, 8) and i.shape == (0, 8) and i.dtype == torch.int32


def test_topk_wrapper_rejects_what_the_kernel_does_not_take(gen):
    with pytest.raises(TypeError):
        ops.topk(torch.zeros((4, 8), device="cuda", dtype=torch.float16), 2)
    with pytest.raises(ValueError):
        ops.topk(torch.zeros((4, 257), device="cuda"), 2)
    with pytest.raises(ValueError):
        ops.topk(torch.zeros((4, 8), device="cuda"), 9)
    with pytest.raises(ValueError):
        ops.topk(torch.zeros((8, 4), device="cuda").t(), 2)


def _ffn_inputs(g, E, C, D, F):
    x = torch.randn((E, C, D), generator=g, device="cuda").bfloat16()
    w = lambda *s: (torch.randn(s, generator=g, device="cuda")  # noqa: E731
                    * s[-2] ** -0.5).bfloat16()
    return x, w(E, D, F), w(E, D, F), w(E, F, D)


@pytest.mark.parametrize("shape", [(8, 128, 256, 128), (3, 40, 64, 48),
                                   (2, 1, 136, 72), (64, 128, 2048, 1024)])
def test_expert_ffn_kernel_matches_plain_version(gen, shape):
    args = _ffn_inputs(gen, *shape)
    before = ops.expert_ffn.launches
    got = ops.expert_ffn(*args)
    again = ops.expert_ffn(*args)
    want = expert_ffn_ref(*args)
    torch.cuda.synchronize()
    assert ops.expert_ffn.launches == before + 2
    torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)
    assert torch.equal(got, again), "the kernel must be deterministic"


def test_slot_ffn_identity_table_equals_expert_ffn_bitwise(gen):
    x, wg, wu, wd = _ffn_inputs(gen, 4, 128, 64, 128)
    ident = torch.arange(4, dtype=torch.int32, device="cuda")
    assert torch.equal(ops.slot_ffn(x, ident, wg, wu, wd),
                       ops.expert_ffn(x, wg, wu, wd))


def test_expert_ffn_wrapper_rejects_what_the_kernel_does_not_take(gen):
    x, wg, wu, wd = _ffn_inputs(gen, 2, 4, 64, 32)
    with pytest.raises(TypeError):
        ops.expert_ffn(x.half(), wg.half(), wu.half(), wd.half())
    with pytest.raises(TypeError):
        ops.expert_ffn(x.float(), wg, wu, wd)
    with pytest.raises(ValueError):
        ops.expert_ffn(x, wg.transpose(1, 2), wu, wd)
    x2, wg2, wu2, wd2 = _ffn_inputs(gen, 2, 4, 60, 32)
    with pytest.raises(ValueError):
        ops.expert_ffn(x2, wg2, wu2, wd2)


# ---------------------------------------------------------------------------
# chunked prefill on the card
# ---------------------------------------------------------------------------

def test_chunked_prefill_bitwise_vs_oracle_on_the_card(gen):
    cfg = get_smoke_config("olmoe-1b-7b")
    model = Model(cfg)
    params = model.init(gen, device="cuda")
    eng = SlotBufferEngine(cfg, params, model, n_slots_per_layer=4,
                           use_kernel=True, step_size=1)
    rng = np.random.default_rng(1)
    before = slot_gather.slot_ffn.launches
    n_chunks = 0
    for T, C in ((23, 8), (9, 32), (40, 16)):
        prompt = rng.integers(0, cfg.vocab_size, (1, T))
        lc, _ = eng.prefill_chunked(prompt, chunk_size=C)
        n_chunks += -(-T // C)
        lr, _ = eng.reference_prefill_chunked(prompt, chunk_size=C)
        assert torch.equal(lc, lr), f"T={T} C={C}"
    eng.synchronize()
    assert eng.stats.evictions > 0 and eng.stats.copy_s > 0
    # every chunk launched the kernel once per MoE layer (and the oracle
    # once more)
    assert slot_gather.slot_ffn.launches - before == \
        2 * n_chunks * len(eng.moe_layer_ids)


# ---------------------------------------------------------------------------
# the f32 paths: each kernel in f32 against its plain version, to the
# reference's own f32 tolerance (2e-5); caches bitwise equal
# ---------------------------------------------------------------------------

TOL_F32 = 2e-5


def _f32(*ts):
    return tuple(t.float() if t.is_floating_point() else t for t in ts)


@pytest.mark.parametrize("shape", [(4, 1, 8, 64, 2048, 1024, 256),
                                   (1, 5, 2, 3, 96, 40, 4)],
                         ids=["decode", "ragged"])
def test_slot_ffn_f32_matches_plain_version(gen, shape):
    args, counts = _routed_inputs(gen, *shape)
    args = _f32(*args)
    got = slot_gather.slot_ffn(*args, counts=counts)
    again = slot_gather.slot_ffn(*args, counts=counts)
    every_row = slot_gather.slot_ffn(*args)
    want = slot_ffn_ref(*args, counts=counts)
    torch.cuda.synchronize()
    live = (torch.arange(args[0].shape[1], device="cuda")[None, :]
            < counts.long()[:, None])[..., None]
    counted = lambda y: torch.where(live, y, 0)  # noqa: E731
    torch.testing.assert_close(counted(got), want, rtol=TOL_F32,
                               atol=TOL_F32)
    torch.testing.assert_close(every_row, slot_ffn_ref(*args),
                               rtol=TOL_F32, atol=TOL_F32)
    assert torch.equal(counted(got), counted(again))
    assert torch.equal(counted(got), counted(every_row))


@pytest.mark.parametrize("shape", [(3, 40, 64, 48), (8, 128, 256, 128)])
def test_expert_ffn_f32_matches_plain_version(gen, shape):
    args = _f32(*_ffn_inputs(gen, *shape))
    got = ops.expert_ffn(*args)
    want = expert_ffn_ref(*args)
    ident = torch.arange(shape[0], dtype=torch.int32, device="cuda")
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=TOL_F32, atol=TOL_F32)
    assert torch.equal(got, ops.slot_ffn(args[0], ident, *args[1:]))


@pytest.mark.parametrize("case", [(4, 2048, 64, 1024, 256, 16, 8),
                                  (5, 48, 8, 72, 6, 5, 2),
                                  (128, 2048, 64, 1024, 256, 64, 8)],
                         ids=["decode_16_resident", "off_tile",
                              "t128_wgmma_route"])
def test_fused_moe_entry_f32_matches_plain_version(gen, case):
    T, d, E, f, S, n_res, k = case
    args = _f32(*_moe_args(gen, T, d, E, f, S, n_res))
    y, g, i = dsk.fused_moe_entry(*args, top_k=k)
    y2, g2, i2 = dsk.fused_moe_entry(*args, top_k=k)
    yr, gr, ir = fused_moe_entry_ref(*args, top_k=k)
    torch.cuda.synchronize()
    assert torch.equal(i, ir)
    torch.testing.assert_close(g, gr, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(y, yr, rtol=TOL_F32, atol=TOL_F32)
    assert torch.equal(y, y2) and torch.equal(g, g2) and torch.equal(i, i2)


@pytest.mark.parametrize("softcap", [0.0, 30.0])
def test_fused_decode_attention_f32_matches_plain_version(gen, softcap):
    clens, Hq, Hkv, S, D = [0, 63, 128, 300], 8, 2, 256, 128
    r = lambda *s: torch.randn(s, generator=gen, device="cuda")  # noqa: E731
    B = len(clens)
    args = (r(B, 1, Hq, D), r(B, 1, Hkv, D), r(B, 1, Hkv, D),
            r(B, S, Hkv, D), r(B, S, Hkv, D),
            torch.tensor(clens, device="cuda"))
    o, kc, vc = dsk.fused_decode_attention(*args, logit_softcap=softcap)
    orf, kr, vr = fused_decode_attention_ref(*args, logit_softcap=softcap)
    torch.cuda.synchronize()
    assert o.dtype == torch.float32
    assert torch.equal(kc, kr) and torch.equal(vc, vr)
    torch.testing.assert_close(o, orf, rtol=TOL_F32, atol=TOL_F32)


@pytest.mark.parametrize("case", [([0, 63, 128, 255], 256, 16, 512, 64),
                                  ([100, 7], 130, 3, 40, 16)],
                         ids=["deepseek_decode", "off_tile"])
def test_fused_mla_decode_attention_f32_matches_plain_version(gen, case):
    clens, S, H, R, P = case
    args = _f32(*_mla_args(gen, clens, S, H, R, P))
    ctx, lat, pe = dsk.fused_mla_decode_attention(*args, scale=0.1)
    ctx2, _, _ = dsk.fused_mla_decode_attention(*args, scale=0.1)
    cr, lr, pr = fused_mla_decode_attention_ref(*args, scale=0.1)
    torch.cuda.synchronize()
    assert lat.dtype == torch.float32
    assert torch.equal(lat, lr) and torch.equal(pe, pr)
    torch.testing.assert_close(ctx, cr, rtol=TOL_F32, atol=TOL_F32)
    assert torch.equal(ctx, ctx2)


# ---------------------------------------------------------------------------
# the redesigned fused_moe_entry and fused_mla_decode_attention
# ---------------------------------------------------------------------------

def test_mla_wrapper_with_the_host_bound_never_synchronises(gen):
    args = _mla_args(gen, [0, 63, 128, 255], 256, 16, 512, 64)
    want = dsk.fused_mla_decode_attention(*args, scale=0.1)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = dsk.fused_mla_decode_attention(*args, scale=0.1, max_len=255)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def _nan_fill_allocator():
    """Fill the caching allocator's free blocks with NaN, so scratch and
    outputs a kernel leaves unwritten show up."""
    junk = [torch.full((1 << n,), float("nan"), device="cuda")
            for n in range(10, 25) for _ in range(4)]
    del junk


@pytest.mark.parametrize("case", [(4, 2048, 64, 1024, 256, 16, 8),
                                  (64, 2048, 64, 1024, 256, 64, 8),
                                  (3, 64, 8, 72, 4, 0, 2)],
                         ids=["decode_16_resident", "t64_all_resident",
                              "none_resident"])
def test_fused_moe_entry_over_nan_filled_scratch(gen, case):
    """Every y element is written (tokens with no resident expert get 0),
    the work list is rebuilt each call, the result is the same from run to
    run, and a weight slab is read once whatever an expert's row count
    (T = 64: up to 64 rows an expert, same bits as the plain version's
    tolerance allows)."""
    T, d, E, f, S, n_res, k = case
    args = _moe_args(gen, T, d, E, f, S, n_res)
    _nan_fill_allocator()
    y, g, i = dsk.fused_moe_entry(*args, top_k=k)
    _nan_fill_allocator()
    y2, g2, i2 = dsk.fused_moe_entry(*args, top_k=k)
    yr, gr, ir = fused_moe_entry_ref(*args, top_k=k)
    torch.cuda.synchronize()
    assert torch.isfinite(y).all() and torch.isfinite(g).all()
    assert torch.equal(i, ir)
    torch.testing.assert_close(y, yr, rtol=TOL, atol=TOL)
    assert torch.equal(y, y2) and torch.equal(g, g2) and torch.equal(i, i2)
    if n_res == 0:
        assert not y.any() and not g.any()


@pytest.mark.parametrize("clens", [[0, 63, 128, 255], [255] * 4, [0] * 4])
def test_fused_mla_decode_attention_over_nan_filled_scratch(gen, clens):
    """Every ctx element and every position of the new caches is written,
    and the split merge gives the same bits from run to run."""
    args = _mla_args(gen, clens, 256, 16, 512, 64)
    _nan_fill_allocator()
    ctx, lat, pe = dsk.fused_mla_decode_attention(*args, scale=0.1)
    _nan_fill_allocator()
    ctx2, lat2, pe2 = dsk.fused_mla_decode_attention(*args, scale=0.1)
    cr, lr, pr = fused_mla_decode_attention_ref(*args, scale=0.1)
    torch.cuda.synchronize()
    assert torch.isfinite(ctx).all()
    assert torch.equal(lat, lr) and torch.equal(pe, pr)
    torch.testing.assert_close(ctx, cr, rtol=2e-4, atol=2e-4)
    assert torch.equal(ctx, ctx2) and torch.equal(lat, lat2)


# ---------------------------------------------------------------------------
# the redesigned fused_decode_attention (split-S over a cluster) and the
# 3xTF32 f32 SwiGLU GEMM
# ---------------------------------------------------------------------------

def _attn_args(g, clens, S, Hq, Hkv, D, dtype=torch.bfloat16):
    B = 4 if isinstance(clens, int) else len(clens)
    r = lambda *s: torch.randn(s, generator=g,  # noqa: E731
                               device="cuda").to(dtype)
    return (r(B, 1, Hq, D), r(B, 1, Hkv, D), r(B, 1, Hkv, D),
            r(B, S, Hkv, D), r(B, S, Hkv, D),
            torch.tensor(clens, device="cuda"))


ATTN_SPLIT_CASES = {
    # name: (cache lengths, or one int for a () length; S, Hq, Hkv, D)
    "s130": ([0, 129, 70, 300], 130, 16, 16, 128),
    "s2048": ([0, 511, 1500, 2047], 2048, 16, 16, 128),
    "g16_d64_empty": ([0, 0, 0, 0], 256, 32, 2, 64),
    "g16_d256_empty": ([0, 0, 0, 0], 256, 32, 2, 256),
    "one_length": (100, 256, 16, 4, 128),
    "s_below_splits": ([0, 2, 7], 5, 8, 2, 64),
}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("softcap", [0.0, 30.0])
@pytest.mark.parametrize("case", list(ATTN_SPLIT_CASES))
def test_fused_decode_attention_split_cases(gen, case, softcap, dtype):
    args = _attn_args(gen, *ATTN_SPLIT_CASES[case], dtype=dtype)
    old = [a.clone() for a in args[3:5]]
    o, kc, vc = dsk.fused_decode_attention(*args, logit_softcap=softcap)
    o2, _, _ = dsk.fused_decode_attention(*args, logit_softcap=softcap)
    orf, kr, vr = fused_decode_attention_ref(*args, logit_softcap=softcap)
    torch.cuda.synchronize()
    tol = TOL if dtype == torch.bfloat16 else TOL_F32
    assert torch.equal(kc, kr) and torch.equal(vc, vr)
    assert torch.equal(args[3], old[0]) and torch.equal(args[4], old[1])
    torch.testing.assert_close(o.float(), orf.float(), rtol=tol, atol=tol)
    assert torch.equal(o, o2), "the kernel must be deterministic"


@pytest.mark.parametrize("case", ["decode", "s2048", "s_below_splits"])
def test_fused_decode_attention_over_nan_filled_outputs(gen, case):
    """Every element of out and of the new caches is written, whatever the
    lengths, and the split merge gives the same bits from run to run."""
    spec = {"decode": ([0, 63, 128, 255], 256, 16, 16, 128)}
    args = _attn_args(gen, *{**ATTN_SPLIT_CASES, **spec}[case])
    _nan_fill_allocator()
    o, kc, vc = dsk.fused_decode_attention(*args, logit_softcap=30.0)
    _nan_fill_allocator()
    o2, kc2, vc2 = dsk.fused_decode_attention(*args, logit_softcap=30.0)
    orf, kr, vr = fused_decode_attention_ref(*args, logit_softcap=30.0)
    torch.cuda.synchronize()
    assert torch.isfinite(o).all()
    assert torch.equal(kc, kr) and torch.equal(vc, vr)
    torch.testing.assert_close(o.float(), orf.float(), rtol=TOL, atol=TOL)
    assert torch.equal(o, o2) and torch.equal(kc, kc2) and torch.equal(vc, vc2)


def test_fused_decode_attention_wrapper_never_synchronises(gen):
    args = _attn_args(gen, [0, 63, 128, 255], 256, 16, 4, 128)
    want = dsk.fused_decode_attention(*args)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = dsk.fused_decode_attention(*args)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_expert_ffn_f32_at_olmoe_width(gen):
    """The 3xTF32 GEMM at 128 rows an expert: within the reference's f32
    tolerance, deterministic, and `slot_ffn` under the identity table gives
    the same bits."""
    args = _f32(*_ffn_inputs(gen, 64, 128, 2048, 1024))
    got = ops.expert_ffn(*args)
    again = ops.expert_ffn(*args)
    ident = torch.arange(64, dtype=torch.int32, device="cuda")
    via_slots = ops.slot_ffn(args[0], ident, *args[1:])
    want = expert_ffn_ref(*args)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=TOL_F32, atol=TOL_F32)
    assert torch.equal(got, again) and torch.equal(got, via_slots)


@pytest.mark.parametrize("shape", [(4, 1, 8, 64, 2048, 1024, 256),
                                   (1, 32, 8, 64, 2048, 1024, 256),
                                   (1, 128, 6, 64, 2048, 1408, 416)],
                         ids=["decode", "chunk", "deepseek_prefill"])
def test_slot_ffn_f32_with_empty_and_absent_experts(gen, shape):
    """Half the experts absent (routed ones among them) and the unrouted
    ones empty: the counted rows within 2e-5 and bitwise equal to the
    all-rows call's, deterministic."""
    args, counts = _routed_inputs(gen, *shape)
    args = _f32(*args)
    assert int((counts == 0).sum()) > 0 and int(counts.sum()) > 0
    got = slot_gather.slot_ffn(*args, counts=counts)
    again = slot_gather.slot_ffn(*args, counts=counts)
    every_row = slot_gather.slot_ffn(*args)
    want = slot_ffn_ref(*args, counts=counts)
    torch.cuda.synchronize()
    live = (torch.arange(args[0].shape[1], device="cuda")[None, :]
            < counts.long()[:, None])[..., None]
    counted = lambda y: torch.where(live, y, 0)  # noqa: E731
    torch.testing.assert_close(counted(got), want, rtol=TOL_F32,
                               atol=TOL_F32)
    assert torch.equal(counted(got), counted(again))
    assert torch.equal(counted(got), counted(every_row))


@pytest.mark.parametrize("shape", [(3, 40, 64, 48), (2, 128, 64, 48)],
                         ids=["mma_sync_route", "wgmma_route"])
def test_f32_gemm_keeps_a_nan_of_any_payload(gen, shape):
    """A NaN in x makes its row's output NaN on both routes, as in the plain
    fp32 chain, whatever its payload bits (0x7FFFFFFF is the NaN the GPU's
    own arithmetic produces); the other rows stay finite and close."""
    args = list(_f32(*_ffn_inputs(gen, *shape)))
    x = args[0].clone()
    bits = x.view(torch.int32)
    bits[0, 1, 5] = 0x7FFFFFFF
    bits[1, 2, 7] = -1                                      # 0xFFFFFFFF
    bits[1, 3, 0] = 0x7F800001
    args[0] = x
    got = ops.expert_ffn(*args)
    want = expert_ffn_ref(*args)
    torch.cuda.synchronize()
    nan_rows = torch.zeros(got.shape[:2], dtype=torch.bool, device="cuda")
    nan_rows[0, 1] = nan_rows[1, 2] = nan_rows[1, 3] = True
    assert torch.isnan(got[nan_rows]).all()
    assert torch.isfinite(got[~nan_rows]).all()
    torch.testing.assert_close(got, want, rtol=TOL_F32, atol=TOL_F32,
                               equal_nan=True)


# ---------------------------------------------------------------------------
# the reference's Qwen MoE configs: the serving kernels at their shapes, and
# an empty work list (no routed expert resident, as under a total outage)
# ---------------------------------------------------------------------------

QWEN_ATTN = {
    # name: (cache lengths; S, Hq, Hkv, D): decode at batch 4
    "qwen2_G7": ([0, 63, 128, 255], 256, 28, 4, 128),
    "qwen3_G16": ([0, 63, 128, 255], 256, 64, 4, 128),
    "qwen3_G16_wrapped": ([256, 300, 511, 1000], 256, 64, 4, 128),
}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("case", list(QWEN_ATTN))
def test_fused_decode_attention_at_qwen_groups(gen, case, dtype):
    args = _attn_args(gen, *QWEN_ATTN[case], dtype=dtype)
    old = [a.clone() for a in args[3:5]]
    _nan_fill_allocator()
    o, kc, vc = dsk.fused_decode_attention(*args)
    o2, _, _ = dsk.fused_decode_attention(*args)
    orf, kr, vr = fused_decode_attention_ref(*args)
    torch.cuda.synchronize()
    tol = TOL if dtype == torch.bfloat16 else TOL_F32
    assert torch.isfinite(o).all()
    assert torch.equal(kc, kr) and torch.equal(vc, vr)
    assert torch.equal(args[3], old[0]) and torch.equal(args[4], old[1])
    torch.testing.assert_close(o.float(), orf.float(), rtol=tol, atol=tol)
    assert torch.equal(o, o2), "the kernel must be deterministic"


QWEN_MOE = {
    # name: (T, d, E, f, slots, resident, k): decode at batch 4
    "qwen15_16_resident": (4, 2048, 60, 1408, 16, 16, 4),
    "qwen15_all_resident": (4, 2048, 60, 1408, 60, 60, 4),
    "qwen2_16_resident": (4, 3584, 64, 2560, 16, 16, 8),
    "qwen2_all_resident": (4, 3584, 64, 2560, 64, 64, 8),
    "qwen3_16_resident": (4, 4096, 128, 1536, 16, 16, 8),
    "qwen3_all_resident": (4, 4096, 128, 1536, 128, 128, 8),
}


@pytest.mark.parametrize("case", list(QWEN_MOE))
def test_fused_moe_entry_at_qwen_shapes(gen, case):
    T, d, E, f, S, n_res, k = QWEN_MOE[case]
    args = _moe_args(gen, T, d, E, f, S, n_res)
    _nan_fill_allocator()
    y, g, i = dsk.fused_moe_entry(*args, top_k=k)
    y2, g2, i2 = dsk.fused_moe_entry(*args, top_k=k)
    yr, gr, ir = fused_moe_entry_ref(*args, top_k=k)
    torch.cuda.synchronize()
    assert torch.isfinite(y).all()
    assert torch.equal(i, ir)
    torch.testing.assert_close(g, gr, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(y, yr, rtol=TOL, atol=TOL)
    assert torch.equal(y, y2) and torch.equal(g, g2) and torch.equal(i, i2)


@pytest.mark.parametrize("shape", [(4, 1, 4, 60, 2048, 1408, 64),
                                   (1, 32, 4, 60, 2048, 1408, 64),
                                   (4, 1, 8, 64, 3584, 2560, 64),
                                   (1, 32, 8, 64, 3584, 2560, 64),
                                   (4, 1, 8, 128, 4096, 1536, 128),
                                   (1, 32, 8, 128, 4096, 1536, 128)],
                         ids=["qwen15_decode", "qwen15_chunk", "qwen2_decode",
                              "qwen2_chunk", "qwen3_decode", "qwen3_chunk"])
def test_slot_ffn_with_counts_at_qwen_shapes(gen, shape):
    args, counts = _routed_inputs(gen, *shape)
    got = slot_gather.slot_ffn(*args, counts=counts)
    again = slot_gather.slot_ffn(*args, counts=counts)
    want = slot_ffn_ref(*args, counts=counts)
    torch.cuda.synchronize()
    live = (torch.arange(args[0].shape[1], device="cuda")[None, :]
            < counts.long()[:, None])[..., None]
    assert int(counts.sum()) > 0
    counted = lambda y: torch.where(live, y, 0)  # noqa: E731
    torch.testing.assert_close(counted(got), want, rtol=TOL, atol=TOL)
    assert torch.equal(counted(got), counted(again)), "not deterministic"


def _cpu(tree):
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    return tree.cpu()


def _qwen_moe_layer(g, arch, T):
    """A Qwen layer's MoE params at its published width (qwen1.5 with its
    fused shared experts, qwen3 with none), tokens, and an empty slot
    buffer's table: no routed expert resident."""
    cfg = get_config(arch)
    d = cfg.d_model
    params = moe.init_moe_params(d, cfg.moe, torch.bfloat16, generator=g,
                                 device="cuda")
    slots = {k: params[k][:16].contiguous()
             for k in ("w_gate", "w_up", "w_down")}
    x = torch.randn((T, d), generator=g, device="cuda").bfloat16()
    soe = torch.full((cfg.moe.num_experts,), -1, dtype=torch.int32,
                     device="cuda")
    return cfg, params, slots, x, soe


@pytest.mark.parametrize("arch", ["qwen1.5-moe-a2.7b", "qwen3-moe-235b-a22b"])
@pytest.mark.parametrize("T", [4, 32], ids=["decode", "chunk"])
def test_slot_ffn_path_with_an_empty_work_list(gen, arch, T):
    """Every row count 0: `slot_ffn` launches, reads no weights and writes
    nothing, and the MoE layer is its shared experts alone (zero without
    them), bitwise, over NaN-filled memory: nothing stale is read."""
    cfg, params, slots, x, soe = _qwen_moe_layer(gen, arch, T)
    before = slot_gather.slot_ffn.launches
    _nan_fill_allocator()
    out, r = moe.moe_slotbuf(params, slots, soe, x, cfg.moe,
                             capacity=T * cfg.moe.top_k, use_kernel=True)
    shared_only = moe._add_shared(params, x, torch.zeros_like(x))
    plain, _ = moe.moe_slotbuf(_cpu(params), _cpu(slots), soe.cpu(),
                               x.cpu(), cfg.moe, capacity=T * cfg.moe.top_k,
                               use_kernel=True)
    torch.cuda.synchronize()
    assert slot_gather.slot_ffn.launches == before + 1
    assert torch.equal(out, shared_only)
    if not cfg.moe.num_shared_experts:
        assert not out.any()
    torch.testing.assert_close(out.float().cpu(), plain.float(), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("arch", ["qwen1.5-moe-a2.7b", "qwen3-moe-235b-a22b"])
def test_fused_moe_entry_with_an_empty_work_list(gen, arch):
    """No routed expert resident: the route launch builds an empty work
    list, the expert passes compute nothing, y is 0 and every gate 0, and
    the layer is its shared experts alone, bitwise, over NaN-filled
    scratch; the plain version agrees."""
    cfg, params, slots, x, soe = _qwen_moe_layer(gen, arch, 4)
    bias = torch.zeros(cfg.moe.num_experts, device="cuda")
    args = (x, params["router"], bias, soe, slots["w_gate"], slots["w_up"],
            slots["w_down"])
    before = dsk.fused_moe_entry.launches
    _nan_fill_allocator()
    y, g, i = dsk.fused_moe_entry(*args, top_k=cfg.moe.top_k)
    yr, gr, ir = fused_moe_entry_ref(*args, top_k=cfg.moe.top_k)
    out, _, _ = moe.moe_slotbuf_fused(params, slots, soe, x, cfg.moe)
    torch.cuda.synchronize()
    assert dsk.fused_moe_entry.launches == before + 2
    assert not y.any() and not g.any() and not yr.any()
    assert torch.equal(i, ir)
    assert torch.equal(out, moe._add_shared(params, x, torch.zeros_like(x)))


# ---------------------------------------------------------------------------
# the disk tier: page-locked pool, record reuse, engine through the tier
# ---------------------------------------------------------------------------

def _olmoe_shards(gen, tmp_path, slots=4, **kw):
    from repro_torch.core.expert_tiers import export_expert_shards
    cfg = get_smoke_config("olmoe-1b-7b")
    model = Model(cfg)
    params = model.init(gen, device="cuda")
    eng = SlotBufferEngine(cfg, params, model, n_slots_per_layer=slots,
                           use_kernel=True, **kw)
    return cfg, model, params, eng, export_expert_shards(
        eng.store, str(tmp_path / "shards"))


def test_tier_pool_records_are_page_locked(gen, tmp_path):
    from repro_torch.core.expert_tiers import TieredExpertStore
    *_, sdir = _olmoe_shards(gen, tmp_path)
    store = TieredExpertStore(sdir)
    store.attach(n_pins=8, pin_memory=True)
    assert store._blocks and all(b.is_pinned() for b in store._blocks)
    assert all(r.is_pinned() for r in store._records)
    assert store.demand_host((1, 3), 0.0) is not None
    assert all(w.is_pinned() for w in store.expert(1, 3))
    store.close()


def test_record_refilled_while_a_copy_from_it_is_queued(gen, tmp_path,
                                                       monkeypatch):
    """A host record dropped and refilled from disk while a host->device
    copy from it is still queued: the slot ends up with the first record's
    bytes (the refill waits for the copy's end event). No read-ahead
    spares, so the refill takes the dropped record."""
    from repro_torch.core import expert_tiers
    from repro_torch.core.expert_buffer import make_buffer, swap_in_many
    from repro_torch.core.expert_tiers import TieredExpertStore
    monkeypatch.setattr(expert_tiers, "READ_AHEAD", 0)
    cfg, *_, sdir = _olmoe_shards(gen, tmp_path)
    store = TieredExpertStore(sdir, host_budget_bytes=TieredExpertStore(
        sdir).expert_nbytes)
    store.attach(n_pins=0, pin_memory=True)
    assert store.capacity == 2
    a, b = (0, 1), (0, 2)
    assert store.demand_host(a, 0.0) is not None
    want = [w.clone() for w in store.expert(*a)]
    buf = make_buffer(cfg, 1, torch.bfloat16, "cuda")
    copy_stream = torch.cuda.Stream()
    torch.cuda._sleep(int(1e9))          # the copy waits behind this
    _, end = swap_in_many(buf, [0], store, [a], copy_stream)
    store.note_copies([a], end)
    assert not end.query(), "the copy ran before the record was refilled"
    assert store.demand_host(b, 1.0) is not None     # evicts a, reuses
    assert not store.host_resident(a)
    refilled = store.expert(*b)
    torch.cuda.synchronize()
    for name, w in zip(("w_gate", "w_up", "w_down"), want):
        assert torch.equal(buf[name][0].cpu(), w)
    assert not torch.equal(refilled[0], want[0])
    store.close()


@pytest.mark.parametrize("superkernel", [False, True])
def test_tiered_engine_bitwise_to_prestaged_on_the_card(gen, tmp_path,
                                                        superkernel):
    from repro_torch.core.expert_tiers import TieredExpertStore
    cfg, model, params, staged, sdir = _olmoe_shards(
        gen, tmp_path, use_superkernel=superkernel, step_size=1)
    store = TieredExpertStore(sdir, host_budget_bytes=0.5 * TieredExpertStore(
        sdir).total_expert_bytes)
    eng = SlotBufferEngine(cfg, params, model, n_slots_per_layer=4,
                           use_kernel=True, use_superkernel=superkernel,
                           step_size=1, store=store)
    rng = np.random.default_rng(0)
    for _ in range(2):
        prompt = rng.integers(0, cfg.vocab_size, (2, 9))
        lg, st = eng.prefill(prompt)
        lr, sr = staged.prefill(prompt)
        assert torch.equal(lg, lr)
        tok = lr.argmax(-1)
        for _ in range(8):
            lg, st = eng.decode_step(tok, st)
            lr, sr = staged.decode_step(tok, sr)
            assert torch.equal(lg, lr)
            tok = lr.argmax(-1)
    eng.synchronize()
    assert store.snapshot()["evictions"] > 0
    assert eng.stats.host_misses > 0 and eng.stats.copy_s > 0
    store.close()


# ---------------------------------------------------------------------------
# the attention-only models' decode shapes: minicpm3's MLA (40 heads, more
# than one block's 16) and gemma2's GQA (D 256, soft-cap 50, window ring)
# ---------------------------------------------------------------------------

MLA_HEAD_GROUPS = {
    # name: (cache lengths; S, H, R, P)
    "minicpm3_H40": ([0, 63, 128, 255], 256, 40, 256, 32),
    "minicpm3_H40_full": ([255] * 4, 256, 40, 256, 32),
    "deepseek_H16": ([0, 63, 128, 255], 256, 16, 512, 64),
    "H17_off_group": ([5, 0, 31], 32, 17, 32, 8),
}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("case", list(MLA_HEAD_GROUPS))
def test_fused_mla_decode_attention_at_every_head_count(gen, case, dtype):
    """More than 16 heads split into groups of 16 along the grid; caches
    bitwise equal, ctx within 2e-4 (f32: 2e-5), deterministic."""
    clens, S, H, R, P = MLA_HEAD_GROUPS[case]
    args = list(_mla_args(gen, clens, S, H, R, P))
    for i in (2, 3, 4, 5):
        args[i] = args[i].to(dtype)
    scale = (64 + 32) ** -0.5
    old = [a.clone() for a in args[4:6]]
    _nan_fill_allocator()
    before = dsk.fused_mla_decode_attention.launches
    ctx, lat, pe = dsk.fused_mla_decode_attention(*args, scale=scale)
    ctx2, _, _ = dsk.fused_mla_decode_attention(*args, scale=scale,
                                                max_len=max(clens))
    cr, lr, pr = fused_mla_decode_attention_ref(*args, scale=scale)
    torch.cuda.synchronize()
    assert dsk.fused_mla_decode_attention.launches == before + 2
    assert torch.equal(lat, lr) and torch.equal(pe, pr)
    assert torch.equal(args[4], old[0]) and torch.equal(args[5], old[1])
    tol = 2e-4 if dtype == torch.bfloat16 else TOL_F32
    torch.testing.assert_close(ctx, cr, rtol=tol, atol=tol)
    assert torch.equal(ctx, ctx2), "the kernel must be deterministic"


def _guarded(t, fill, guard=4096):
    """A copy of `t` inside a buffer with `guard` elements of `fill` on
    each side; returns (buffer, view)."""
    buf = torch.full((t.numel() + 2 * guard,), fill, dtype=t.dtype,
                     device=t.device)
    view = buf[guard:guard + t.numel()].view(t.shape)
    view.copy_(t)
    return buf, view


@pytest.mark.parametrize("case", ["minicpm3_H40", "deepseek_H16",
                                  "H17_off_group"])
def test_fused_mla_decode_attention_stays_inside_its_buffers(gen, case):
    """A memory check by hand: every input and output of one launch lies
    inside a buffer with guard bands on both sides (NaN for floats, a
    length past the cache for `cache_len`). No guard element is written,
    and none is read: the outputs are bitwise those of the wrapper's call
    on unguarded tensors. Then 20 launches give the same bits."""
    from repro_torch.kernels.decode_superkernel import LIBS
    clens, S, H, R, P = MLA_HEAD_GROUPS[case]
    args = _mla_args(gen, clens, S, H, R, P)
    scale = (64 + 32) ** -0.5
    ctx0, lat0, pe0 = dsk.fused_mla_decode_attention(*args, scale=scale)
    ins = [_guarded(a, float("nan")) for a in args[:6]] + \
        [_guarded(args[6], S + 12345)]
    B = len(clens)
    outs = [_guarded(torch.zeros((B, H, R), device="cuda"), float("nan")),
            _guarded(torch.zeros_like(args[4]), float("nan")),
            _guarded(torch.zeros_like(args[5]), float("nan"))]
    lib = LIBS.get("fused_mla_decode_attention")
    stream = torch.cuda.current_stream().cuda_stream
    ptrs = [v.data_ptr() for _, v in ins]
    for _ in range(20):
        for _, v in outs:
            v.zero_()
        err = lib.fused_mla_decode_attention_launch(
            *ptrs[:7], 1, *(v.data_ptr() for _, v in outs), B, S, H, R, P,
            ctypes.c_float(scale), 0, stream)
        assert err == 0
        torch.cuda.synchronize()
        for (buf, v), want in zip(outs, (ctx0, lat0, pe0)):
            assert torch.equal(v, want)
            n = (buf.numel() - v.numel()) // 2
            assert torch.isnan(buf[:n]).all() and torch.isnan(buf[-n:]).all()


def test_mla_kernel_bits_hold_beside_default_sdpa(gen):
    """At minicpm3's shape, SDPA's default backend on the yardstick's
    inputs (q = [q_abs | q_pe], k = [latent | pe] expanded over the 40
    heads, one boolean mask) runs between the kernel's calls: the kernel's
    earlier outputs are not changed by it and its later calls give the same
    bits."""
    import torch.nn.functional as Fn
    clens, S, H, R, P = MLA_HEAD_GROUPS["minicpm3_H40"]
    args = _mla_args(gen, clens, S, H, R, P)
    scale = (64 + 32) ** -0.5
    first = dsk.fused_mla_decode_attention(*args, scale=scale)
    keep = [t.clone() for t in first]
    q = torch.cat([args[0], args[1]], -1)[:, :, None]
    k = torch.cat([args[4], args[5]], -1).float()[:, None]
    v = args[4].float()[:, None]
    mask = torch.arange(S, device="cuda")[None] <= args[6][:, None]
    for _ in range(5):
        Fn.scaled_dot_product_attention(
            q, k.expand(-1, H, -1, -1), v.expand(-1, H, -1, -1),
            attn_mask=mask[:, None, None, :], scale=scale)
        again = dsk.fused_mla_decode_attention(*args, scale=scale)
        torch.cuda.synchronize()
        for a, b, c in zip(first, keep, again):
            assert torch.equal(a, b) and torch.equal(c, b)


@pytest.mark.parametrize("clens", [[0, 4095, 4096, 9000], [100, 5000, 8191,
                                                           12345]],
                         ids=["filling", "wrapped"])
def test_fused_decode_attention_at_gemma2_window(gen, clens):
    """gemma2-9b's local layer: Hq 16, Hkv 8, D 256, a 4096-row window ring
    (lengths past it wrap), soft-cap 50. Queries at 8x, so the scores reach
    the tens and the cap changes them by O(1). The kernel works in fp32 and
    rounds once: its bf16 output lies within half a bf16 step (2^-8
    relative) plus 1e-4 of the plain version on the inputs widened to f32,
    and the uncapped output lies more than 10x that far away."""
    args = list(_attn_args(gen, clens, 4096, 16, 8, 256))
    args[0] = args[0] * 8
    old = [a.clone() for a in args[3:5]]
    kw = dict(logit_softcap=50.0, scale=256 ** -0.5)
    o, kc, vc = dsk.fused_decode_attention(*args, **kw)
    o2, _, _ = dsk.fused_decode_attention(*args, **kw)
    _, kr, vr = fused_decode_attention_ref(*args, **kw)
    wide = [a.float() if a.is_floating_point() else a for a in args]
    r = fused_decode_attention_ref(*wide, **kw)[0]
    r_nocap = fused_decode_attention_ref(*wide, scale=256 ** -0.5)[0]
    torch.cuda.synchronize()
    assert torch.isfinite(o).all()
    assert torch.equal(kc, kr) and torch.equal(vc, vr)
    assert torch.equal(args[3], old[0]) and torch.equal(args[4], old[1])
    allowed = 2.0 ** -8 * r.abs() + 1e-4
    assert bool(((o.float() - r).abs() <= allowed).all()), \
        float((o.float() - r).abs().max())
    assert float((r_nocap - r).abs().max()) > 10 * float(allowed.max())
    assert torch.equal(o, o2), "the kernel must be deterministic"


# ---------------------------------------------------------------------------
# the recurrent and encoder-decoder models: recurrentgemma's local MQA
# (G = 10, not a power of two; Hkv 1, D 256, a 2048-row window ring) and
# whisper's decoder self-attention (Hq = Hkv = 20, D 64, no rope) through
# the GQA decode kernel; the three recurrent mixers (plain PyTorch on every
# device) at full width, card against CPU in f32
# ---------------------------------------------------------------------------

RECURRENT_ENCDEC_ATTN = {
    # name: (cache lengths; S, Hq, Hkv, D): decode at batch 4
    "recurrentgemma_local": ([100, 2047, 2100, 5000], 2048, 10, 1, 256),
    "whisper_decoder": ([0, 63, 128, 255], 256, 20, 20, 64),
}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("case", list(RECURRENT_ENCDEC_ATTN))
def test_fused_decode_attention_at_recurrent_and_encdec_shapes(gen, case,
                                                               dtype):
    """New caches bitwise equal to the plain version's, the input caches
    untouched, out within 2e-2 (f32: 2e-5), deterministic."""
    args = _attn_args(gen, *RECURRENT_ENCDEC_ATTN[case], dtype=dtype)
    old = [a.clone() for a in args[3:5]]
    _nan_fill_allocator()
    before = dsk.fused_decode_attention.launches
    o, kc, vc = dsk.fused_decode_attention(*args)
    o2, _, _ = dsk.fused_decode_attention(*args)
    orf, kr, vr = fused_decode_attention_ref(*args)
    torch.cuda.synchronize()
    assert dsk.fused_decode_attention.launches == before + 2
    tol = TOL if dtype == torch.bfloat16 else TOL_F32
    assert torch.isfinite(o).all()
    assert torch.equal(kc, kr) and torch.equal(vc, vr)
    assert torch.equal(args[3], old[0]) and torch.equal(args[4], old[1])
    torch.testing.assert_close(o.float(), orf.float(), rtol=tol, atol=tol)
    assert torch.equal(o, o2), "the kernel must be deterministic"


def _mixer_case(block):
    """(params, run(params, x, state) -> (out, state), x, x_decode) of one
    recurrent mixer at its published width, f32, on the CPU."""
    from repro_torch.models import recurrent, xlstm
    g = torch.Generator().manual_seed(3)
    kw = dict(generator=g, device="cpu")
    if block == "rglru":
        cfg = get_config("recurrentgemma-2b")
        p = recurrent.init_rglru_block(cfg.d_model, cfg.lru_width,
                                       cfg.conv1d_width, torch.float32, **kw)

        def run(p, x, st):
            decode = st is not None
            out, c, r = recurrent.rglru_block(
                p, x, conv_state=st and st[0], rec_state=st and st[1],
                decode=decode)
            return out, (c, r)
    else:
        cfg = get_config("xlstm-1.3b")
        init = xlstm.init_mlstm_block if block == "mlstm" else \
            xlstm.init_slstm_block
        fn = xlstm.mlstm_block if block == "mlstm" else xlstm.slstm_block
        p = init(cfg.d_model, cfg.num_heads, cfg.proj_factor, torch.float32,
                 **kw)

        def run(p, x, st):
            return fn(p, x, cfg.num_heads, state=st, decode=st is not None)
    x = torch.randn((2, 8, cfg.d_model), generator=g)
    xd = torch.randn((2, 1, cfg.d_model), generator=g)
    return p, run, x, xd


@pytest.mark.parametrize("block", ["rglru", "mlstm", "slstm"])
def test_recurrent_mixers_card_against_cpu(gen, block):
    """An 8-token prefill from no state and one decode step from its state,
    on the card and on the CPU, f32 at full width: outputs and states
    within 1e-4."""
    p, run, x, xd = _mixer_case(block)
    pc = {k: v.cuda() for k, v in p.items()}
    want, st = run(p, x, None)
    got, st_c = run(pc, x.cuda(), None)
    want_d, st2 = run(p, xd, st)
    on_card = [t.cuda() for t in st]
    got_d, st2_c = run(pc, xd.cuda(), type(st)(*on_card)
                       if hasattr(st, "_fields") else tuple(on_card))
    for a, b in zip((got, got_d, *st_c, *st2_c), (want, want_d, *st, *st2)):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# the pre-fused path and the superkernel's dense tail
# ---------------------------------------------------------------------------

def test_legacy_forward_on_the_card(gen):
    """`SlotBufferEngine(fused=False)` on the card: with every expert given
    a slot bitwise the eager unrolled model (per-expert swap-ins on the
    compute stream, `moe_slotbuf`'s plain path); at 2 slots a layer, on
    2-token batches, bitwise the all-resident legacy run under churn."""
    cfg = get_smoke_config("olmoe-1b-7b")
    model = Model(cfg)
    params = model.init(gen, device="cuda")
    rng = np.random.default_rng(2)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 10))).cuda()
    full = SlotBufferEngine(cfg, params, model, n_slots_per_layer=8,
                            fused=False)
    assert torch.equal(full.forward(toks), model.forward(params, toks))
    assert full.swap_count > 0 and full.stats.host_syncs == 2
    small = SlotBufferEngine(cfg, params, model, n_slots_per_layer=2,
                             fused=False)
    for _ in range(4):
        t = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 2))).cuda()
        assert torch.equal(small.forward(t), full.forward(t))
    assert small.stats.demand_misses > full.stats.demand_misses


@pytest.mark.parametrize("arch,layers", [("olmoe-1b-7b", 2),
                                         ("deepseek-v2-lite", 4)])
def test_superkernel_dense_tail_on_the_card(gen, arch, layers):
    """moe_every=2 (a dense tail after the last MoE layer): the superkernel
    step bitwise its oracle, the tail's attention through its decode
    kernel once a step."""
    import dataclasses
    base = reduce_config(get_config(arch), layers=layers, d_model=64,
                         heads=4, kv_heads=4, d_ff=128, vocab=512, experts=8,
                         top_k=2, d_expert=32)
    cfg = dataclasses.replace(base, moe=dataclasses.replace(base.moe,
                                                            moe_every=2))
    model = Model(cfg)
    eng = SlotBufferEngine(cfg, model.init(gen, device="cuda"), model,
                           n_slots_per_layer=4, use_kernel=True,
                           use_superkernel=True, max_seq=64, step_size=1,
                           pregate_margin=0)
    _, tail = eng._sk_segments()
    assert tail == [layers - 1]
    kernel = dsk.fused_mla_decode_attention if cfg.attention == "mla" \
        else dsk.fused_decode_attention
    prompt = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 1))
    lg, st = eng.prefill(prompt)
    lr, sr = eng.reference_prefill(prompt)
    assert torch.equal(lg, lr)
    for _ in range(6):
        tok = lr.argmax(-1)
        n0 = kernel.launches
        lg, st = eng.decode_step(tok, st)
        assert kernel.launches - n0 >= layers   # every layer, tail included
        lp, _ = sk_reference_decode_step(eng, tok, sr, tail_kernel=False)
        lr, sr = sk_reference_decode_step(eng, tok, sr)
        assert torch.equal(lg, lr)
        # the tail's plain path: one bf16 step of the logits, or 2e-2
        assert bool(((lg - lp).abs() <= torch.clamp(
            2.0 ** -7 * lp.abs(), min=2e-2)).all())


def test_attn_decode_kernel_on_a_kv_slice(gen):
    """A rank's GQA decode on a mesh: its two of four query heads read K/V
    head 1 of two (`kv_slice`). With `use_kernel=True` the attention runs
    in `fused_decode_attention` on copies of that head; its output within
    the bf16 tolerance of the plain path's, and the new row in every head
    of the caches, bitwise the plain path's."""
    from repro_torch.models.transformer import attn_decode
    cfg = reduce_config(get_config("yi-9b"), layers=1, d_model=64, heads=4,
                        kv_heads=2, d_ff=128, vocab=512)
    model = Model(cfg)
    p = model.init(gen, device="cuda")["layers"][0]
    p["attn"] = dict(p["attn"], wq=p["attn"]["wq"][:, 2:].contiguous(),
                     wo=p["attn"]["wo"][2:].contiguous())
    spec = model.specs[0]
    B, S = 3, 32
    cache = {n: torch.randn((B, S, 2, cfg.resolved_head_dim), generator=gen,
                            device="cuda").bfloat16() for n in ("k", "v")}
    x = torch.randn((B, 1, cfg.d_model), generator=gen,
                    device="cuda").bfloat16()
    clen = torch.tensor([5, 17, 31], device="cuda")
    n0 = dsk.fused_decode_attention.launches
    got, gc = attn_decode(p, cfg, spec, x, cache, clen, use_kernel=True,
                          kv_slice=slice(1, 2))
    assert dsk.fused_decode_attention.launches == n0 + 1
    want, wc = attn_decode(p, cfg, spec, x, cache, clen, use_kernel=False,
                           kv_slice=slice(1, 2))
    assert all(torch.equal(gc[n], wc[n]) for n in ("k", "v"))
    assert not torch.equal(gc["k"], cache["k"])
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)


# ---------------------------------------------------------------------------
# the engine's measured waits and host spans (runtime.instrument)
# ---------------------------------------------------------------------------

def test_copy_wait_of_a_forced_demand_miss(gen):
    """Eight experts of olmoe's width (12.6 MB each) demanded into an empty
    buffer, then read: the compute stream waits for the whole copy, and
    the wait is the demand's. Eight predicted ones for the next layer
    then add a wait that is not."""
    cfg = reduce_config(get_config("olmoe-1b-7b"), layers=2, d_model=2048,
                        heads=16, kv_heads=16, vocab=512, experts=16,
                        top_k=8, d_expert=1024)
    model = Model(cfg)
    eng = SlotBufferEngine(cfg, model.init(gen, device="cuda"), model,
                           n_slots_per_layer=16, use_superkernel=True,
                           max_seq=32)
    s = eng.stats
    assert eng.ensure_resident(0, range(8)) == 8
    assert s.swap_bytes == s.demand_misses * cfg.expert_bytes() \
        == 8 * cfg.expert_bytes()
    eng._wait_slots(eng.table.layer_slot_map(0), fused=True)
    eng.synchronize()
    assert 0.0 < s.copy_wait_demand_s == s.copy_wait_s <= s.copy_s + 1e-3
    demand = s.copy_wait_demand_s
    assert eng.prefetch_window([(1, range(8))]) == 8
    eng._wait_slots(eng.table.layer_slot_map(1), fused=True)
    eng.synchronize()
    assert s.copy_wait_demand_s == demand < s.copy_wait_s <= s.copy_s + 1e-3
    print(f"copy_s {s.copy_s:.6f} copy_wait_s {s.copy_wait_s:.6f} "
          f"demand {s.copy_wait_demand_s:.6f}")


def _contained(calls, spans, names) -> float:
    """Share of runtime calls whose midpoint lies inside a span named in
    `names` (Chrome-trace microseconds)."""
    iv = sorted((e["ts"], e["ts"] + e["dur"]) for e in spans
                if e["name"] in names)
    merged = []
    for a, b in iv:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    starts = [a for a, _ in merged]
    hit = 0
    for e in calls:
        mid = e["ts"] + e.get("dur", 0) / 2
        i = bisect.bisect_right(starts, mid) - 1
        hit += i >= 0 and merged[i][1] >= mid
    return hit / len(calls)


def test_program_spans_hold_the_copies_and_launches(gen, tmp_path):
    """A short profiled serve with the span log on: mapped onto the
    profiler's clock (`chrome_events(baseTimeNanoseconds)`), 95 % of the
    expert copies' `cudaMemcpyAsync` calls (pinned host to device) lie in
    `residency` spans, 95 % of every host-to-device copy call in some
    span of the program (the engine also copies small pageable tensors
    from inside its dispatches), and 95 % of the kernel launches in
    `decode_step`, `prefill_chunk` or `serve.sample`. The tokens are
    those of the same serve without the log."""
    cfg = reduce_config(get_config("olmoe-1b-7b"), layers=4, d_model=128,
                        heads=4, kv_heads=4, vocab=512, experts=32, top_k=8,
                        d_expert=64)
    model = Model(cfg)
    params = model.init(gen, device="cuda")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n, dtype=np.int32)
               for n in (40, 12, 33, 20)]

    def serve(log, profile=False):
        eng = SlotBufferEngine(cfg, params, model, n_slots_per_layer=8,
                               use_kernel=True, use_superkernel=True,
                               max_seq=96)
        eng.tracer.log = log
        srv = ServingEngine(eng, EngineServingConfig(max_batch=2,
                                                     admission_cap=False))
        reqs = [Request(prompt=p, max_new_tokens=24, request_id=i)
                for i, p in enumerate(prompts)]
        torch.cuda.synchronize()
        prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA])
        if profile:
            prof.start()
        srv.serve(reqs)
        eng.synchronize()
        if profile:
            prof.stop()
        return eng, [r.output for r in reqs], prof

    _, want, _ = serve(None)
    log = SpanLog()
    eng, got, prof = serve(log, profile=True)
    assert got == want
    s = eng.stats
    assert s.replays > 0 and s.swap_experts > 0
    assert s.copy_wait_demand_s <= s.copy_wait_s <= s.copy_s + 1e-3
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    spans = log.chrome_events(trace["baseTimeNanoseconds"])
    evs = [e for e in trace["traceEvents"] if e.get("ph") == "X"]

    def corr(e):
        return e.get("args", {}).get("correlation")

    h2d = {corr(e): "Pinned" in e["name"] for e in evs
           if e.get("cat") == "gpu_memcpy" and "HtoD" in e["name"]}
    kern = {corr(e) for e in evs if e.get("cat") == "kernel"}
    rt = [e for e in evs if e.get("cat") in ("cuda_runtime", "cuda_driver")]
    copies = [e for e in rt if corr(e) in h2d]
    experts = [e for e in copies if h2d[corr(e)]]
    launches = [e for e in rt if corr(e) in kern]
    assert len(experts) > 100 and len(launches) > 100
    in_res = _contained(experts, spans, {"residency"})
    any_in_res = _contained(copies, spans, {"residency"})
    in_any = _contained(copies, spans, {e["name"] for e in spans})
    in_step = _contained(launches, spans,
                         {"decode_step", "prefill_chunk", "serve.sample"})
    print(f"{len(experts)} expert copy calls, {in_res:.4f} in residency; "
          f"{len(copies)} HtoD copy calls, {any_in_res:.4f} in residency, "
          f"{in_any:.4f} in any span; {len(launches)} launches, "
          f"{in_step:.4f} in steps and sampling")
    assert in_res >= 0.95 and in_any >= 0.95 and in_step >= 0.95


# ---------------------------------------------------------------------------
# host arrays onto the device with no host wait (`SlotBufferEngine._upload`)
# ---------------------------------------------------------------------------

def test_upload_keeps_each_map_while_its_copy_waits(gen):
    """The compute stream held by a sleep: map A uploaded, the host array
    overwritten with B and uploaded again while both copies still wait.
    The device tensors read A and B: each upload stages through its own
    page-locked block, never one buffer rewritten in place."""
    cfg = get_smoke_config("olmoe-1b-7b")
    model = Model(cfg)
    eng = SlotBufferEngine(cfg, model.init(gen, device="cuda"), model,
                           n_slots_per_layer=4)
    E = cfg.moe.num_experts
    host = np.arange(E, dtype=np.int32)
    want_a, want_b = host.copy(), host[::-1].copy()
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)
    dev_a = eng._upload(host)
    host[:] = want_b
    dev_b = eng._upload(host)
    assert not torch.cuda.current_stream().query(), \
        "the copies ran before the map was overwritten: the test saw nothing"
    torch.cuda.synchronize()
    np.testing.assert_array_equal(dev_a.cpu().numpy(), want_a)
    np.testing.assert_array_equal(dev_b.cpu().numpy(), want_b)


def _innermost(spans, t):
    """Names of the program spans holding instant t, outermost first."""
    return [e["name"] for e in sorted(
        (e for e in spans if e["ts"] <= t <= e["ts"] + e["dur"]),
        key=lambda e: -e["dur"])]


def test_no_host_sync_between_a_segments_residency_and_its_dispatch(gen,
                                                                    tmp_path):
    """A profiled serve (one row at a time, 16-token chunks, 8 of 32
    experts a layer on the card) with the span log on: every
    `cudaStreamSynchronize` inside a `segment` or `prefill_chunk` span is
    its pull's; the slot maps, the routing masks and the chunk tokens go
    up with no host wait. The served tokens are those of the fully-resident
    oracle."""
    cfg = reduce_config(get_config("olmoe-1b-7b"), layers=4, d_model=128,
                        heads=4, kv_heads=4, vocab=512, experts=32, top_k=8,
                        d_expert=64)
    model = Model(cfg)
    eng = SlotBufferEngine(cfg, model.init(gen, device="cuda"), model,
                           n_slots_per_layer=8, use_kernel=True,
                           use_superkernel=True, max_seq=96)
    log = SpanLog()
    eng.tracer.log = log
    chunk = 16
    rng = np.random.default_rng(0)
    reqs = [Request(prompt=rng.integers(0, cfg.vocab_size, n,
                                        dtype=np.int32),
                    max_new_tokens=20, request_id=i)
            for i, n in enumerate((40, 12, 33))]
    srv = ServingEngine(eng, EngineServingConfig(
        max_batch=1, admission_cap=False, prefill_chunk=chunk))
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        srv.serve(reqs)
        eng.synchronize()
    s = eng.stats
    assert s.replays > 0 and s.swap_experts > 0
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    spans = log.chrome_events(trace["baseTimeNanoseconds"])
    pulls = sorted((e["ts"], e["ts"] + e["dur"]) for e in spans
                   if e["name"] == "pull")
    syncs = [e for e in trace["traceEvents"] if e.get("ph") == "X"
             and e.get("cat") == "cuda_runtime"
             and e["name"] == "cudaStreamSynchronize"]
    in_pull, stray = 0, []
    for e in syncs:
        a, b = e["ts"], e["ts"] + e.get("dur", 0)
        i = bisect.bisect_right(pulls, (b, b)) - 1
        if i >= 0 and pulls[i][1] >= a:
            in_pull += 1
            continue
        names = _innermost(spans, (a + b) / 2)
        if {"segment", "prefill_chunk"} & set(names):
            stray.append("/".join(names))
    print(f"{len(syncs)} cudaStreamSynchronize: {in_pull} in pulls, "
          f"{len(stray)} elsewhere in segments and chunks")
    assert in_pull > 0 and not stray, stray[:5]

    for req in reqs:
        lg, st = eng.reference_prefill_chunked(req.prompt[None, :], chunk)
        want = [int(lg.argmax(-1)[0])]
        while len(want) < req.max_new_tokens:
            lg, st = sk_reference_decode_step(eng, lg.argmax(-1), st)
            want.append(int(lg.argmax(-1)[0]))
        assert list(req.output) == want, req.request_id
