"""Card-only tests of the port: each CUDA kernel against its plain version
(and against itself, for determinism), the wrappers' checks, and the slot
paths (unfused and superkernel, whole-prompt and chunked prefill) against
their fully-resident oracles with asynchronous swap-ins. They skip without a CUDA device; on a machine
with one (and the CUDA toolkit), run them with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

This file imports no JAX: the card's machine need not have it.
"""
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
from repro_torch.models.transformer import Model
from repro_torch.runtime.engine import DecodeState, SlotBufferEngine

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


def sk_reference_decode_step(eng, tok, state):
    """The fully-resident oracle of the superkernel path: the engine's own
    segment functions over every expert of each layer with the identity
    slot table."""
    segs, _ = eng._sk_segments()
    caches, clen = list(state.caches), state.cache_len
    x = torch.as_tensor(tok, device=eng.device)
    logits = None
    for li, seg in enumerate(segs):
        x, _, new_cs, logits = eng._sk_seg(
            seg, [eng._p[j] for j in seg], [caches[j] for j in seg], x, clen,
            eng._full_experts(li), eng._ident_map, eng._router_stack[:0],
            eng._zero_bias, first=li == 0, with_logits=li == len(segs) - 1)
        for jj, aj in enumerate(seg):
            caches[aj] = new_cs[jj]
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
