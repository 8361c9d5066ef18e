"""Card-only tests of the port: each CUDA kernel against its plain version
(and against itself, for determinism), the wrappers' checks, and the slot
paths (unfused and superkernel) against their fully-resident oracles with
asynchronous swap-ins. They skip without a CUDA device; on a machine
with one (and the CUDA toolkit), run them with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

This file imports no JAX: the card's machine need not have it.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, get_smoke_config, reduce_config
from repro_torch.kernels import decode_superkernel as dsk
from repro_torch.kernels import slot_gather
from repro_torch.kernels.ref import (fused_decode_attention_ref,
                                     fused_mla_decode_attention_ref,
                                     fused_moe_entry_ref, slot_ffn_ref)
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
        slot_gather.slot_ffn(x.float(), slot, wg, wu, wd)
    with pytest.raises(TypeError):
        slot_gather.slot_ffn(x, slot.long(), wg, wu, wd)
    with pytest.raises(ValueError):
        slot_gather.slot_ffn(x, slot, wg.transpose(1, 2), wu, wd)
    x2, slot2, wg2, wu2, wd2 = _inputs(gen, 2, 4, 60, 32, 3)
    with pytest.raises(ValueError):
        slot_gather.slot_ffn(x2, slot2, wg2, wu2, wd2)


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
