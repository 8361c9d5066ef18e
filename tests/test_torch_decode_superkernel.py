"""The port's decode superkernel path against the reference (CPU).

Kernels: on the CPU the port's wrappers run their plain versions, held here
against the reference's Pallas kernels in interpret mode on the same
inputs (made with numpy from a seed).
- `fused_moe_entry`: ids equal, gates within 1e-6 (fp32 softmax summed in
  another order), y within 2e-2. The rounding points are the same (g, u,
  h and the down-projection each rounded to bf16), but a different fp32
  summation order can flip one bf16 rounding, and the reference rounds
  silu(g) twice (sigmoid, then the product) where the port rounds it once.
- `fused_decode_attention`: new caches bitwise equal, out within 2e-2 (one
  bf16 rounding of an fp32 result that differs in its last bits).

Engine: on a reduced olmoe config (4 layers) with 3 slots per layer,
teacher-forced on the reference's greedy tokens, the port's superkernel
engine makes the same host decisions as the reference's, counter for
counter, and its greedy tokens agree (a near-tie, top two logits within
5e-2, is the only excuse). Routing of the two frameworks can part at a
near-tie of router probabilities (their bf16 activations differ in the last
bit); the prompt is one whose routing has none. Inside the port: the
superkernel slot path is bitwise equal to the same segment functions run
over the fully-resident experts, a batched ragged step stays within 5e-2
of the unfused path with the same argmax, and the superkernel issues at
most half the unfused path's dispatches per step.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import reduce_config as jax_reduce_config
from repro.configs.registry import get_config as jax_get_config
from repro.kernels import ops as jax_ops
from repro.runtime.engine import Engine as JaxEngine
from repro.runtime.engine import SlotBufferEngine as JaxSlotBufferEngine
from repro_torch.bridge import params_from_reference, to_tensor
from repro_torch.configs import get_config, reduce_config
from repro_torch.kernels import decode_superkernel as dsk
from repro_torch.kernels.ref import (fused_decode_attention_ref,
                                     fused_moe_entry_ref)
from repro_torch.models import moe as moe_mod
from repro_torch.models.transformer import Model
from repro_torch.runtime.engine import SlotBufferEngine
from test_torch_cuda import sk_reference_decode_step

TOL_Y = 2e-2
TOL_GATES = 1e-6
TOL_LOGITS = 5e-2
SMALL = dict(layers=4, d_model=64, heads=4, kv_heads=4, d_ff=128, vocab=512,
             experts=8, top_k=2, d_expert=32)
CFG = reduce_config(get_config("olmoe-1b-7b"), **SMALL)


def _bf16(a):
    return np.asarray(jnp.asarray(a, jnp.bfloat16))


# ---------------------------------------------------------------------------
# fused_moe_entry
# ---------------------------------------------------------------------------

def _moe_inputs(seed, T, E, n_slots, d, f):
    """Tokens, router, bias and a slot table where only `n_slots` of the E
    experts are resident (the rest -1)."""
    rng = np.random.default_rng(seed)
    x = _bf16(rng.standard_normal((T, d)) * 0.5)
    rw = (rng.standard_normal((d, E)) * 0.3).astype(np.float32)
    bias = (rng.standard_normal(E) * 0.5).astype(np.float32)
    sg = _bf16(rng.standard_normal((n_slots, d, f)) * 0.1)
    su = _bf16(rng.standard_normal((n_slots, d, f)) * 0.1)
    sd = _bf16(rng.standard_normal((n_slots, f, d)) * 0.1)
    soe = np.full(E, -1, np.int32)
    soe[rng.permutation(E)[:n_slots]] = rng.permutation(n_slots)
    return x, rw, bias, soe, sg, su, sd


MOE_CASES = {
    "T8_E8_S8_k2": (8, 8, 8, 2, 64, 128),
    "T16_E8_S6_k2": (16, 8, 6, 2, 64, 128),
    "T4_E16_S5_k4": (4, 16, 5, 4, 64, 128),
    "T1_E8_S3_k8": (1, 8, 3, 8, 64, 128),
    "off_tile_d48_f72": (5, 4, 3, 2, 48, 72),
    # f32 tokens and slot buffers, as the reference's own f32 test
    "f32_off_tile_d48_f72": (5, 4, 3, 2, 48, 72),
    "f32_T4_E16_S5_k4": (4, 16, 5, 4, 64, 128),
}
TOL_F32 = 2e-5      # the reference's f32 tolerance: no bf16 rounding


def _f32(args):
    """The same inputs with the bf16 arrays widened to f32."""
    return tuple(a.astype(np.float32) if a.dtype == _bf16(0).dtype else a
                 for a in args)


@pytest.mark.parametrize("norm", [True, False])
@pytest.mark.parametrize("case", list(MOE_CASES))
def test_fused_moe_entry_plain_matches_reference_kernel(case, norm):
    T, E, S, k, d, f = MOE_CASES[case]
    args = _moe_inputs(T * E + k, T, E, S, d, f)
    tol = TOL_Y
    if case.startswith("f32"):
        args, tol = _f32(args), TOL_F32
    x, rw, bias, soe, sg, su, sd = args
    yj, gj, ij = jax_ops.fused_moe_entry(
        *(jnp.asarray(a) for a in (x, rw, bias, soe, sg, su, sd)),
        top_k=k, norm_topk=norm, interpret=True)
    y, g, i = dsk.fused_moe_entry(*(to_tensor(a) for a in args), top_k=k,
                                  norm_topk=norm)
    assert y.dtype == torch.float32 and i.dtype == torch.int32
    np.testing.assert_array_equal(i.numpy(), np.asarray(ij))
    np.testing.assert_allclose(g.numpy(), np.asarray(gj), rtol=TOL_GATES,
                               atol=TOL_GATES)
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), rtol=tol,
                               atol=tol)
    # absent experts: gate exactly 0
    assert (g.numpy()[soe[i.numpy()] < 0] == 0).all()


def test_fused_moe_entry_ignores_where_the_experts_sit():
    """The same resident experts in other slots of a larger buffer give the
    same bits: the result depends on the slot table only through which
    experts are resident."""
    x, rw, bias, soe, sg, su, sd = (to_tensor(a) for a in
                                    _moe_inputs(3, 6, 8, 5, 64, 128))
    perm = torch.tensor([6, 2, 0, 4, 1])                 # slot s -> s'
    big = [torch.zeros((7,) + w.shape[1:], dtype=w.dtype)
           for w in (sg, su, sd)]
    for b, w in zip(big, (sg, su, sd)):
        b[perm] = w
    soe2 = torch.where(soe >= 0, perm[soe.clamp(min=0).long()].int(), soe)
    a = dsk.fused_moe_entry(x, rw, bias, soe, sg, su, sd, top_k=2)
    b = dsk.fused_moe_entry(x, rw, bias, soe2, *big, top_k=2)
    for u, v in zip(a, b):
        assert torch.equal(u, v)


def test_fused_moe_entry_cpu_path_is_plain_and_not_counted():
    args = [to_tensor(a) for a in _moe_inputs(1, 4, 8, 4, 64, 128)]
    before = dsk.fused_moe_entry.launches
    got = dsk.fused_moe_entry(*args, top_k=2)
    want = fused_moe_entry_ref(*args, top_k=2)
    assert all(torch.equal(u, v) for u, v in zip(got, want))
    assert dsk.fused_moe_entry.launches == before
    with pytest.raises(ValueError):
        dsk.fused_moe_entry(*(a.to("meta") for a in args), top_k=2)


def test_moe_slotbuf_fused_rounds_to_the_input_dtype_and_rejects_shared():
    x, rw, bias, soe, sg, su, sd = (to_tensor(a) for a in
                                    _moe_inputs(2, 4, 8, 8, 64, 128))
    moe = CFG.moe
    slots = {"w_gate": sg, "w_up": su, "w_down": sd}
    out, gates, ids = moe_mod.moe_slotbuf_fused({"router": rw}, slots, soe,
                                                x, moe)
    y, g, i = fused_moe_entry_ref(x, rw, torch.zeros(8), soe, sg, su, sd,
                                  top_k=moe.top_k,
                                  norm_topk=moe.router_norm_topk)
    assert out.dtype == x.dtype and torch.equal(out, y.to(x.dtype))
    assert torch.equal(gates, g) and torch.equal(ids, i)
    # shared experts are no longer rejected: their SwiGLU is added outside
    # the kernel, after the routed experts
    rng = np.random.default_rng(3)
    shared = {k: to_tensor(_bf16(rng.standard_normal(s) * 0.1))
              for k, s in (("w_gate", (64, 48)), ("w_up", (64, 48)),
                           ("w_down", (48, 64)))}
    out_s, gates_s, _ = moe_mod.moe_slotbuf_fused(
        {"router": rw, "shared": shared}, slots, soe, x, moe)
    assert torch.equal(gates_s, g)
    assert torch.equal(out_s, y.to(x.dtype) + moe_mod.swiglu(
        x, shared["w_gate"], shared["w_up"], shared["w_down"]))


# ---------------------------------------------------------------------------
# fused_decode_attention
# ---------------------------------------------------------------------------

ATTN_CASES = {
    # name: (clens, S, Hq, Hkv, D)
    "ragged": ([0, 3, 7, 15], 16, 4, 4, 32),
    "wrapped": ([16, 25], 16, 4, 4, 32),
    "gqa_G2": ([5, 0, 12], 16, 4, 2, 32),
    "gqa_G4_two_chunks": ([200, 130], 256, 8, 2, 16),
    # f32 q, k, v and caches, as the reference's own f32 tests
    "f32_gqa_G2": ([0, 3, 7, 16], 16, 4, 2, 32),
    "f32_gqa_G4_two_chunks": ([200, 130], 256, 8, 2, 16),
}


def _attn_inputs(seed, clens, S, Hq, Hkv, D):
    rng = np.random.default_rng(seed)
    B = len(clens)
    return (_bf16(rng.standard_normal((B, 1, Hq, D))),
            _bf16(rng.standard_normal((B, 1, Hkv, D))),
            _bf16(rng.standard_normal((B, 1, Hkv, D))),
            _bf16(rng.standard_normal((B, S, Hkv, D))),
            _bf16(rng.standard_normal((B, S, Hkv, D))),
            np.asarray(clens, np.int64))


@pytest.mark.parametrize("softcap", [0.0, 30.0])
@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_fused_decode_attention_plain_matches_reference_kernel(case,
                                                               softcap):
    args = _attn_inputs(len(case), *ATTN_CASES[case])
    f32 = case.startswith("f32")
    if f32:
        args = _f32(args)
    q, kn, vn, kc, vc, clen = args
    oj, kj, vj = jax_ops.fused_decode_attention(
        *(jnp.asarray(a) for a in (q, kn, vn, kc, vc)),
        jnp.asarray(clen, jnp.int32), logit_softcap=softcap, interpret=True)
    kc_t, vc_t = to_tensor(kc), to_tensor(vc)
    o, k2, v2 = dsk.fused_decode_attention(
        to_tensor(q), to_tensor(kn), to_tensor(vn), kc_t, vc_t,
        to_tensor(clen), logit_softcap=softcap)
    assert o.dtype == (torch.float32 if f32 else torch.bfloat16)
    bits = np.uint32 if f32 else np.uint16
    np.testing.assert_array_equal(k2.numpy().view(bits) if f32 else
                                  k2.view(torch.uint16).numpy(),
                                  np.asarray(kj).view(bits))
    np.testing.assert_array_equal(v2.numpy().view(bits) if f32 else
                                  v2.view(torch.uint16).numpy(),
                                  np.asarray(vj).view(bits))
    tol = TOL_F32 if f32 else TOL_Y
    np.testing.assert_allclose(o.float().numpy(),
                               np.asarray(oj).astype(np.float32),
                               rtol=tol, atol=tol)
    # the input caches are left as they were
    assert torch.equal(kc_t, to_tensor(kc))
    assert torch.equal(vc_t, to_tensor(vc))


def test_fused_decode_attention_takes_one_length_for_every_row():
    q, kn, vn, kc, vc, _ = (to_tensor(a) for a in
                            _attn_inputs(0, [9, 9, 9], 16, 4, 2, 32))
    one = dsk.fused_decode_attention(q, kn, vn, kc, vc, torch.tensor(9))
    per_row = fused_decode_attention_ref(q, kn, vn, kc, vc,
                                         torch.tensor([9, 9, 9]))
    assert all(torch.equal(a, b) for a, b in zip(one, per_row))
    with pytest.raises(ValueError):
        dsk.fused_decode_attention(q.to("meta"), kn, vn, kc, vc,
                                   torch.tensor(9))


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref():
    """(reduced reference config, JAX engine for its params, port params)."""
    jcfg = jax_reduce_config(jax_get_config("olmoe-1b-7b"), **SMALL)
    eng = JaxEngine(jcfg, max_seq=64)
    return jcfg, eng, params_from_reference(
        jax.tree.map(np.asarray, eng.params))


def _near_tie_ok(tok, ref_row, where):
    want = int(np.argmax(ref_row))
    if int(tok) != want:
        top2 = np.sort(ref_row)[-2:]
        assert top2[1] - top2[0] <= TOL_LOGITS, (
            f"{where}: token {int(tok)} != reference {want}, top-2 gap "
            f"{top2[1] - top2[0]:.4f}")


def test_superkernel_engine_matches_reference_engine_counter_for_counter(ref):
    jcfg, jeng, tparams = ref
    je = JaxSlotBufferEngine(jcfg, jeng.params, jeng.model, max_seq=64,
                             n_slots_per_layer=3, use_superkernel=True)
    te = SlotBufferEngine(CFG, tparams, Model(CFG), max_seq=64,
                          n_slots_per_layer=3, use_superkernel=True,
                          device="cpu")
    prompt = np.random.default_rng(2).integers(0, CFG.vocab_size, (2, 10))
    jl, js = je.prefill(jnp.asarray(prompt, jnp.int32))
    tl, ts = te.prefill(prompt)
    keys = ("swap_calls", "swap_experts", "prefetched", "prefetch_hits",
            "late_hits", "demand_misses", "host_syncs", "steps",
            "spec_layers", "replays")
    for step in range(9):
        jl_h = np.asarray(jl)
        np.testing.assert_allclose(tl.numpy(), jl_h, rtol=TOL_LOGITS,
                                   atol=TOL_LOGITS, err_msg=f"step {step}")
        for b in range(2):
            _near_tie_ok(tl.argmax(-1)[b], jl_h[b], f"step {step} row {b}")
        a, w = te.stats.snapshot(), je.stats.snapshot()
        assert [a[k] for k in keys] == [w[k] for k in keys], (step, a, w)
        assert te.controller.s_history == je.controller.s_history
        if step == 8:
            break
        tok = jl_h.argmax(-1).astype(np.int32)      # the reference's tokens
        jl, js = je.decode_step(jnp.asarray(tok), js)
        tl, ts = te.decode_step(tok, ts)
    assert te.stats.replays > 0 and te.stats.spec_layers > 0
    assert te.stats.evictions > 0


def test_superkernel_slot_path_bitwise_vs_resident_oracle(ref):
    _, _, tparams = ref
    te = SlotBufferEngine(CFG, tparams, Model(CFG), max_seq=64,
                          n_slots_per_layer=3, use_superkernel=True,
                          step_size=1, pregate_margin=0, device="cpu")
    rng = np.random.default_rng(5)
    for trial in range(2):
        prompt = rng.integers(0, CFG.vocab_size, (2, 8))
        lg, st = te.prefill(prompt)
        lr, sr = te.reference_prefill(prompt)
        assert torch.equal(lg, lr)
        tok = lr.argmax(-1)
        for step in range(8):
            lg, st = te.decode_step(tok, st)
            lr, sr = sk_reference_decode_step(te, tok, sr)
            assert torch.equal(lg, lr), f"trial {trial} step {step}"
            for a, b in zip(st.caches, sr.caches):
                assert torch.equal(a["k"], b["k"]) and torch.equal(a["v"],
                                                                   b["v"])
            tok = lr.argmax(-1)
    assert te.stats.replays > 0 and te.stats.evictions > 0


def test_superkernel_batched_ragged_step_matches_unfused_path(ref):
    _, _, tparams = ref
    model = Model(CFG)
    kw = dict(max_seq=64, n_slots_per_layer=6, step_size=2, device="cpu")
    base = SlotBufferEngine(CFG, tparams, model, **kw)
    rng = np.random.default_rng(7)
    state = base.alloc_decode_state(3)
    toks = np.zeros(3, np.int64)
    for slot, n in enumerate((8, 12, 10)):
        lo = base.prefill_into(state, slot,
                               rng.integers(0, CFG.vocab_size, (1, n)))
        toks[slot] = int(lo.argmax(-1)[0])
    for _ in range(3):                               # ragged histories
        lo, state = base.decode_step(toks, state)
        toks = lo.argmax(-1).numpy()
    lo_b, st_b = base.decode_step(toks, copy.deepcopy(state))
    sk = SlotBufferEngine(CFG, tparams, model, use_superkernel=True, **kw)
    lo_s, st_s = sk.decode_step(toks, copy.deepcopy(state))
    assert torch.equal(st_s.cache_len, st_b.cache_len)
    np.testing.assert_allclose(lo_s.numpy(), lo_b.numpy(), rtol=TOL_LOGITS,
                               atol=TOL_LOGITS)
    assert torch.equal(lo_s.argmax(-1), lo_b.argmax(-1))


def test_superkernel_halves_dispatches_per_step(ref):
    _, _, tparams = ref
    model = Model(CFG)
    prompt = np.random.default_rng(7).integers(0, CFG.vocab_size, (2, 10))
    kw = dict(max_seq=64, n_slots_per_layer=6, step_size=3, device="cpu")
    base = SlotBufferEngine(CFG, tparams, model, **kw)
    toks_b = base.generate(prompt, 16)
    sk = SlotBufferEngine(CFG, tparams, model, use_superkernel=True, **kw)
    toks_s = sk.generate(prompt, 16)
    np.testing.assert_array_equal(toks_s, toks_b)
    per_base = base.stats.dispatches / base.stats.steps
    per_sk = sk.stats.dispatches / sk.stats.steps
    assert per_base / per_sk >= 2.0, (per_base, per_sk)
