"""The port's SlotBufferEngine against the reference engine, and against its
own fully-resident oracle, on the olmoe smoke config (CPU).

Across frameworks: prefill logits, then 8 decode steps teacher-forced on
the reference's greedy tokens, within atol = rtol = 5e-2 (bf16 logits), and
identical greedy tokens — where they differ, the reference's top two logits
must lie within 5e-2 of each other (a near-tie), else it is a fault.

Inside the port: under eviction churn with speculative replays, decode
logits are bitwise equal to `reference_decode_step`.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_smoke_config as jax_smoke
from repro.models.transformer import Model as JaxModel
from repro.runtime.engine import SlotBufferEngine as JaxEngine
from repro_torch.bridge import params_from_reference
from repro_torch.configs import get_smoke_config
from repro_torch.models.transformer import Model
from repro_torch.runtime.engine import SlotBufferEngine
from repro_torch.runtime.request import Request
from repro_torch.runtime.serving import EngineServingConfig, ServingEngine

CFG = get_smoke_config("olmoe-1b-7b")
TOL = 5e-2


@pytest.fixture(scope="module")
def ref():
    """(JAX model, JAX params, port params)."""
    cfg = jax_smoke("olmoe-1b-7b")
    model = JaxModel(cfg)
    params = jax.jit(model.init)(jax.random.PRNGKey(0))
    return model, params, params_from_reference(
        jax.tree.map(np.asarray, params))


def assert_same_greedy(tok, ref_logits, where):
    """Greedy tokens agree, or the reference's top two logits are a near
    tie (within 5e-2) at the step where they first differ."""
    want = int(np.argmax(ref_logits))
    if int(tok) != want:
        top2 = np.sort(ref_logits)[-2:]
        assert top2[1] - top2[0] <= TOL, (
            f"{where}: token {int(tok)} != reference {want} and the "
            f"reference's top two logits differ by {top2[1] - top2[0]:.4f}")
        return False
    return True


def test_engine_matches_reference_engine_teacher_forced(ref):
    jmodel, jparams, tparams = ref
    je = JaxEngine(jmodel.cfg, jparams, jmodel, n_slots_per_layer=4,
                   use_kernel=True)
    te = SlotBufferEngine(CFG, tparams, Model(CFG), n_slots_per_layer=4,
                          use_kernel=True, device="cpu")
    prompt = np.random.default_rng(11).integers(0, CFG.vocab_size, (1, 12))
    jl, js = je.prefill(jnp.asarray(prompt, jnp.int32))
    tl, ts = te.prefill(prompt)
    for step in range(9):
        jl_h = np.asarray(jl)
        np.testing.assert_allclose(tl.numpy(), jl_h, rtol=TOL, atol=TOL,
                                   err_msg=f"step {step}")
        assert_same_greedy(tl.argmax(-1)[0], jl_h[0], f"step {step}")
        if step == 8:
            break
        tok = jl_h.argmax(-1).astype(np.int32)      # reference's greedy token
        jl, js = je.decode_step(jnp.asarray(tok), js)
        tl, ts = te.decode_step(tok, ts)
    assert te.stats.swap_experts > 0 and te.stats.evictions > 0
    # same routing -> the same host-side residency decisions, step for step
    js_, ts_ = je.stats.snapshot(), te.stats.snapshot()
    for key in ("swap_calls", "swap_experts", "prefetched", "prefetch_hits",
                "late_hits", "demand_misses", "host_syncs", "steps",
                "spec_layers", "replays"):
        assert ts_[key] == js_[key], (key, ts_[key], js_[key])
    assert te.controller.s_history == je.controller.s_history


@pytest.mark.parametrize("use_kernel", [True, False])
def test_decode_bitwise_vs_own_oracle_under_churn_with_replays(ref,
                                                               use_kernel):
    _, _, tparams = ref
    # 8 slots for 16 experts: each layer fits, the two layers churn; with
    # S = 1 and no pre-gate margin, mispredictions force replays
    te = SlotBufferEngine(CFG, tparams, Model(CFG), n_slots_per_layer=4,
                          use_kernel=use_kernel, step_size=1,
                          pregate_margin=0, device="cpu")
    rng = np.random.default_rng(5)
    replays = 0
    for trial in range(3):
        prompt = rng.integers(0, CFG.vocab_size, (2, 6))
        lg, st = te.prefill(prompt)
        lr, sr = te.reference_prefill(prompt)
        assert torch.equal(lg, lr)
        tok = lr.argmax(-1)
        for step in range(8):
            lg, st = te.decode_step(tok, st)
            lr, sr = te.reference_decode_step(tok, sr)
            assert torch.equal(lg, lr), f"trial {trial} step {step}"
            tok = lr.argmax(-1)
        replays = te.stats.replays
    assert replays > 0, "no speculative window was replayed"
    assert te.stats.evictions > 0


def test_decode_state_stays_valid_after_a_step(ref):
    """Caches are never written in place: stepping twice from one saved
    state gives the same logits."""
    _, _, tparams = ref
    te = SlotBufferEngine(CFG, tparams, Model(CFG), n_slots_per_layer=4,
                          use_kernel=True, step_size=1, device="cpu")
    prompt = np.random.default_rng(6).integers(0, CFG.vocab_size, (1, 5))
    lg, st = te.prefill(prompt)
    tok = lg.argmax(-1)
    a, st_a = te.decode_step(tok, st)
    te.decode_step(a.argmax(-1), st_a)
    b, _ = te.decode_step(tok, st)
    assert torch.equal(a, b)


def test_forward_bitwise_vs_reference_forward(ref):
    """The cache-free forward through the slot buffer (demand swaps under
    churn between the two layers) equals its fully-resident oracle."""
    _, _, tparams = ref
    te = SlotBufferEngine(CFG, tparams, Model(CFG), n_slots_per_layer=4,
                          use_kernel=True, device="cpu")
    rng = np.random.default_rng(7)
    for _ in range(3):
        toks = rng.integers(0, CFG.vocab_size, (2, 7))
        assert torch.equal(te.forward(toks), te.reference_forward(toks))
    assert te.stats.evictions > 0


@pytest.mark.parametrize("superkernel", [True, False],
                         ids=["superkernel", "unfused"])
@pytest.mark.parametrize("chunk", [4, 0], ids=["chunked", "monolithic"])
def test_dispatched_slot_map_is_the_table_at_dispatch(superkernel, chunk):
    """Every slot map that reaches a MoE dispatch (`_sk_seg`, `_ffn`) is
    its layer's `SlotTable.layer_slot_map` when the dispatch is issued,
    and stays so while later swaps assign and release that layer's
    slots: the engine hands the kernels a copy, never the table."""
    model = Model(CFG)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    eng = SlotBufferEngine(CFG, params, model, n_slots_per_layer=4,
                           use_kernel=True, use_superkernel=superkernel,
                           step_size=1, pregate_margin=0, max_seq=64,
                           device="cpu")
    segs, _ = eng._sk_segments()
    seen = []
    dispatch = eng._dispatch

    def recording(fn, *args, **kw):
        if fn.__name__ == "_sk_seg":
            li, sm = segs.index(args[0]), args[6]
        elif fn.__name__ == "_ffn" and args[1] is eng.buffer:
            li = next(j for j, i in enumerate(eng.moe_layer_ids)
                      if eng._p[i] is args[0])
            sm = args[2]
        else:
            return dispatch(fn, *args, **kw)
        seen.append((li, sm, eng.table.layer_slot_map(li)))
        return dispatch(fn, *args, **kw)

    eng._dispatch = recording
    rng = np.random.default_rng(9)
    reqs = [Request(rng.integers(0, CFG.vocab_size, n), max_new_tokens=6,
                    request_id=i) for i, n in enumerate((9, 5, 7))]
    ServingEngine(eng, EngineServingConfig(
        max_batch=2, admission_cap=False, prefill_chunk=chunk)).serve(reqs)
    assert all(r.done for r in reqs)
    assert len(seen) > 20 and eng.stats.evictions > 0
    for li, sm, at_dispatch in seen:
        assert sm.dtype == torch.int32
        np.testing.assert_array_equal(sm.numpy(), at_dispatch)
    # the table moved on after some of them: a shared buffer would show it
    assert any(not np.array_equal(at_dispatch, eng.table.layer_slot_map(li))
               for li, _, at_dispatch in seen)
