"""Trailing dense layers on the decode superkernel path (CPU).

No published config has dense layers after its last MoE layer, so the
tail is held on smoke configs with `moe_every=2`: olmoe's smoke config
(layer 0 MoE, layer 1 a dense GQA tail) and DeepSeek-V2-Lite's smoke widths
at 4 layers (layers 0-1 dense, 2 MoE, 3 a dense MLA tail; the smoke
config's 3 layers would end in the MoE layer). The tail runs after the
last segment, each attention through its decode kernel (on the CPU the
wrappers' plain versions), then the logits, in one call.

- Inside the port: with 4 slots a layer (one MoE layer: the slot pool
  holds two rows' demand, so evictions churn it) on 1-token prompts, the
  superkernel step is bitwise its fully-resident oracle
  (`sk_reference_decode_step`: the engine's own segment functions over
  every expert, then the tail layer by layer through `layer_decode` and
  the model's logits, not through the engine's tail function), logits and
  caches; the oracle with the tail's plain path (`use_kernel=False`)
  within one bf16 step of the logits or 2e-2. The port's own bf16
  weights (`Model.init` from a seeded generator).
- Against the reference: the JAX superkernel engine (Pallas kernels in
  interpret mode) on the same weights bridged from it, in float32, 8
  slots a layer (a 10-token prompt's demand fits the one MoE layer),
  teacher-forced on its greedy tokens: logits within 1e-2, the port's
  greedy token the reference's unless the reference's top two are within
  1e-2 (the near-tie rule of `tests/test_torch_decode_superkernel.py`),
  and the host counters equal. In bfloat16 DeepSeek's prefill logits
  already part from the reference's by 0.07 at one of 1024 (bf16 rounding
  through four layers in another order), so the twins run in float32, as
  `tests/test_torch_horizon.py` runs its counter twins. They still part
  by more than float32 rounding, because the reference's slot buffer
  holds the experts in bfloat16 whatever the model's dtype (the port's in
  the model's): by at most 3.2e-3 over the four steps of either arch, so
  the tolerance is about three times that.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import reduce_config as jax_reduce_config
from repro.configs.registry import get_config as jax_get_config
from repro.runtime.engine import Engine as JaxEngine
from repro.runtime.engine import SlotBufferEngine as JaxSlotBufferEngine
from repro_torch.bridge import params_from_reference
from repro_torch.configs import get_config, reduce_config
from repro_torch.models.transformer import Model
from repro_torch.runtime.engine import SlotBufferEngine
from test_torch_cuda import sk_reference_decode_step

TOL_LOGITS = 1e-2
SMOKE = dict(d_model=64, heads=4, kv_heads=4, d_ff=128, vocab=512, experts=8,
             top_k=2, d_expert=32)
# arch -> (layers, the specs' kinds of FFN, the tail's layer ids)
ARCHS = {"olmoe-1b-7b": (2, [True, False], [1]),
         "deepseek-v2-lite": (4, [False, False, True, False], [3])}
KEYS = ("swap_calls", "swap_experts", "prefetched", "prefetch_hits",
        "late_hits", "demand_misses", "host_syncs", "steps", "spec_layers",
        "replays")


def _every2(cfg, dtype):
    return dataclasses.replace(
        cfg, dtype=dtype, moe=dataclasses.replace(cfg.moe, moe_every=2))


@pytest.fixture(scope="module", params=sorted(ARCHS))
def arch(request):
    """(arch, bf16 port cfg, its params, f32 port cfg, f32 JAX cfg, JAX
    engine, f32 port params bridged from it)."""
    name = request.param
    layers = ARCHS[name][0]
    jcfg = _every2(jax_reduce_config(jax_get_config(name), layers=layers,
                                     **SMOKE), "float32")
    small = reduce_config(get_config(name), layers=layers, **SMOKE)
    cfg = _every2(small, "bfloat16")
    jeng = JaxEngine(jcfg, max_seq=64)
    gen = torch.Generator().manual_seed(0)
    return (name, cfg, Model(cfg).init(gen, device="cpu"),
            _every2(small, "float32"), jcfg, jeng,
            params_from_reference(jax.tree.map(np.asarray, jeng.params)))


def _engine(cfg, params, n_slots, **kw):
    return SlotBufferEngine(cfg, params, Model(cfg), max_seq=64,
                            n_slots_per_layer=n_slots, use_superkernel=True,
                            device="cpu", **kw)


def test_layout_has_a_dense_tail(arch):
    name, cfg, params = arch[:3]
    eng = _engine(cfg, params, 8)
    segs, tail = eng._sk_segments()
    assert [s.is_moe for s in eng.specs] == ARCHS[name][1]
    assert tail == ARCHS[name][2] and segs[-1][-1] < tail[0]


def test_tail_bitwise_vs_resident_oracle(arch):
    _, cfg, params = arch[:3]
    eng = _engine(cfg, params, 4, step_size=1, pregate_margin=0)
    prompt = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 1))
    lg, st = eng.prefill(prompt)
    lr, sr = eng.reference_prefill(prompt)
    assert torch.equal(lg, lr)
    tok = lr.argmax(-1)
    for step in range(8):
        lg, st = eng.decode_step(tok, st)
        lp, _ = sk_reference_decode_step(eng, tok, sr, tail_kernel=False)
        lr, sr = sk_reference_decode_step(eng, tok, sr)
        assert torch.equal(lg, lr), f"step {step}"
        assert bool(((lg - lp).abs() <= torch.clamp(
            2.0 ** -7 * lp.abs(), min=2e-2)).all()), f"step {step}"
        for a, b in zip(st.caches, sr.caches):
            assert a.keys() == b.keys()
            assert all(torch.equal(a[n], b[n]) for n in a)
        tok = lr.argmax(-1)
    assert eng.stats.evictions > 0


def _near_tie_ok(tok, ref_row, where):
    want = int(np.argmax(ref_row))
    if int(tok) != want:
        top2 = np.sort(ref_row)[-2:]
        assert top2[1] - top2[0] <= TOL_LOGITS, (
            f"{where}: token {int(tok)} != reference {want}, top-2 gap "
            f"{top2[1] - top2[0]:.4f}")


def test_tail_matches_reference_superkernel_engine(arch):
    cfg, jcfg, jeng, params = arch[3:]
    je = JaxSlotBufferEngine(jcfg, jeng.params, jeng.model, max_seq=64,
                             n_slots_per_layer=8, use_superkernel=True)
    te = _engine(cfg, params, 8)
    prompt = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 10))
    jl, js = je.prefill(jnp.asarray(prompt, jnp.int32))
    tl, ts = te.prefill(prompt)
    for step in range(4):
        jl_h = np.asarray(jl)
        np.testing.assert_allclose(tl.numpy(), jl_h, rtol=TOL_LOGITS,
                                   atol=TOL_LOGITS, err_msg=f"step {step}")
        for b in range(2):
            _near_tie_ok(tl.argmax(-1)[b], jl_h[b], f"step {step} row {b}")
        a, w = te.stats.snapshot(), je.stats.snapshot()
        assert [a[k] for k in KEYS] == [w[k] for k in KEYS], (step, a, w)
        if step == 3:
            break
        tok = jl_h.argmax(-1).astype(np.int32)      # the reference's tokens
        jl, js = je.decode_step(jnp.asarray(tok), js)
        tl, ts = te.decode_step(tok, ts)
