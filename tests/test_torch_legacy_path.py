"""The pre-fused engine path, `SlotBufferEngine(fused=False)`, against the
port's own model and the reference's legacy engine (CPU, olmoe smoke).

- Bitwise the eager unrolled model (`Model.forward`, every expert
  resident through `moe_grouped`) with every expert given a slot, and
  experts were swapped in (`swap_count > 0`), as the reference's
  `tests/test_runtime.py::test_slot_buffer_legacy_exact_vs_unrolled`.
- At 2 slots a layer (4 in all; 2-token batches route to at most 4
  experts a layer, so every layer's demand fits the pool) repeated
  forwards churn the buffer and stay bitwise the all-resident legacy run.
- Against the JAX legacy engine on the same weights (bridged bitwise) at
  3 slots a layer over three forwards: `steps`, `host_syncs`,
  `demand_misses`, `swap_calls`, `swap_experts` and `swap_count` equal, x
  within 5e-2, the bf16 tolerance of the other served tests. The
  reference's legacy path runs in bfloat16 only: its slot buffer is
  bfloat16 whatever the model's dtype, and its per-expert `swap_in`
  refuses a float32 expert, so there is no float32 twin.
- `prefetch` is off without the fused runtime, and the reference's four
  fused-only asserts (tiered store, `prefill`, `start_prefill`,
  `decode_step`) raise.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_smoke_config as jax_smoke
from repro.models.transformer import Model as JaxModel
from repro.runtime.engine import SlotBufferEngine as JaxSlotBufferEngine
from repro_torch.bridge import params_from_reference
from repro_torch.configs import get_smoke_config
from repro_torch.models.transformer import Model
from repro_torch.runtime.engine import SlotBufferEngine

CFG = get_smoke_config("olmoe-1b-7b")
TOL = 5e-2
COUNTERS = ("steps", "host_syncs", "demand_misses", "swap_calls",
            "swap_experts")


@pytest.fixture(scope="module")
def params():
    return Model(CFG).init(torch.Generator().manual_seed(0), device="cpu")


def _legacy(params, n_slots):
    return SlotBufferEngine(CFG, params, Model(CFG), n_slots_per_layer=n_slots,
                            fused=False, device="cpu")


def _tokens(seed, shape):
    return np.random.default_rng(seed).integers(0, CFG.vocab_size, shape)


def test_legacy_bitwise_vs_eager_unrolled_model(params):
    toks = torch.as_tensor(_tokens(2, (2, 10)))
    eng = _legacy(params, CFG.moe.num_experts)
    x = eng.forward(toks)
    assert torch.equal(x, Model(CFG).forward(params, toks))
    assert eng.swap_count > 0
    assert eng.stats.host_syncs == 2 and eng.stats.steps == 1
    assert eng.stats.swap_calls == eng.stats.swap_experts == eng.swap_count


def test_legacy_under_churn_bitwise_vs_all_resident(params):
    small = _legacy(params, 2)
    full = _legacy(params, CFG.moe.num_experts)
    for trial in range(6):
        toks = _tokens(20 + trial, (1, 2))
        assert torch.equal(small.forward(toks), full.forward(toks)), trial
    assert small.swap_count > full.swap_count
    assert small.stats.demand_misses == small.swap_count


def test_legacy_matches_reference_legacy_engine():
    jmodel = JaxModel(jax_smoke("olmoe-1b-7b"))
    jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(0))
    je = JaxSlotBufferEngine(jmodel.cfg, jparams, jmodel, n_slots_per_layer=3,
                             fused=False)
    te = _legacy(params_from_reference(jax.tree.map(np.asarray, jparams)), 3)
    for trial in range(3):
        toks = _tokens(30 + trial, (2, 5))
        xj = np.asarray(je.forward(jnp.asarray(toks, jnp.int32)))
        xt = te.forward(toks)
        np.testing.assert_allclose(xt.float().numpy(), xj.astype(np.float32),
                                   rtol=TOL, atol=TOL)
        a, w = te.stats.snapshot(), je.stats.snapshot()
        assert [a[k] for k in COUNTERS] == [w[k] for k in COUNTERS], trial
        assert te.swap_count == je.swap_count
    assert te.swap_count > 3 * 2


def test_legacy_has_no_prefetch_and_fused_only_paths_raise(params):
    eng = _legacy(params, 4)
    assert not eng.prefetch_enabled and not eng.fused
    prompt = _tokens(3, (1, 4))
    with pytest.raises(AssertionError, match="incremental decode"):
        eng.prefill(prompt)
    with pytest.raises(AssertionError, match="chunked prefill"):
        eng.start_prefill(prompt)
    with pytest.raises(AssertionError, match="incremental decode"):
        eng.decode_step(np.zeros(1, np.int64), None)
    with pytest.raises(AssertionError, match="tiered expert store"):
        SlotBufferEngine(CFG, params, Model(CFG), n_slots_per_layer=4,
                         fused=False, device="cpu",
                         store=types.SimpleNamespace(demand_host=None))
    assert SlotBufferEngine(CFG, params, Model(CFG), n_slots_per_layer=4,
                            device="cpu").prefetch_enabled
