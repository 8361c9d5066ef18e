"""§3.4 cache-aware routing in the port against the reference (CPU).

- `core/cache_aware.py`: the port's `residency_logit_bias` equals the
  reference's bit for bit on the same masks, (E,) and (s, E), and the
  port's schedule helpers give the reference's numbers.
- `route(..., logit_bias=)`: the router's KL from the unbiased one stays
  within the strength delta (the bias's provable bound); a non-resident
  expert loses its place only to a resident one within delta logits.
- The engine, on the GQA arch (olmoe-1b-7b reduced to 4 layers, 8 experts
  top-2) and the MLA arch (deepseek-v2-lite smoke: a dense first layer,
  MLA, shared experts), on the unfused and the superkernel decode path:
  - strength 0 is bitwise the plain engine, both for an adaptive engine
    whose ceiling (1.0) turns the biased calls on while its controller
    sits at 0, and for `route_bias=0.0`;
  - at delta = 1.0 biased decode demands fewer experts, and swaps fewer,
    than unbiased decode of the same prompt under eviction churn.
- Against the JAX engine at `route_bias=1.0` on the olmoe smoke config
  (2 layers, 4 slots a layer), both paths (the JAX superkernel runs its
  Pallas kernels in interpret mode): logits teacher-forced on the
  reference's greedy tokens within 5e-2 (bf16 logits; a differing greedy
  token only at a near-tie, top two within 5e-2), and the host decisions
  equal counter for counter.
Inputs (prompts, masks, logits) come from numpy seeds; the weights are the
reference engine's, carried bitwise through the bridge.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import reduce_config as jax_reduce_config
from repro.configs.registry import get_config as jax_get_config
from repro.configs.registry import get_smoke_config as jax_smoke
from repro.core import cache_aware as jax_ca
from repro.runtime.engine import Engine as JaxEngine
from repro.runtime.engine import SlotBufferEngine as JaxSlotBufferEngine
from repro_torch.bridge import params_from_reference
from repro_torch.configs import get_config, get_smoke_config, reduce_config
from repro_torch.core import cache_aware
from repro_torch.models.moe import route
from repro_torch.models.transformer import Model
from repro_torch.runtime.engine import SlotBufferEngine

TOL = 5e-2
GQA_SMALL = dict(layers=4, d_model=64, heads=4, kv_heads=4, d_ff=128,
                 vocab=512, experts=8, top_k=2, d_expert=32)
PATHS = {"unfused": False, "superkernel": True}
COUNTERS = ("swap_calls", "swap_experts", "prefetched", "prefetch_hits",
            "late_hits", "demand_misses", "host_syncs", "steps",
            "spec_layers", "replays")


# ---------------------------------------------------------------- the bias
@pytest.mark.parametrize("strength", [0.0, 0.75, 1.0, 3.0])
@pytest.mark.parametrize("shape", [(8,), (64,), (3, 64), (5, 60)])
def test_residency_logit_bias_matches_reference(shape, strength):
    rng = np.random.default_rng(len(shape) * 100 + shape[-1])
    mask = rng.integers(0, 2, size=shape).astype(bool)
    want = np.asarray(jax_ca.residency_logit_bias(mask, strength))
    got = cache_aware.residency_logit_bias(mask, strength)
    assert got.dtype == np.float32 and got.shape == shape
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    got_t = cache_aware.residency_logit_bias(torch.from_numpy(mask),
                                             strength)
    assert got_t.dtype == torch.float32
    np.testing.assert_array_equal(got_t.numpy().view(np.uint32),
                                  want.view(np.uint32))


def test_schedules_match_reference():
    rng = np.random.default_rng(9)
    a = rng.integers(0, 16, size=(12, 2))
    resident = {int(e) for e in rng.permutation(16)[:7]}
    mine = cache_aware.split_by_residency(a, resident)
    ref = jax_ca.split_by_residency(a, resident)
    for f in ("resident_tokens", "deferred_tokens", "order"):
        np.testing.assert_array_equal(getattr(mine, f), getattr(ref, f))
    assert mine.missing_experts == ref.missing_experts
    for ready in (0.0, 0.4, 2.5):
        assert cache_aware.overlap_schedule(mine, 1.0, ready, 0.1) == \
            jax_ca.overlap_schedule(ref, 1.0, ready, 0.1)
        assert cache_aware.sequential_schedule(1.0, ready, 0.1) == \
            jax_ca.sequential_schedule(1.0, ready, 0.1)


@pytest.mark.parametrize("delta", [0.1, 0.5, 1.0, 3.0])
def test_router_kl_bounded_by_strength(delta):
    """KL(p_orig || p_biased) <= delta for any logits and residency mask,
    through the port's own router."""
    rng = np.random.default_rng(int(delta * 10))
    for _ in range(20):
        x = torch.from_numpy(rng.normal(size=(4, 8)).astype(np.float32))
        w = torch.from_numpy((rng.normal(size=(8, 16))
                              * rng.uniform(0.5, 4.0)).astype(np.float32))
        mask = rng.integers(0, 2, size=16).astype(bool)
        bias = torch.from_numpy(cache_aware.residency_logit_bias(mask, delta))
        p = route(w, x, 2)
        q = route(w, x, 2, logit_bias=bias)
        lp = torch.log_softmax(p.logits.double(), -1)
        lq = torch.log_softmax(q.logits.double(), -1)
        kl = (lp.exp() * (lp - lq)).sum(-1)
        assert bool((kl >= -1e-9).all() and (kl <= delta + 1e-6).all())


def test_route_swaps_top_k_only_within_strength_window():
    w = torch.zeros((4, 3))
    w[0] = torch.tensor([2.0, 1.7, 0.0])        # logits [2.0, 1.7, 0.0]
    x = torch.zeros((1, 4))
    x[0, 0] = 1.0
    mask = np.array([False, True, True])         # expert 0 not resident
    b = lambda s: torch.from_numpy(  # noqa: E731
        cache_aware.residency_logit_bias(mask, s))
    unbiased = route(w, x, 1)
    assert int(unbiased.expert_ids[0, 0]) == 0
    assert int(route(w, x, 1, logit_bias=b(0.5)).expert_ids[0, 0]) == 1
    assert int(route(w, x, 1, logit_bias=b(0.2)).expert_ids[0, 0]) == 0
    zero = route(w, x, 1, logit_bias=b(0.0))
    assert torch.equal(zero.probs, unbiased.probs)
    assert torch.equal(zero.expert_ids, unbiased.expert_ids)
    # a (T, E) bias: one row per token
    both = route(w, x.repeat(2, 1), 1,
                 logit_bias=torch.stack([b(0.5), b(0.2)]))
    assert both.expert_ids[:, 0].tolist() == [1, 0]


# ------------------------------------------------------------- the engine
@pytest.fixture(scope="module")
def arches():
    """arch -> (port config, port params, reference config, reference
    engine holding the same params)."""
    out = {}
    for arch, jcfg, cfg in (
            ("gqa", jax_reduce_config(jax_get_config("olmoe-1b-7b"),
                                      **GQA_SMALL),
             reduce_config(get_config("olmoe-1b-7b"), **GQA_SMALL)),
            ("mla", jax_smoke("deepseek-v2-lite"),
             get_smoke_config("deepseek-v2-lite"))):
        eng = JaxEngine(jcfg, max_seq=64)
        out[arch] = (cfg, params_from_reference(
            jax.tree.map(np.asarray, eng.params)), jcfg, eng)
    return out


def _engine(arches, arch, superkernel, **kw):
    cfg, params, _, _ = arches[arch]
    return SlotBufferEngine(cfg, params, Model(cfg), max_seq=64,
                            n_slots_per_layer=3, step_size=2,
                            use_superkernel=superkernel, device="cpu", **kw)


def _decode_rows(eng, prompt, n_steps):
    logits, st = eng.prefill(prompt[None, :])
    rows = [logits]
    tok = logits.argmax(-1)
    for _ in range(n_steps):
        logits, st = eng.decode_step(tok, st)
        rows.append(logits)
        tok = logits.argmax(-1)
    return rows


@pytest.mark.parametrize("path", list(PATHS))
@pytest.mark.parametrize("arch", ["gqa", "mla"])
def test_zero_strength_is_bitwise_the_plain_engine(arches, arch, path):
    cfg = arches[arch][0]
    prompt = np.random.default_rng(21).integers(0, cfg.vocab_size, 12)
    plain = _engine(arches, arch, PATHS[path])
    want = _decode_rows(plain, prompt, 8)
    assert plain.stats.demand_misses > 0          # the slot path churned
    # the ceiling turns the biased calls on; the controller's own ceiling
    # stays 0, so its strength cannot leave 0
    ca = _engine(arches, arch, PATHS[path])
    ca.route_bias, ca.route_bias_adaptive = 1.0, True
    assert ca.controller.cfg.route_bias_max == 0.0
    assert ca._route_bias_strength() == 0.0
    seen = []
    orig = ca._residency_bias
    ca._residency_bias = lambda li: seen.append(li) or orig(li)
    got = _decode_rows(ca, prompt, 8)
    assert seen, "the biased routing calls were not taken"
    for k, (a, b) in enumerate(zip(got, want)):
        assert torch.equal(a, b), f"diverged at step {k}"
    z = _engine(arches, arch, PATHS[path], route_bias=0.0)
    assert z.route_bias == 0.0
    for k, (a, b) in enumerate(zip(_decode_rows(z, prompt, 8), want)):
        assert torch.equal(a, b), f"route_bias=0.0 diverged at step {k}"
    a, w = ca.stats.snapshot(), plain.stats.snapshot()
    assert [a[k] for k in COUNTERS] == [w[k] for k in COUNTERS]


@pytest.mark.parametrize("path", list(PATHS))
@pytest.mark.parametrize("arch", ["gqa", "mla"])
def test_route_bias_reduces_demand_misses(arches, arch, path):
    """Under eviction churn, biased decode demands fewer non-resident
    experts and swaps fewer than unbiased decode of the same prompt."""
    cfg = arches[arch][0]
    prompt = np.random.default_rng(33).integers(0, cfg.vocab_size, 12)
    plain = _engine(arches, arch, PATHS[path])
    _decode_rows(plain, prompt, 10)
    biased = _engine(arches, arch, PATHS[path], route_bias=1.0)
    _decode_rows(biased, prompt, 10)
    assert biased.stats.demand_misses < plain.stats.demand_misses
    assert biased.stats.swap_experts < plain.stats.swap_experts


def test_set_route_bias_seeds_the_controller_ceiling(arches):
    eng = _engine(arches, "gqa", False)
    assert eng.route_bias == 0.0 and not eng.route_bias_adaptive
    eng.set_route_bias(0.8, adaptive=True)
    assert eng.controller.cfg.route_bias_max == pytest.approx(0.8)
    assert eng._route_bias_strength() == 0.0     # the controller starts at 0
    eng.controller.route_bias = 2.0
    assert eng._route_bias_strength() == pytest.approx(0.8)   # capped
    eng.set_route_bias(0.3)                      # fixed strength
    assert eng._route_bias_strength() == pytest.approx(0.3)
    # the bias rows come from the host slot table
    eng.ensure_resident(1, [2, 5])
    b = eng._residency_bias(1).numpy()
    assert b[2] == 0.0 and b[5] == 0.0
    assert (b[np.r_[0:2, 3:5, 6:8]] == np.float32(-0.3)).all()
    rows = eng._pregate_bias(0, 2).numpy()
    assert rows.shape == (2, 8)
    np.testing.assert_array_equal(rows[0], b)


# ------------------------------------------------ against the JAX engine
@pytest.fixture(scope="module")
def smoke():
    """(JAX model, JAX params, port params) of the olmoe smoke config."""
    from repro.models.transformer import Model as JaxModel
    jmodel = JaxModel(jax_smoke("olmoe-1b-7b"))
    jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(0))
    return jmodel, jparams, params_from_reference(
        jax.tree.map(np.asarray, jparams))


def _near_tie_ok(tok, ref_row, where):
    want = int(np.argmax(ref_row))
    if int(tok) != want:
        top2 = np.sort(ref_row)[-2:]
        assert top2[1] - top2[0] <= TOL, (
            f"{where}: token {int(tok)} != reference {want}, top-2 gap "
            f"{top2[1] - top2[0]:.4f}")


@pytest.mark.parametrize("path,n_steps", [("unfused", 8),
                                          ("superkernel", 5)])
def test_biased_engine_matches_reference_counter_for_counter(smoke, path,
                                                             n_steps):
    jmodel, jparams, tparams = smoke
    cfg = get_smoke_config("olmoe-1b-7b")
    kw = dict(n_slots_per_layer=4, use_kernel=True,
              use_superkernel=PATHS[path], route_bias=1.0)
    je = JaxSlotBufferEngine(jmodel.cfg, jparams, jmodel, **kw)
    te = SlotBufferEngine(cfg, tparams, Model(cfg), device="cpu", **kw)
    nonzero = []
    orig = te._residency_bias

    def bias(li):
        b = orig(li)
        nonzero.append(bool((b != 0).any()))
        return b
    te._residency_bias = bias
    prompt = np.random.default_rng(11).integers(0, cfg.vocab_size, (2, 12))
    jl, js = je.prefill(jnp.asarray(prompt, jnp.int32))
    tl, ts = te.prefill(prompt)
    for step in range(n_steps + 1):
        jl_h = np.asarray(jl)
        np.testing.assert_allclose(tl.numpy(), jl_h, rtol=TOL, atol=TOL,
                                   err_msg=f"step {step}")
        for b in range(prompt.shape[0]):
            _near_tie_ok(tl.argmax(-1)[b], jl_h[b], f"step {step} row {b}")
        a, w = te.stats.snapshot(), je.stats.snapshot()
        assert [a[k] for k in COUNTERS] == [w[k] for k in COUNTERS], \
            (step, a, w)
        assert te.controller.s_history == je.controller.s_history
        if step == n_steps:
            break
        tok = jl_h.argmax(-1).astype(np.int32)    # the reference's tokens
        jl, js = je.decode_step(jnp.asarray(tok), js)
        tl, ts = te.decode_step(tok, ts)
    assert any(nonzero), "no step routed with a nonzero bias"
    assert te.stats.swap_experts > 0 and te.stats.evictions > 0
