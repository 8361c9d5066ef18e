"""Chunked prefill and chunked serving in the port, against the reference
package and against the port's own oracles, on the olmoe-1b-7b (GQA) and
DeepSeek-V2-Lite (MLA, shared experts, a dense first layer) smoke configs,
with the reference's weights carried over by `bridge.py` (CPU).

Across frameworks, `prefill_chunked` of one prompt at (T, C) in {(7, 4),
(12, 5), (9, 32), (24, 8)}: logits within 5e-2 (atol and rtol; bf16
products from differently ordered fp32 sums), the same greedy token unless
the reference's top two logits lie within 5e-2 (a near-tie), and the same
host-side residency decisions counter for counter under churn (3 slots per
MoE layer for 8 experts top-2).

Inside the port, exactly: chunked prefill through the slot path under
churn is bitwise equal to the same chunk functions over every expert
(`reference_prefill_chunked`), and to monolithic `prefill`, logits and the
decode steps that follow (both hold on the CPU; 4 slots per MoE layer, so
a layer's working set always fits and no token drops for want of a slot).
The scheduler tests are the reference's own (`tests/test_prefill_chunked.py`
aging, interleaving, chunked vs monolithic serving outputs) on the port.
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

TOL = 5e-2
MAX_SEQ = 64
ARCHS = ("olmoe-1b-7b", "deepseek-v2-lite")
CHUNKS = ((7, 4), (12, 5), (9, 32), (24, 8))
COUNTERS = ("swap_calls", "swap_experts", "prefetched", "prefetch_hits",
            "late_hits", "demand_misses", "host_syncs", "steps")


@pytest.fixture(scope="module", params=ARCHS)
def arch(request):
    """(arch, JAX model, JAX params, port params)."""
    jmodel = JaxModel(jax_smoke(request.param))
    jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(0))
    return (request.param, jmodel, jparams,
            params_from_reference(jax.tree.map(np.asarray, jparams)))


def _port(arch, params, **kw):
    cfg = get_smoke_config(arch)
    kw.setdefault("max_seq", MAX_SEQ)
    return SlotBufferEngine(cfg, params, Model(cfg), device="cpu", **kw)


def _prompt(arch, T, seed):
    cfg = get_smoke_config(arch)
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (1, T))


@pytest.mark.parametrize("T,C", CHUNKS, ids=str)
def test_chunked_prefill_matches_reference_package(arch, T, C):
    name, jmodel, jparams, tparams = arch
    kw = dict(n_slots_per_layer=3, use_kernel=True, step_size=2)
    je = JaxEngine(jmodel.cfg, jparams, jmodel, max_seq=MAX_SEQ, **kw)
    te = _port(name, tparams, **kw)
    prompt = _prompt(name, T, T * 31 + C)
    jl, _ = je.prefill_chunked(jnp.asarray(prompt, jnp.int32), chunk_size=C)
    tl, ts = te.prefill_chunked(prompt, chunk_size=C)
    jl = np.asarray(jl)
    assert tuple(tl.shape) == jl.shape and ts.pos == T
    np.testing.assert_allclose(tl.numpy(), jl, rtol=TOL, atol=TOL)
    want = int(jl[0].argmax())
    if int(tl[0].argmax()) != want:
        top2 = np.sort(jl[0])[-2:]
        assert top2[1] - top2[0] <= TOL, (
            f"greedy token {int(tl[0].argmax())} != reference {want}, "
            f"top-2 gap {top2[1] - top2[0]:.4f}")
    js_, ts_ = je.stats.snapshot(), te.stats.snapshot()
    for key in COUNTERS:
        assert ts_[key] == js_[key], (key, ts_[key], js_[key])
    assert te.cache.stats.evictions == je.cache.stats.evictions
    assert te.controller.s_history == je.controller.s_history
    assert ts_["steps"] == -(-T // C)          # one step per chunk


@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("T,C", CHUNKS, ids=str)
def test_chunked_prefill_bitwise_vs_fully_resident_oracle(arch, T, C,
                                                          use_kernel):
    name, _, _, tparams = arch
    te = _port(name, tparams, n_slots_per_layer=4, use_kernel=use_kernel,
               step_size=1)
    for seed in (1, 2):          # the second prompt meets a warm, full cache
        prompt = _prompt(name, T, seed)
        lc, sc = te.prefill_chunked(prompt, chunk_size=C)
        lr, sr = te.reference_prefill_chunked(prompt, chunk_size=C)
        assert torch.equal(lc, lr)
        for a, b in zip(sc.caches, sr.caches):
            assert all(torch.equal(a[n], b[n]) for n in a)
    assert te.stats.evictions > 0, "the cache never churned"


@pytest.mark.parametrize("T,C", CHUNKS, ids=str)
def test_chunked_prefill_bitwise_vs_monolithic(arch, T, C):
    """On the CPU the chunked and the whole-prompt prefill give the same
    bits, logits and the four decode steps after them (the reference pins
    the same contract)."""
    name, _, _, tparams = arch
    kw = dict(n_slots_per_layer=4, use_kernel=True, step_size=2)
    mono, chun = _port(name, tparams, **kw), _port(name, tparams, **kw)
    prompt = _prompt(name, T, 7 * T + C)
    lm, sm = mono.prefill(prompt)
    lc, sc = chun.prefill_chunked(prompt, chunk_size=C)
    assert torch.equal(lm, lc), f"prefill logits differ at T={T} C={C}"
    tok = lm.argmax(-1)
    for step in range(4):
        lm, sm = mono.decode_step(tok, sm)
        lc, sc = chun.decode_step(tok, sc)
        assert torch.equal(lm, lc), f"decode step {step} differs"
        tok = lm.argmax(-1)
    assert chun.stats.evictions > 0


def test_padding_rows_demand_nothing(arch):
    """A chunk's padding rows (embedding of token 0) never reach routing
    demand: a 1-token prompt in a 32-wide chunk demands exactly the top-k
    experts of its one token per MoE layer."""
    name, _, _, tparams = arch
    te = _port(name, tparams, n_slots_per_layer=8, step_size=0)
    cfg = get_smoke_config(name)
    te.prefill_chunked(_prompt(name, 1, 3), chunk_size=32)
    n_moe = len(te.moe_layer_ids)
    assert te.stats.demand_misses == n_moe * cfg.moe.top_k


def test_prefill_into_with_chunks_commits_the_cursor(arch):
    """`prefill_into(chunk_size=)` and `start_prefill` / `prefill_chunk` /
    `finish_prefill_into` give the row the same caches and logits as
    monolithic `prefill_into`."""
    name, _, _, tparams = arch
    kw = dict(n_slots_per_layer=4, step_size=1)
    a, b = _port(name, tparams, **kw), _port(name, tparams, **kw)
    prompt = _prompt(name, 13, 4)
    sa, sb = a.alloc_decode_state(3), b.alloc_decode_state(3)
    la = a.prefill_into(sa, 1, prompt)
    lb = b.prefill_into(sb, 1, prompt, chunk_size=6)
    assert torch.equal(la, lb)
    assert sb.active.tolist() == [False, True, False] and sb.pos[1] == 13
    for ca, cb in zip(sa.caches, sb.caches):
        assert all(torch.equal(ca[n], cb[n]) for n in ca)
    cur = b.start_prefill(prompt[0], 6)
    while not b.prefill_chunk(cur):
        assert cur.logits is None
    with pytest.raises(ValueError):
        b.finish_prefill_into(sb, 1, cur)         # row 1 is taken
    assert torch.equal(b.finish_prefill_into(sb, 2, cur), la)
    with pytest.raises(ValueError):
        b.prefill_chunk(cur)                      # nothing left to ingest


def test_start_prefill_rejects_what_it_cannot_ingest(arch):
    name, _, _, tparams = arch
    te = _port(name, tparams, n_slots_per_layer=4)
    with pytest.raises(ValueError):
        te.start_prefill(np.zeros((2, 5), np.int64))
    with pytest.raises(ValueError):
        te.start_prefill(np.zeros(MAX_SEQ + 1, np.int64))
    with pytest.raises(ValueError):
        te.start_prefill(np.zeros(5, np.int64), chunk_size=0)


# ---------------------------------------------------------------------------
# the scheduler: the reference's serving tests on the port (olmoe smoke)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def olmoe_params():
    cfg = get_smoke_config("olmoe-1b-7b")
    return Model(cfg).init(torch.Generator().manual_seed(5), device="cpu")


def test_long_prefill_not_starved_by_short_stream(olmoe_params):
    """Aging: a stream of 1-token short requests cannot defer a long
    prompt's ingestion until the stream drains."""
    cfg = get_smoke_config("olmoe-1b-7b")
    rng = np.random.default_rng(21)
    long_req = Request(rng.integers(0, cfg.vocab_size, 32), max_new_tokens=2)
    shorts = [Request(rng.integers(0, cfg.vocab_size, 8), max_new_tokens=1,
                      arrival_s=1e-3) for _ in range(32)]
    te = _port("olmoe-1b-7b", olmoe_params, n_slots_per_layer=4, step_size=1)
    srv = ServingEngine(te, EngineServingConfig(max_batch=2, prefill_chunk=8,
                                                admission_cap=False))
    srv.serve([long_req] + shorts)
    assert len(long_req.output) == 2
    assert long_req.prefill_done_s < max(s.first_token_s for s in shorts)


def test_serving_interleaves_decode_with_long_prefill(olmoe_params):
    """A decoding short request finishes before a long prompt's chunked
    prefill completes, a later short prompt overtakes the long cursor, and
    both outputs equal each request generated alone."""
    cfg = get_smoke_config("olmoe-1b-7b")
    rng = np.random.default_rng(5)
    long_req = Request(rng.integers(0, cfg.vocab_size, 56), max_new_tokens=4)
    short_req = Request(rng.integers(0, cfg.vocab_size, 8), max_new_tokens=6)
    te = _port("olmoe-1b-7b", olmoe_params, n_slots_per_layer=4, step_size=1)
    srv = ServingEngine(te, EngineServingConfig(max_batch=2, prefill_chunk=8,
                                                admission_cap=False))
    assert srv._chunked
    rep = srv.serve([long_req, short_req])
    assert short_req.finish_s < long_req.prefill_done_s
    assert short_req.first_token_s < long_req.first_token_s
    ref = _port("olmoe-1b-7b", olmoe_params, n_slots_per_layer=4,
                step_size=1)
    for r in (long_req, short_req):
        np.testing.assert_array_equal(
            np.asarray(r.output),
            ref.generate(np.asarray(r.prompt)[None, :], r.max_new_tokens)[0])
    for m in rep.requests:
        assert m.prefill_s > 0 and m.first_step_s >= 0
        assert m.ttft_s == pytest.approx(
            m.queue_delay_s + m.prefill_s + m.first_step_s)


@pytest.mark.parametrize("superkernel", [False, True],
                         ids=["unfused", "superkernel"])
def test_chunked_serving_matches_monolithic_serving_outputs(olmoe_params,
                                                            superkernel):
    cfg = get_smoke_config("olmoe-1b-7b")
    outs = {}
    for chunk in (0, 8):
        rng = np.random.default_rng(9)
        reqs = [Request(rng.integers(0, cfg.vocab_size, n), max_new_tokens=4)
                for n in (20, 8, 33, 8)]
        te = _port("olmoe-1b-7b", olmoe_params, n_slots_per_layer=4,
                   step_size=1, use_kernel=True, use_superkernel=superkernel)
        ServingEngine(te, EngineServingConfig(
            max_batch=3, prefill_chunk=chunk)).serve(reqs)
        outs[chunk] = [list(r.output) for r in reqs]
    assert outs[0] == outs[8]
