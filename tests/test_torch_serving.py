"""The port's ServingEngine against the reference's single-request path.

Four greedy requests served at batch 2 (monolithic admission, continuous
batching, eviction churn) must each produce the tokens the reference
engine generates for that prompt alone. The reference's batched path is
not the yardstick: its own batched-vs-single bitwise tests do not hold.
Where a stream first differs, the reference's top two logits at that step
must lie within 5e-2 (a near-tie); after that the contexts differ and the
comparison of that stream ends.
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
N_NEW = 6


def _reference_greedy(je, prompt):
    """Single-request greedy tokens and per-token logits of the reference's
    fully-resident path."""
    logits, st = je.reference_prefill(jnp.asarray(prompt[None], jnp.int32))
    toks, rows = [], []
    for step in range(N_NEW):
        row = np.asarray(logits)[0]
        toks.append(int(row.argmax()))
        rows.append(row)
        if step < N_NEW - 1:
            logits, st = je.reference_decode_step(
                jnp.asarray([toks[-1]], jnp.int32), st)
    return toks, rows


def test_serving_matches_reference_single_request_generate():
    jmodel = JaxModel(jax_smoke("olmoe-1b-7b"))
    jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(1))
    je = JaxEngine(jmodel.cfg, jparams, jmodel, n_slots_per_layer=4,
                   use_kernel=True)
    te = SlotBufferEngine(CFG, params_from_reference(
        jax.tree.map(np.asarray, jparams)), Model(CFG), n_slots_per_layer=4,
        use_kernel=True, device="cpu")
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, CFG.vocab_size, 8) for _ in range(4)]
    reqs = [Request(p, max_new_tokens=N_NEW) for p in prompts]
    srv = ServingEngine(te, EngineServingConfig(max_batch=2))
    report = srv.serve(reqs)
    assert len(report.requests) == 4
    assert te.stats.swap_experts > 0 and te.stats.evictions > 0
    for req, prompt in zip(reqs, prompts):
        assert len(req.output) == N_NEW
        want, rows = _reference_greedy(je, prompt)
        for step, (got_t, want_t) in enumerate(zip(req.output, want)):
            if got_t != want_t:
                top2 = np.sort(rows[step])[-2:]
                assert top2[1] - top2[0] <= TOL, (
                    f"request {req.request_id} step {step}: {got_t} != "
                    f"{want_t}, reference top-2 gap {top2[1] - top2[0]:.4f}")
                break


def test_chunked_serving_is_the_default_and_opens_cursors():
    """Chunked admission (32-token chunks) is the default, as in the
    reference: each admitted request opens a prefill cursor, every chunk
    goes through `prefill_chunk`, and every request is served in full."""
    assert EngineServingConfig().prefill_chunk == 32
    te = SlotBufferEngine(CFG, Model(CFG).init(device="cpu"), Model(CFG),
                          n_slots_per_layer=4, device="cpu")
    srv = ServingEngine(te, EngineServingConfig(max_batch=2,
                                                prefill_chunk=32))
    assert srv._chunked
    opened, chunks = [], []
    start, step = te.start_prefill, te.prefill_chunk
    te.start_prefill = lambda *a: opened.append(start(*a)) or opened[-1]
    te.prefill_chunk = lambda c: chunks.append(c.offset) or step(c)
    lens = (40, 8, 70)
    reqs = [Request(np.arange(n) % CFG.vocab_size, max_new_tokens=3)
            for n in lens]
    srv.serve(reqs)
    assert all(len(r.output) == 3 for r in reqs)
    assert [len(c.tokens) for c in opened] == list(lens)
    assert all(c.done and c.chunk == 32 for c in opened)
    assert len(chunks) == sum(-(-n // 32) for n in lens)
    assert not srv._prefills


def test_sampled_requests_follow_their_own_generator():
    """A sampled request draws from a generator seeded by (seed, request
    id): the same population served twice gives the same tokens, and a
    greedy neighbour is unaffected by sampling in its batch."""
    params = Model(CFG).init(torch.Generator().manual_seed(3), device="cpu")
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, CFG.vocab_size, 6) for _ in range(3)]
    outs = []
    for temps in ((1.0, 0.0, 0.7), (1.0, 0.0, 0.7), (0.0, 0.0, 0.0)):
        te = SlotBufferEngine(CFG, params, Model(CFG), n_slots_per_layer=4,
                              use_kernel=True, device="cpu")
        reqs = [Request(p, max_new_tokens=4, temperature=t, request_id=i)
                for i, (p, t) in enumerate(zip(prompts, temps))]
        ServingEngine(te, EngineServingConfig(max_batch=2)).serve(reqs)
        outs.append([r.output for r in reqs])
    assert outs[0] == outs[1]
    assert outs[0][1] == outs[2][1]
    assert all(0 <= t < CFG.vocab_size for o in outs[0] for t in o)


def test_straggler_policy_copy_matches_reference():
    from repro.distributed.fault_tolerance import StragglerPolicy as JaxPolicy
    from repro_torch.distributed.fault_tolerance import StragglerPolicy
    lat = np.concatenate([np.full(20, 0.01), np.full(10, 0.2),
                          np.full(30, 0.01)])
    a, b = StragglerPolicy(1, threshold=4.0, recovery=1.5), \
        JaxPolicy(1, threshold=4.0, recovery=1.5)
    flags = []
    for t in lat:
        a.record(0, float(t))
        b.record(0, float(t))
        assert a.draining(0) == b.draining(0)
        flags.append(a.draining(0))
    assert any(flags) and not flags[-1]


def test_brownout_admission_still_serves_everything():
    te = SlotBufferEngine(CFG, Model(CFG).init(device="cpu"), Model(CFG),
                          n_slots_per_layer=4, device="cpu")
    srv = ServingEngine(te, EngineServingConfig(max_batch=2,
                                                brownout_admission=True))
    reqs = [Request(np.arange(5) + i, max_new_tokens=3) for i in range(3)]
    srv.serve(reqs)
    assert all(len(r.output) == 3 for r in reqs)
