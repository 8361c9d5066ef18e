"""The port's trace-collecting `Engine` (`runtime/engine.py`: `Engine`,
`layer_decode_collect`, `_attn_only_decode`, `build_host_store`, and
`router_sink` through `models/transformer.py`) against the JAX `Engine`
(CPU), on the olmoe-1b-7b, DeepSeek-V2-Lite and qwen1.5 smoke configs with
the JAX engine's params bridged bitwise.

- float32: every step's recorded expert ids, sampled tokens and token
  context are equal; hidden means within 1e-5 and each sample's mean
  pre-gate probabilities within 1e-6 (fp32 sums in another order); the
  `TraceLog` samples are otherwise equal field for field.
- bfloat16 (the configs' dtype): the two frameworks' activations differ in
  their last bits, so a router's k-th choice can flip at a near-tie. Until
  the first parting every id and token is equal and the hidden means are
  within 5e-2; the first parting is a router near-tie (the swapped
  experts' router logits within 5e-2 of each other, in both frameworks)
  or a near-tie of the reference's top two logits.
- The reference's own tests of the engine (decoded tokens extend the
  recorded context, the 64-id window slides, traces feed the predictor,
  routing is deterministic) run on the port; so does the reference's
  end-to-end loop (`tests/test_system.py`): traces, forest, simulation.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs.registry import get_smoke_config as jax_smoke
from repro.runtime.engine import Engine as JaxEngine
from repro.runtime.engine import build_host_store as jax_build_host_store
from repro_torch.bridge import params_from_reference
from repro_torch.configs import get_smoke_config
from repro_torch.core import (FeatureSpec, ForestPredictor, baseline,
                              expertflow)
from repro_torch.core.coordinator import ablation
from repro_torch.core.predictor import PreGate, recall_accuracy
from repro_torch.models import moe as moe_mod
from repro_torch.models.transformer import layer_forward, layer_prefill
from repro_torch.runtime.engine import Engine, build_host_store
from repro_torch.simulator.events import SimSpec, simulate
from repro_torch.simulator.hardware import PLATFORMS

NEAR_TIE = 5e-2
ARCHS = ("olmoe-1b-7b", "deepseek-v2-lite", "qwen1.5-moe-a2.7b")


@pytest.fixture(scope="module")
def engines():
    """(arch, dtype) -> (JAX engine, port engine on the same params)."""
    out = {}
    for arch in ARCHS:
        for dt in ("float32", "bfloat16"):
            je = JaxEngine(dataclasses.replace(jax_smoke(arch), dtype=dt),
                           max_seq=64)
            te = Engine(dataclasses.replace(get_smoke_config(arch),
                                            dtype=dt),
                        max_seq=64, device="cpu")
            te.params = params_from_reference(
                jax.tree.map(np.asarray, je.params))
            out[arch, dt] = (je, te)
    return out


def _recording(eng, names, store):
    """Wrap `eng`'s collect functions: each call appends (router probs per
    MoE layer, logits) as numpy to `store`. Returns an undo function."""
    origs = {n: getattr(eng, n) for n in names}

    def wrap(orig):
        def call(*a, **kw):
            res = orig(*a, **kw)
            conv = (lambda x: x.float().cpu().numpy()) \
                if isinstance(res[0], torch.Tensor) else np.asarray
            store.append(([conv(p) for _, p in res[2]], conv(res[0])))
            return res
        return call
    for n, o in origs.items():
        setattr(eng, n, wrap(o))
    return lambda: [setattr(eng, n, o) for n, o in origs.items()]


def _generate_both(je, te, prompt, n_steps):
    js, ts = [], []
    undo_j = _recording(je, ("_prefill", "_decode"), js)
    undo_t = _recording(te, ("_prefill_collect", "_decode_collect"), ts)
    try:
        ref = je.generate(prompt, n_steps=n_steps)
        got = te.generate(prompt, n_steps=n_steps)
    finally:
        undo_j()
        undo_t()
    return ref, got, js, ts


@pytest.mark.parametrize("arch", ARCHS)
def test_f32_traces_equal_the_reference(engines, arch):
    je, te = engines[arch, "float32"]
    prompt = np.random.default_rng(3).integers(
        0, te.cfg.vocab_size, (2, 12)).astype(np.int32)
    (o1, t1, l1), (o2, t2, l2), _, _ = _generate_both(je, te, prompt, 6)
    np.testing.assert_array_equal(o2, o1)
    assert o2.dtype == np.int32
    assert (t2.model, t2.num_moe_layers, t2.num_experts, t2.top_k) == \
        (t1.model, t1.num_moe_layers, t1.num_experts, t1.top_k)
    for a, b in zip(t2.routers, t1.routers):
        np.testing.assert_array_equal(a, np.asarray(b, np.float32))
    assert len(t2.steps) == len(t1.steps) == 6
    for s2, s1 in zip(t2.steps, t1.steps):
        assert s2.step_idx == s1.step_idx
        np.testing.assert_array_equal(s2.token_ids, s1.token_ids)
        for a, b in zip(s2.assignments, s1.assignments):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_allclose(s2.hidden_pooled, s1.hidden_pooled,
                                   rtol=0, atol=1e-5)
        assert (s2.embeddings is None) == (s1.embeddings is None)
    np.testing.assert_array_equal(t2.steps[0].embeddings,
                                  t1.steps[0].embeddings)
    assert len(l2.samples) == len(l1.samples) == 6 * t1.num_moe_layers
    for x, y in zip(l2.samples, l1.samples):
        assert (x.token_ids, x.layer_idx, x.predicted_experts,
                x.actual_experts, x.step_size, x.request_id) == \
            (y.token_ids, y.layer_idx, y.predicted_experts,
             y.actual_experts, y.step_size, y.request_id)
        np.testing.assert_allclose(x.pregate_probs, y.pregate_probs,
                                   rtol=0, atol=1e-6)


def _first_parting(t1, t2, o1, js, ts):
    """Walk the steps of two traces of one prompt. Returns None if every
    id and token is equal, else (what, step, layer, gaps): at the first
    router parting the swapped experts' log-probability gaps in the
    reference and the port (both >= 0 by construction), or at the first
    token parting the reference's top-2 logit gap."""
    for s, (s1, s2) in enumerate(zip(t1.steps, t2.steps)):
        for li, (a, b) in enumerate(zip(s1.assignments, s2.assignments)):
            rows = [t for t in range(a.shape[0])
                    if set(a[t].tolist()) != set(b[t].tolist())]
            if rows:
                t = rows[0]
                A = sorted(set(a[t].tolist()) - set(b[t].tolist()))
                B = sorted(set(b[t].tolist()) - set(a[t].tolist()))
                lj, lt = np.log(js[s][0][li][t]), np.log(ts[s][0][li][t])
                return ("ids", s, li, (float(lj[A].min() - lj[B].max()),
                                       float(lt[B].min() - lt[A].max())))
        toks = js[s][1].argmax(-1)
        if not np.array_equal(toks, ts[s][1].argmax(-1)):
            row = np.sort(js[s][1][int(np.flatnonzero(
                toks != ts[s][1].argmax(-1))[0])])
            return ("tokens", s, None, (float(row[-1] - row[-2]),))
        np.testing.assert_array_equal(o1[:, s], toks)
    return None


@pytest.mark.parametrize("seed", [3, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_traces_equal_the_reference_until_a_near_tie(engines, arch,
                                                          seed):
    je, te = engines[arch, "bfloat16"]
    prompt = np.random.default_rng(seed).integers(
        0, te.cfg.vocab_size, (2, 12)).astype(np.int32)
    (o1, t1, _), (o2, t2, _), js, ts = _generate_both(je, te, prompt, 6)
    part = _first_parting(t1, t2, o1, js, ts)
    stop = len(t1.steps) if part is None else part[1]
    for s in range(stop):
        np.testing.assert_allclose(t2.steps[s].hidden_pooled,
                                   t1.steps[s].hidden_pooled, rtol=0,
                                   atol=NEAR_TIE)
        np.testing.assert_array_equal(o2[:, s], o1[:, s])
    if part is not None:
        assert max(part[3]) <= NEAR_TIE, part


def test_generate_records_decoded_tokens(engines):
    """The reference's regression: each step's trace entry includes the
    tokens sampled so far, and the 64-id TraceLog window slides."""
    _, eng = engines["olmoe-1b-7b", "bfloat16"]
    B, T, n = 2, 6, 4
    prompt = np.random.default_rng(3).integers(
        0, eng.cfg.vocab_size, (B, T)).astype(np.int32)
    out, trace, _ = eng.generate(prompt, n_steps=n)
    assert [len(st.token_ids) for st in trace.steps] == \
        [B * T + B * k for k in range(n)]
    for k in range(1, n):
        np.testing.assert_array_equal(trace.steps[k].token_ids[-B:],
                                      out[:, k - 1])
    long_prompt = np.random.default_rng(5).integers(
        0, eng.cfg.vocab_size, (B, 40)).astype(np.int32)
    out2, _, log2 = eng.generate(long_prompt, n_steps=3)
    last = log2.samples[-len(eng.moe_layer_ids)].token_ids
    assert len(last) == 64
    np.testing.assert_array_equal(np.asarray(last[-B:]), out2[:, 1])


def test_generate_collects_traces_and_feeds_the_predictor(engines):
    _, eng = engines["qwen1.5-moe-a2.7b", "bfloat16"]
    toks = np.random.default_rng(0).integers(0, eng.cfg.vocab_size, (2, 12))
    out, trace, log = eng.generate(toks, n_steps=6)
    L = len(eng.moe_layer_ids)
    assert out.shape == (2, 6) and len(trace.steps) == 6
    assert trace.num_moe_layers == L
    for st in trace.steps:
        assert len(st.assignments) == L
        assert st.hidden_pooled.shape == (L, eng.cfg.d_model)
    assert len(log.samples) == 6 * L
    pred = ForestPredictor(FeatureSpec(eng.cfg.vocab_size, 8, L,
                                       trace.num_experts,
                                       include_pregate=True))
    mse = pred.fit(log)
    assert np.isfinite(mse) and mse < 0.5


def test_sampling_is_reproducible_from_the_generator(engines):
    _, eng = engines["olmoe-1b-7b", "bfloat16"]
    toks = np.random.default_rng(1).integers(0, eng.cfg.vocab_size, (2, 8))
    runs = [eng.generate(toks, 3, temperature=1.0,
                         generator=torch.Generator().manual_seed(9))[0]
            for _ in range(2)]
    np.testing.assert_array_equal(runs[0], runs[1])
    a, b = (eng.generate(toks, 3, temperature=1.0)[0] for _ in range(2))
    np.testing.assert_array_equal(a, b)      # default: seeded 17


def test_build_host_store_matches_reference(engines):
    je, te = engines["deepseek-v2-lite", "bfloat16"]
    mine = build_host_store(te.model, te.params)
    ref = jax_build_host_store(je.model, je.params)
    assert sorted(mine._layers) == sorted(ref._layers) == \
        list(range(len(te.moe_layer_ids)))
    for li in mine._layers:
        for a, b in zip(mine.layer(li), ref._layers[li]):
            np.testing.assert_array_equal(
                a.view(torch.uint16).numpy(),
                np.asarray(b).view(np.uint16))
        assert not mine.layer(li)[0].is_pinned()


def test_router_sink_leaves_layers_bitwise_and_sees_every_token(engines):
    _, eng = engines["olmoe-1b-7b", "bfloat16"]
    cfg, p = eng.cfg, eng.params["layers"][0]
    spec = eng.specs[0]
    x = torch.randn((3, 5, cfg.d_model), generator=torch.Generator()
                    .manual_seed(0)).to(eng.model.dtype)
    pos = torch.arange(5)[None, :].expand(3, 5)
    sink = []
    a, ca = layer_prefill(p, cfg, spec, x, pos, 16, router_sink=sink)
    b, cb = layer_prefill(p, cfg, spec, x, pos, 16)
    assert torch.equal(a, b) and all(torch.equal(ca[n], cb[n]) for n in ca)
    assert sink[0].expert_ids.shape == (15, cfg.moe.top_k)
    s2 = []
    assert torch.equal(layer_forward(p, cfg, spec, x, pos, router_sink=s2),
                       layer_forward(p, cfg, spec, x, pos))
    # the grouped MoE's router output covers every group, group-major
    h = x.reshape(3, 5, -1)
    _, r = moe_mod.moe_grouped(p["moe"], h, cfg.moe)
    for g in range(3):
        _, rg = moe_mod.moe_grouped(p["moe"], h[g], cfg.moe)
        assert torch.equal(r.expert_ids[5 * g: 5 * g + 5], rg.expert_ids)
        assert torch.equal(r.probs[5 * g: 5 * g + 5], rg.probs)


def test_engine_needs_cuda_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Engine(get_smoke_config("olmoe-1b-7b"))


# ------------------------------------------------ the end-to-end loop
@pytest.fixture(scope="module")
def pipeline(engines):
    """The reference system test's loop on the port: traces of the
    DeepSeek smoke config, a forest fit on them."""
    _, eng = engines["deepseek-v2-lite", "bfloat16"]
    toks = np.random.default_rng(0).integers(0, eng.cfg.vocab_size, (2, 16))
    _, trace, log = eng.generate(toks, n_steps=16)
    forest = ForestPredictor(FeatureSpec(eng.cfg.vocab_size, 8,
                                         trace.num_moe_layers,
                                         trace.num_experts,
                                         include_pregate=True))
    forest.fit(log)
    return eng, trace, forest


def _spec(trace, frac=0.9):
    L, M = trace.num_moe_layers, trace.num_experts
    return SimSpec(expert_bytes=17.3e6, layer_time_s=1e-3,
                   capacity_experts=max(4, int(L * M * frac)))


def test_full_loop_expertflow_beats_baseline(pipeline):
    _, trace, forest = pipeline
    hw = PLATFORMS["a6000"]
    base = simulate(trace, _spec(trace), hw, baseline())
    ef = simulate(trace, _spec(trace), hw, expertflow(), forest=forest)
    assert ef.total_stall_s < base.total_stall_s
    assert ef.hit_rate >= base.hit_rate - 0.05
    pol = ablation("oracle", predictor="oracle", adaptive_s=False, fixed_s=3)
    rep = simulate(trace, _spec(trace, 1.0), PLATFORMS["h20"], pol)
    assert sum(s.stall_s for s in rep.steps[2:]) == pytest.approx(0.0,
                                                                 abs=1e-9)
    block = simulate(trace, _spec(trace, 0.5), PLATFORMS["rtx4090"],
                     ablation("block", blocking_swap_out=True),
                     forest=forest)
    free = simulate(trace, _spec(trace, 0.5), PLATFORMS["rtx4090"],
                    expertflow(), forest=forest)
    assert free.total_stall_s <= block.total_stall_s + 1e-9


def test_predictor_beats_pregate_on_the_ports_trace(pipeline):
    _, trace, forest = pipeline
    pregate = PreGate(trace.routers)
    L = trace.num_moe_layers
    s = 1 if L <= 2 else 2
    acc_p = acc_g = 0.0
    n = 0
    for st in trace.steps[1:]:
        hist = np.zeros((L, trace.num_experts))
        for li in range(L - s):
            tgt = li + s
            actual = sorted({int(e) for e in st.assignments[tgt].reshape(-1)})
            k = max(len(actual), trace.top_k)
            pg = pregate.probs(st.hidden_pooled[li][None, :], tgt)
            scores = forest.scores(st.token_ids, tgt, s, hist, pg)
            acc_g += recall_accuracy(np.argsort(pg)[-k:], actual)
            acc_p += recall_accuracy(np.argsort(scores)[-k:], actual)
            n += 1
            for e in actual:
                hist[tgt, e] = 1.0
    assert n > 0 and acc_p / n >= acc_g / n - 1e-9


def test_engine_routing_is_deterministic(pipeline):
    eng = pipeline[0]
    toks = np.random.default_rng(5).integers(0, eng.cfg.vocab_size, (2, 10))
    out1, tr1, _ = eng.generate(toks, n_steps=4)
    out2, tr2, _ = eng.generate(toks, n_steps=4)
    np.testing.assert_array_equal(out1, out2)
    for a, b in zip(tr1.steps, tr2.steps):
        for x, y in zip(a.assignments, b.assignments):
            np.testing.assert_array_equal(x, y)
