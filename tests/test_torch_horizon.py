"""The adaptive horizon's engine knobs (`prefetch`, `link_bandwidth`,
`controller`) in the port against the reference (CPU).

- The reference's three controller tests (S rises under a starved link,
  S falls under sustained overfetch, the §3.3.2 capacity guard damps
  raises) on the port, each also run on the JAX `SlotBufferEngine` at the
  same settings on the same weights (bridged bitwise), teacher-forced on
  the reference's greedy tokens: final S, `s_history`, `late_hits`,
  `demand_misses` and `prefetch_hits` equal. The twins run in float32
  (olmoe-1b-7b cut to 4 layers, 8 experts top-2): in bfloat16 the two
  frameworks' routers part at a near-tie by the third decode step, after
  which their counters differ by one; in float32 they agree at every
  step. The reference's own assertions also run on the port alone in
  bfloat16, on its own `Model.init` weights.
- Both engines feed measured copy times to the controller's bandwidth
  estimate (the JAX engine its host wall time per batched write, the port
  its copy seconds). No engine decision reads that estimate: only
  `initialize` (never called by either engine) and the serving loop's
  admission cap (not used here) do. So S and the counters do not depend
  on it, and nothing is neutralised here.
- `prefetch=False`, on both decode paths, GQA and MLA: `_horizon` is 0,
  nothing is prefetched and no layer runs speculatively; the logits are
  bitwise the fully-resident oracle's; the counters equal the JAX
  engine's (smoke configs in float32). The superkernel path still
  replays: routing runs inside the segment, so a segment that finds an
  expert absent is verified and replayed, in both frameworks.
- Default knobs: an engine given `prefetch=True`, `link_bandwidth=64e9`
  and no controller is bitwise the engine built without them, and a
  caller's controller is used as given (not clamped, not re-seeded).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import reduce_config as jax_reduce_config
from repro.configs.registry import get_config as jax_get_config
from repro.configs.registry import get_smoke_config as jax_smoke
from repro.core.step_size import StepSizeConfig as JaxStepSizeConfig
from repro.core.step_size import StepSizeController as JaxController
from repro.models.transformer import Model as JaxModel
from repro.runtime.engine import Engine as JaxEngine
from repro.runtime.engine import SlotBufferEngine as JaxSlotBufferEngine
from repro_torch.bridge import params_from_reference
from repro_torch.configs import get_config, get_smoke_config, reduce_config
from repro_torch.core.step_size import StepSizeConfig, StepSizeController
from repro_torch.models.transformer import Model
from repro_torch.runtime.engine import LINK_BANDWIDTH, SlotBufferEngine
from test_torch_cuda import sk_reference_decode_step

SMALL = dict(layers=4, d_model=64, heads=4, kv_heads=4, d_ff=128, vocab=512,
             experts=8, top_k=2, d_expert=32)
TWIN = ("late_hits", "demand_misses", "prefetch_hits", "prefetched",
        "spec_layers", "replays", "host_syncs", "swap_calls")
PATHS = {"unfused": False, "superkernel": True}


def _f32(cfg):
    return dataclasses.replace(cfg, dtype="float32")


@pytest.fixture(scope="module")
def small():
    """dtype -> (port cfg, port params, JAX cfg, JAX engine) on the
    reference test's 4-layer olmoe: in float32 the port's params are
    bridged from the JAX engine's; in bfloat16 (port only) they are the
    port's own `Model.init` from a seeded generator."""
    jcfg = _f32(jax_reduce_config(jax_get_config("olmoe-1b-7b"), **SMALL))
    cfg = reduce_config(get_config("olmoe-1b-7b"), **SMALL)
    je = JaxEngine(jcfg, max_seq=64)
    gen = torch.Generator().manual_seed(0)
    return {"float32": (_f32(cfg), params_from_reference(
                jax.tree.map(np.asarray, je.params)), jcfg, je),
            "bfloat16": (cfg, Model(cfg).init(gen, device="cpu"), None,
                         None)}


PROMPT = np.random.default_rng(7).integers(0, 512, (2, 12)).astype(np.int32)


def _drive_port(sb, n_steps=10):
    logits, state = sb.prefill(PROMPT)
    for _ in range(n_steps):
        logits, state = sb.decode_step(logits.argmax(-1), state)


def _twin(small, ctrl_kw, s0, n_slots=6, **kw):
    """The port and the JAX engine on the same weights and controller
    settings, teacher-forced on the reference's tokens. Returns ((port
    controller, port engine), (JAX controller, JAX engine))."""
    cfg, tparams, jcfg, je = small["float32"]
    tc = StepSizeController(cfg=StepSizeConfig(**ctrl_kw), s=s0)
    jc = JaxController(cfg=JaxStepSizeConfig(**ctrl_kw), s=s0)
    te = SlotBufferEngine(cfg, tparams, Model(cfg), n_slots_per_layer=n_slots,
                          max_seq=64, controller=tc, device="cpu", **kw)
    jsb = JaxSlotBufferEngine(jcfg, je.params, je.model,
                              n_slots_per_layer=n_slots, max_seq=64,
                              controller=jc, **kw)
    jl, js = jsb.prefill(jnp.asarray(PROMPT))
    tl, ts = te.prefill(PROMPT)
    for step in range(10):
        _same(te, tc, jsb, jc, f"step {step}")
        tok = np.asarray(jl).argmax(-1).astype(np.int32)
        jl, js = jsb.decode_step(jnp.asarray(tok), js)
        tl, ts = te.decode_step(tok, ts)
    _same(te, tc, jsb, jc, "end")
    return (tc, te), (jc, jsb)


def _same(te, tc, jsb, jc, where):
    a = [getattr(te.stats, k) for k in TWIN]
    w = [getattr(jsb.stats, k) for k in TWIN]
    assert a == w, (where, dict(zip(TWIN, a)), dict(zip(TWIN, w)))
    assert (tc.s, tc.s_history, tc.guard_hits) == \
        (jc.s, jc.s_history, jc.guard_hits), where


def _port(small, ctrl_kw, s0, **kw):
    cfg, tparams, _, _ = small["bfloat16"]
    ctrl = StepSizeController(cfg=StepSizeConfig(**ctrl_kw), s=s0)
    sb = SlotBufferEngine(cfg, tparams, Model(cfg), n_slots_per_layer=6,
                          max_seq=64, controller=ctrl, device="cpu", **kw)
    _drive_port(sb)
    return ctrl, sb


STARVED = dict(capacity_guard=False, stall_threshold=40,
               overfetch_threshold=10 ** 9)


@pytest.mark.parametrize("link", ["starved", "fast"])
def test_s_rises_under_starved_link_counter_for_counter(small, link):
    bw = 1.0 if link == "starved" else 64e9
    (tc, te), _ = _twin(small, STARVED, 2, link_bandwidth=bw)
    assert te.link.bandwidth == bw
    if link == "starved":
        assert te.stats.late_hits > 0 and tc.s > 2
    else:
        assert te.stats.late_hits == 0 and tc.s == 2


def test_s_rises_under_starved_link_bf16(small):
    """The reference test's own assertions on the port at its dtype."""
    results = {}
    for name, bw in (("starved", 1.0), ("fast", 64e9)):
        ctrl, sb = _port(small, STARVED, 2, link_bandwidth=bw)
        results[name] = (ctrl.s, sb.stats.late_hits)
    assert results["fast"][1] == 0 and results["fast"][0] == 2
    assert results["starved"][1] > 0
    assert results["starved"][0] > 2


OVERFETCH = dict(stall_threshold=10 ** 9, overfetch_threshold=2)


def _walks_down(ctrl):
    assert ctrl.s == ctrl.cfg.s_min
    assert ctrl.s_history and all(
        b < a for a, b in zip([3] + ctrl.s_history, ctrl.s_history))


def test_s_falls_under_sustained_overfetch_counter_for_counter(small):
    (tc, _), _ = _twin(small, OVERFETCH, 3)
    _walks_down(tc)


def test_s_falls_under_sustained_overfetch_bf16(small):
    ctrl, _ = _port(small, OVERFETCH, 3)
    _walks_down(ctrl)


def test_capacity_guard_damps_raises_counter_for_counter(small):
    final = {}
    for guard in (True, False):
        (tc, te), _ = _twin(small, dict(capacity_guard=guard,
                                        overfetch_threshold=10 ** 9), 2)
        final[guard] = (tc.s, te.stats.demand_misses, tc.guard_hits)
    assert final[True][1] == final[False][1]      # identical miss workload
    assert final[True][0] < final[False][0]       # guard suppressed raises
    assert final[True][2] > 0 and final[False][2] == 0


def test_capacity_guard_damps_raises_bf16(small):
    final = {}
    for guard in (True, False):
        ctrl, sb = _port(small, dict(capacity_guard=guard,
                                     overfetch_threshold=10 ** 9), 2)
        final[guard] = (ctrl.s, sb.stats.demand_misses)
    assert final[True][1] == final[False][1]
    assert final[True][0] < final[False][0]


# ------------------------------------------------------------ prefetch off
@pytest.fixture(scope="module")
def smoke():
    """arch -> (port cfg, port params, JAX cfg, JAX model, JAX params), the
    smoke configs in float32."""
    out = {}
    for arch in ("olmoe-1b-7b", "deepseek-v2-lite"):
        jcfg = _f32(jax_smoke(arch))
        jm = JaxModel(jcfg)
        jp = jax.jit(jm.init)(jax.random.PRNGKey(0))
        out[arch] = (_f32(get_smoke_config(arch)),
                     params_from_reference(jax.tree.map(np.asarray, jp)),
                     jcfg, jm, jp)
    return out


@pytest.mark.parametrize("path", list(PATHS))
@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "deepseek-v2-lite"])
def test_prefetch_off_bitwise_oracle_and_counters_match_reference(
        smoke, arch, path):
    cfg, tparams, jcfg, jm, jp = smoke[arch]
    kw = dict(n_slots_per_layer=4, use_kernel=True,
              use_superkernel=PATHS[path], prefetch=False)
    te = SlotBufferEngine(cfg, tparams, Model(cfg), device="cpu", **kw)
    je = JaxSlotBufferEngine(jcfg, jp, jm, **kw)
    assert not te.prefetch_enabled
    assert [te._horizon(li) for li in range(len(te.moe_layer_ids))] == \
        [0] * len(te.moe_layer_ids)
    step_ref = (lambda t, s: sk_reference_decode_step(te, t, s)) \
        if PATHS[path] else te.reference_decode_step
    prompt = np.random.default_rng(11).integers(0, cfg.vocab_size, (2, 12))
    jl, js = je.prefill(jnp.asarray(prompt, jnp.int32))
    tl, ts = te.prefill(prompt)
    lr, sr = te.reference_prefill(prompt)
    assert torch.equal(tl, lr)
    for step in range(3):
        tok = np.asarray(jl).argmax(-1).astype(np.int32)
        jl, js = je.decode_step(jnp.asarray(tok), js)
        tl, ts = te.decode_step(tok, ts)
        lr, sr = step_ref(torch.from_numpy(tok).long(), sr)
        assert torch.equal(tl, lr), f"step {step}"
        a = [getattr(te.stats, k) for k in TWIN]
        w = [getattr(je.stats, k) for k in TWIN]
        assert a == w, (step, dict(zip(TWIN, a)), dict(zip(TWIN, w)))
    assert te.stats.prefetched == 0 and te.stats.spec_layers == 0
    assert te.stats.demand_misses > 0
    if not PATHS[path]:
        assert te.stats.replays == 0


def test_prefetch_off_forward_skips_the_pregate(small):
    cfg, tparams, _, _ = small["bfloat16"]
    calls = []
    for prefetch in (True, False):
        sb = SlotBufferEngine(cfg, tparams, Model(cfg), n_slots_per_layer=3,
                              max_seq=64, prefetch=prefetch, device="cpu")
        orig = sb._pre
        sb._pre = lambda *a, _o=orig: calls.append(a[-1] is not None) \
            or _o(*a)
        out = sb.forward(PROMPT)
        sb._pre = orig
        assert torch.equal(out, sb.reference_forward(PROMPT))
        if not prefetch:
            assert sb.stats.prefetched == 0
    half = len(calls) // 2
    assert any(calls[:half]) and not any(calls[half:])


# ------------------------------------------------------------ default knobs
def test_default_knobs_are_bitwise_the_engine_as_it_was(small):
    cfg, tparams, _, _ = small["bfloat16"]
    model = Model(cfg)
    kw = dict(n_slots_per_layer=3, max_seq=64, device="cpu")
    plain = SlotBufferEngine(cfg, tparams, model, **kw)
    explicit = SlotBufferEngine(cfg, tparams, model, prefetch=True,
                                link_bandwidth=LINK_BANDWIDTH,
                                controller=None, **kw)
    assert LINK_BANDWIDTH == 64e9
    for eng in (plain, explicit):
        assert eng.prefetch_enabled and eng.link.bandwidth == 64e9
        assert eng.controller.bandwidth_est == 64e9
        assert eng.controller.cfg.s_max == len(eng.moe_layer_ids) - 1
    rows = []
    for eng in (plain, explicit):
        logits, state = eng.prefill(PROMPT)
        out = [logits]
        for _ in range(6):
            logits, state = eng.decode_step(logits.argmax(-1), state)
            out.append(logits)
        rows.append(out)
    for k, (a, b) in enumerate(zip(*rows)):
        assert torch.equal(a, b), f"step {k}"
    # every count, not the measured times
    timed = {"copy_s", "copy_wait_s", "copy_wait_demand_s", "step_host_s",
             "pull_s", "launch_s", "residency_s"}
    sa = {k: v for k, v in plain.stats.snapshot().items() if k not in timed}
    sb = {k: v for k, v in explicit.stats.snapshot().items()
          if k not in timed}
    assert sa == sb
    assert plain.controller.s_history == explicit.controller.s_history


def test_callers_controller_is_used_as_given(small):
    cfg, tparams, _, _ = small["bfloat16"]
    ctrl = StepSizeController(cfg=StepSizeConfig(s_max=12), s=5)
    ctrl.bandwidth_est = 3e9
    eng = SlotBufferEngine(cfg, tparams, Model(cfg), n_slots_per_layer=3,
                           max_seq=64, controller=ctrl, link_bandwidth=2e9,
                           device="cpu")
    assert eng.controller is ctrl
    assert ctrl.cfg.s_max == 12 and ctrl.bandwidth_est == 3e9
    assert eng.link.bandwidth == 2e9
    # the horizon still clamps to what is left of the sweep
    L = len(eng.moe_layer_ids)
    assert eng._horizon(0) == min(5, L - 1)
