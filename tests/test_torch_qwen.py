"""The reference's Qwen MoE configs in the port against the reference (CPU).

- Configs: `qwen1.5-moe-a2.7b`, `qwen2-moe-57b` and `qwen3-moe-235b-a22b`
  (published and smoke) equal the reference's field for field, and the
  port's model accepts every layer of the published ones.
- Kernels at the shapes these models give them, the port's plain versions
  (what the wrappers run on a CPU tensor) against the reference's Pallas
  kernels in interpret mode on the same inputs: `fused_decode_attention`
  at GQA groups of 7 and 16 (and MHA) at head dim 128, `fused_moe_entry`
  at E = 60 top-4, 64 top-8 and 128 top-8 (d and f cut), also with no
  routed expert resident (an empty work list), and `slot_ffn` at E = 60.
  Tolerances as `tests/test_torch_decode_superkernel.py`: caches bitwise,
  ids equal, gates 1e-6, outputs 2e-2.
- Engine: each smoke config's prefill and 8 decode steps, fed the JAX
  engine's greedy tokens, each engine on its own caches, on the unfused and
  the superkernel path: logits within 5e-2 (bf16), the same greedy token
  unless the reference's top two lie within 5e-2, and the host decisions
  equal counter for counter. qwen3's smoke config alone starts each bf16
  step from the reference's caches; in f32 it decodes on its own caches
  within 1e-4 of the JAX engine. The smoke configs have G <= 2 and
  Hq D = d_model, so two more small configs carry the published attention
  shapes: qwen2's group of 7 and qwen3's group of 16 with qk-norm, each
  with Hq D != d_model.
- Inside the port: with 2 slots a layer of 8 experts (eviction churn and
  replays) the slot path is bitwise equal to its own fully-resident oracle
  on both decode paths, for each smoke config.
Inputs come from numpy seeds; the weights are the reference engine's,
carried bitwise through the bridge.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jax_registry
from repro.configs.base import reduce_config as jax_reduce_config
from repro.kernels import ops as jax_ops
from repro.runtime.engine import Engine as JaxEngine
from repro.runtime.engine import SlotBufferEngine as JaxSlotBufferEngine
from repro_torch.bridge import params_from_reference, to_tensor
from repro_torch.configs import get_config, get_smoke_config, reduce_config
from repro_torch.configs.registry import ARCH_IDS
from repro_torch.kernels import decode_superkernel as dsk
from repro_torch.kernels import slot_gather
from repro_torch.models.transformer import Model, all_specs
from repro_torch.runtime.engine import DecodeState, SlotBufferEngine
from test_torch_cuda import sk_reference_decode_step
from test_torch_decode_superkernel import _attn_inputs, _bf16, _moe_inputs

QWEN = ("qwen1.5-moe-a2.7b", "qwen2-moe-57b", "qwen3-moe-235b-a22b")
PATHS = {"unfused": False, "superkernel": True}
TOL = 5e-2
TOL_Y = 2e-2
TOL_GATES = 1e-6
COUNTERS = ("swap_calls", "swap_experts", "prefetched", "prefetch_hits",
            "late_hits", "demand_misses", "host_syncs", "steps",
            "spec_layers", "replays")
# the published attention shapes at a small width: (heads, kv heads,
# head_dim, qk_norm) over d_model 64, so Hq D != d_model
GROUPS = {"G7_qwen2": ("qwen2-moe-57b", 7, 1, 16),
          "G16_qwen3": ("qwen3-moe-235b-a22b", 16, 1, 8)}


# ------------------------------------------------------------------ configs
@pytest.mark.parametrize("arch", QWEN)
def test_configs_are_the_references(arch):
    assert arch in ARCH_IDS
    for mine, ref in ((get_config(arch), jax_registry.get_config(arch)),
                      (get_smoke_config(arch),
                       jax_registry.get_smoke_config(arch))):
        assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
        assert mine.resolved_head_dim == ref.resolved_head_dim
        assert mine.expert_bytes() == ref.expert_bytes()
    cfg = get_config(arch)
    specs = all_specs(cfg)
    assert len(specs) == cfg.num_layers and all(s.is_moe for s in specs)
    assert all(s.kind == "attn" and s.window == 0 for s in specs)


def test_published_shapes():
    """What each config puts in front of the kernels (PERF.md section 4)."""
    shape = {a: (get_config(a).num_heads // get_config(a).num_kv_heads,
                 get_config(a).resolved_head_dim, get_config(a).d_model,
                 get_config(a).moe.num_experts, get_config(a).moe.top_k,
                 get_config(a).moe.d_expert,
                 get_config(a).moe.num_shared_experts
                 * get_config(a).moe.d_shared) for a in QWEN}
    assert shape == {"qwen1.5-moe-a2.7b": (1, 128, 2048, 60, 4, 1408, 5632),
                     "qwen2-moe-57b": (7, 128, 3584, 64, 8, 2560, 20480),
                     "qwen3-moe-235b-a22b": (16, 128, 4096, 128, 8, 1536, 0)}
    assert get_config("qwen3-moe-235b-a22b").moe.router_norm_topk
    assert get_config("qwen3-moe-235b-a22b").qk_norm


# ------------------------------------------------------------------ kernels
ATTN = {                 # (lengths, S, Hq, Hkv, D)
    "G7_D128": ([0, 17, 31], 32, 28, 4, 128),
    "G16_D128": ([5, 31], 32, 64, 4, 128),
    "G1_D128": ([3, 40], 48, 16, 16, 128),
}


@pytest.mark.parametrize("case", list(ATTN))
def test_fused_decode_attention_plain_at_qwen_groups(case):
    q, kn, vn, kc, vc, clen = _attn_inputs(len(case), *ATTN[case])
    oj, kj, vj = jax_ops.fused_decode_attention(
        *(jnp.asarray(a) for a in (q, kn, vn, kc, vc)),
        jnp.asarray(clen, jnp.int32), interpret=True)
    o, k2, v2 = dsk.fused_decode_attention(
        *(to_tensor(a) for a in (q, kn, vn, kc, vc, clen)))
    np.testing.assert_array_equal(k2.view(torch.uint16).numpy(),
                                  np.asarray(kj).view(np.uint16))
    np.testing.assert_array_equal(v2.view(torch.uint16).numpy(),
                                  np.asarray(vj).view(np.uint16))
    np.testing.assert_allclose(o.float().numpy(),
                               np.asarray(oj).astype(np.float32),
                               rtol=TOL_Y, atol=TOL_Y)


MOE = {                  # (T, E, resident, k, d, f)
    "qwen15_E60_k4": (4, 60, 16, 4, 64, 96),
    "qwen2_E64_k8": (4, 64, 16, 8, 64, 160),
    "qwen3_E128_k8": (4, 128, 16, 8, 64, 96),
    "qwen3_E128_k8_all_resident": (4, 128, 128, 8, 32, 32),
    "E60_empty_work_list": (4, 60, 0, 4, 64, 96),
    "E128_empty_work_list": (4, 128, 0, 8, 64, 96),
}


@pytest.mark.parametrize("case", list(MOE))
def test_fused_moe_entry_plain_at_qwen_routing(case):
    T, E, S, k, d, f = MOE[case]
    args = _moe_inputs(T * E + k, T, E, max(S, 1), d, f)
    if S == 0:                            # nothing routed is resident
        args = args[:3] + (np.full(E, -1, np.int32),) + args[4:]
    x, rw, bias, soe, sg, su, sd = args
    yj, gj, ij = jax_ops.fused_moe_entry(
        *(jnp.asarray(a) for a in args), top_k=k, norm_topk=True,
        interpret=True)
    y, g, i = dsk.fused_moe_entry(*(to_tensor(a) for a in args), top_k=k,
                                  norm_topk=True)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ij))
    np.testing.assert_allclose(g.numpy(), np.asarray(gj), rtol=TOL_GATES,
                               atol=TOL_GATES)
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), rtol=TOL_Y,
                               atol=TOL_Y)
    assert (g.numpy()[soe[i.numpy()] < 0] == 0).all()
    if S == 0:
        assert not y.any() and not g.any()


@pytest.mark.parametrize("resident", [16, 0])
def test_slot_ffn_plain_at_qwen15_experts(resident):
    """E = 60 experts' dispatch buffers through 16 slots (or none: every
    row count 0), against the reference kernel over the rows that hold
    tokens."""
    from repro.kernels import slot_gather as jax_slot_gather
    rng = np.random.default_rng(60 + resident)
    E, C, D, F, S = 60, 4, 64, 96, 16
    x = _bf16(rng.standard_normal((E, C, D)))
    wg, wu = (_bf16(rng.standard_normal((S, D, F)) * D ** -0.5)
              for _ in range(2))
    wd = _bf16(rng.standard_normal((S, F, D)) * F ** -0.5)
    soe = np.full(E, -1, np.int32)
    soe[rng.permutation(E)[:resident]] = rng.permutation(S)[:resident]
    counts = np.where(soe >= 0, rng.integers(0, C + 1, E), 0).astype(np.int32)
    want = np.asarray(jax_slot_gather.slot_ffn(
        *(jnp.asarray(a) for a in (x, np.maximum(soe, 0), wg, wu, wd)),
        interpret=True))
    got = slot_gather.slot_ffn(*(to_tensor(a) for a in (
        x, np.maximum(soe, 0), wg, wu, wd)), counts=to_tensor(counts))
    live = np.arange(C)[None, :] < counts[:, None]
    np.testing.assert_allclose(got.numpy()[live], want[live], rtol=TOL_Y,
                               atol=TOL_Y)
    assert not got.numpy()[~live].any()


# ------------------------------------------------------------------- engine
def _group_cfgs(name):
    arch, H, Hkv, hd = GROUPS[name]
    kw = dict(layers=2, d_model=64, heads=H, kv_heads=Hkv, vocab=512,
              experts=8, top_k=2, d_expert=32)
    return (dataclasses.replace(reduce_config(get_config(arch), **kw),
                                head_dim=hd),
            dataclasses.replace(
                jax_reduce_config(jax_registry.get_config(arch), **kw),
                head_dim=hd))


@pytest.fixture(scope="module")
def models():
    """name -> (port config, port params, JAX config, JAX engine)."""
    out = {}
    for name in QWEN + tuple(GROUPS):
        if name in GROUPS:
            cfg, jcfg = _group_cfgs(name)
        else:
            cfg = get_smoke_config(name)
            jcfg = jax_registry.get_smoke_config(name)
        eng = JaxEngine(jcfg, max_seq=64)
        out[name] = (cfg, params_from_reference(
            jax.tree.map(np.asarray, eng.params)), jcfg, eng)
    return out


def test_group_configs_carry_the_published_attention(models):
    for name in GROUPS:
        cfg = models[name][0]
        G = cfg.num_heads // cfg.num_kv_heads
        assert G == {"G7_qwen2": 7, "G16_qwen3": 16}[name]
        assert cfg.num_heads * cfg.resolved_head_dim != cfg.d_model


def _near_tie_ok(tok, ref_row, where):
    want = int(np.argmax(ref_row))
    if int(tok) != want:
        top2 = np.sort(ref_row)[-2:]
        assert top2[1] - top2[0] <= TOL, (
            f"{where}: token {int(tok)} != reference {want}, top-2 gap "
            f"{top2[1] - top2[0]:.4f}")


def _bridge_state(js) -> DecodeState:
    """The JAX engine's single-stream decode state as the port's, its
    caches carried bitwise."""
    return DecodeState([{k: to_tensor(np.asarray(v)) for k, v in c.items()}
                        for c in js.caches],
                       torch.tensor(int(js.cache_len)), pos=int(js.pos))


def _against_jax(cfg, params, jcfg, jparams, jmodel, path, *, bridge, tol):
    """Prefill, then 8 decode steps fed the reference's greedy tokens, on
    the port's and the JAX `SlotBufferEngine`: logits within `tol` at every
    step, the same greedy token unless a near-tie, and the host decisions
    equal counter for counter. Each engine decodes on its own caches, or,
    with `bridge`, each step starts from the reference's caches."""
    kw = dict(n_slots_per_layer=4, use_kernel=True,
              use_superkernel=PATHS[path], max_seq=64)
    je = JaxSlotBufferEngine(jcfg, jparams, jmodel, **kw)
    te = SlotBufferEngine(cfg, params, Model(cfg), device="cpu", **kw)
    prompt = np.random.default_rng(11).integers(0, cfg.vocab_size, (1, 12))
    jl, js = je.prefill(jnp.asarray(prompt, jnp.int32))
    tl, ts = te.prefill(prompt)
    for step in range(9):
        jl_h = np.asarray(jl)
        np.testing.assert_allclose(tl.float().numpy(), jl_h, rtol=tol,
                                   atol=tol, err_msg=f"step {step}")
        _near_tie_ok(tl.argmax(-1)[0], jl_h[0], f"step {step}")
        if step == 8:
            break
        tok = jl_h.argmax(-1).astype(np.int32)    # the reference's tokens
        if bridge:
            ts = _bridge_state(js)                 # and its caches
        jl, js = je.decode_step(jnp.asarray(tok), js)
        tl, ts = te.decode_step(tok, ts)
    a, w = te.stats.snapshot(), je.stats.snapshot()
    assert [a[k] for k in COUNTERS] == [w[k] for k in COUNTERS], (a, w)
    assert te.controller.s_history == je.controller.s_history
    assert te.stats.swap_experts > 0 and te.stats.evictions > 0


# qwen3's smoke config, decoding on its own caches in bf16, passes 5e-2 by
# the 7th step: its normalised top-8 gates carry the routed experts with no
# shared expert to damp the one-ulp differences of the two frameworks' bf16
# GEMMs. So its bf16 run starts each step from the reference's caches, and
# the same config in f32 decodes on its own caches at TOL_F32.
BRIDGED = ("qwen3-moe-235b-a22b",)
TOL_F32 = 1e-4


@pytest.mark.parametrize("path", list(PATHS))
@pytest.mark.parametrize("name", QWEN + tuple(GROUPS))
def test_engine_matches_the_jax_engine(models, name, path):
    cfg, params, jcfg, jeng = models[name]
    _against_jax(cfg, params, jcfg, jeng.params, jeng.model, path,
                 bridge=name in BRIDGED, tol=TOL)


@pytest.mark.parametrize("path", list(PATHS))
def test_qwen3_smoke_in_f32_decodes_on_its_own_caches_as_the_jax_engine(path):
    """The witness for the bridge above: in f32 qwen3's smoke config, each
    engine decoding on its own caches fed the reference's tokens, stays
    within TOL_F32 of the JAX engine over prefill and 8 steps. The JAX
    side is its fully-resident oracle (`reference_prefill` /
    `reference_decode_step`, which its slot path matches bitwise): the JAX
    slot buffer holds bf16 whatever the model's dtype."""
    arch = "qwen3-moe-235b-a22b"
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    jcfg = dataclasses.replace(jax_registry.get_smoke_config(arch),
                               dtype="float32")
    jeng = JaxEngine(jcfg, max_seq=64)
    params = params_from_reference(jax.tree.map(np.asarray, jeng.params))
    kw = dict(n_slots_per_layer=4, use_kernel=True,
              use_superkernel=PATHS[path], max_seq=64)
    je = JaxSlotBufferEngine(jcfg, jeng.params, jeng.model, **kw)
    te = SlotBufferEngine(cfg, params, Model(cfg), device="cpu", **kw)
    assert te.buffer["w_gate"].dtype == torch.float32
    prompt = np.random.default_rng(11).integers(0, cfg.vocab_size, (1, 12))
    jl, js = je.reference_prefill(jnp.asarray(prompt, jnp.int32))
    tl, ts = te.prefill(prompt)
    for step in range(9):
        jl_h = np.asarray(jl)
        assert tl.dtype == torch.float32 and jl_h.dtype == np.float32
        np.testing.assert_allclose(tl.numpy(), jl_h, rtol=TOL_F32,
                                   atol=TOL_F32, err_msg=f"step {step}")
        if step == 8:
            break
        tok = jl_h.argmax(-1).astype(np.int32)
        jl, js = je.reference_decode_step(jnp.asarray(tok), js)
        tl, ts = te.decode_step(tok, ts)
    assert te.stats.swap_experts > 0 and te.stats.evictions > 0


@pytest.mark.parametrize("path", list(PATHS))
@pytest.mark.parametrize("name", QWEN + tuple(GROUPS))
def test_slot_path_bitwise_vs_own_oracle_under_churn(models, name, path):
    cfg, params = models[name][:2]
    te = SlotBufferEngine(cfg, params, Model(cfg), max_seq=64,
                          n_slots_per_layer=2, use_kernel=True,
                          use_superkernel=PATHS[path], step_size=1,
                          pregate_margin=0, device="cpu")
    oracle = sk_reference_decode_step if PATHS[path] else \
        (lambda e, t, s: e.reference_decode_step(t, s))
    rng = np.random.default_rng(5)
    for trial in range(2):
        prompt = rng.integers(0, cfg.vocab_size, (1, 2))
        lg, st = te.prefill(prompt)
        lr, sr = te.reference_prefill(prompt)
        assert torch.equal(lg, lr)
        tok = lr.argmax(-1)
        for step in range(8):
            lg, st = te.decode_step(tok, st)
            lr, sr = oracle(te, tok, sr)
            assert torch.equal(lg, lr), f"trial {trial} step {step}"
            for a, b in zip(st.caches, sr.caches):
                assert torch.equal(a["k"], b["k"]) and torch.equal(a["v"],
                                                                   b["v"])
            tok = lr.argmax(-1)
    assert te.stats.replays > 0 and te.stats.evictions > 0
