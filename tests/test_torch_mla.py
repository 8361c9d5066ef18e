"""The port's DeepSeek-V2-Lite slice against the reference (CPU): MLA
attention with its positional latent cache, shared experts and a dense
first layer, on a reduced config (4 layers: 1 dense + 3 MoE; d_model 64,
4 heads, MLA kv_lora 32 / nope 16 / rope 8 / v 16, 8 experts top-2 plus 2
shared). Inputs are made with numpy from a seed.

Tolerances:
- `fused_mla_decode_attention`: the port's wrapper on the CPU (its plain
  version) against the reference's Pallas kernel in interpret mode: new
  caches bitwise equal, ctx within 2e-4 (fp32 throughout; only the
  summation order differs; the reference's own tolerance for this kernel).
- fp32 attention pieces (`flash_attention` at MLA's widths): 1e-5.
- bf16 layer outputs, caches and logits across frameworks: 5e-2 (atol and
  rtol), as in the port's other tests: the two frameworks round the same
  bf16 products from differently ordered fp32 sums.
- Greedy tokens across frameworks agree unless the reference's top two
  logits lie within 5e-2 (a near-tie). Routing can part at a near-tie of
  router probabilities too; the prompts here are ones that meet none.
Inside the port, exactly: the unfused slot path equals its
`reference_decode_step` bitwise, the superkernel slot path equals the same
segment functions over every expert bitwise, and the kernel and einsum
branches of `mla_decode` write bitwise equal caches.
"""
import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import reduce_config as jax_reduce_config
from repro.configs.registry import get_config as jax_get_config
from repro.kernels import ops as jax_ops
from repro.models import attention as jax_attn
from repro.models import moe as jax_moe
from repro.models import transformer as jax_tf
from repro.runtime.engine import Engine as JaxEngine
from repro.runtime.engine import SlotBufferEngine as JaxSlotBufferEngine
from repro.runtime.engine import _layer_params
from repro_torch.bridge import params_from_reference, to_tensor
from repro_torch.configs import get_config, reduce_config
from repro_torch.kernels import decode_superkernel as dsk
from repro_torch.models import attention, moe as moe_mod, transformer
from repro_torch.models.transformer import Model
from repro_torch.runtime.engine import SlotBufferEngine
from repro_torch.runtime.request import Request
from repro_torch.runtime.serving import EngineServingConfig, ServingEngine
from test_torch_cuda import sk_reference_decode_step

TOL_CTX = 2e-4
TOL = 5e-2
SMALL = dict(layers=4, d_model=64, heads=4, kv_heads=4, d_ff=128, vocab=512,
             experts=8, top_k=2, d_expert=32)
CFG = reduce_config(get_config("deepseek-v2-lite"), **SMALL)
MAX_SEQ = 64


def _bf16(a):
    return np.asarray(jnp.asarray(a, jnp.bfloat16))


def _u16(t):
    return t.view(torch.uint16).numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t).view(np.uint16)


def _np(t):
    return t.float().numpy()


@pytest.fixture(scope="module")
def ref():
    """(reduced reference config, JAX engine holding its params, numpy
    tree of the params, port params)."""
    jcfg = jax_reduce_config(jax_get_config("deepseek-v2-lite"), **SMALL)
    eng = JaxEngine(jcfg, max_seq=MAX_SEQ)
    tree = jax.tree.map(np.asarray, eng.params)
    return jcfg, eng, tree, params_from_reference(tree)


def test_config_is_the_references():
    full, j = get_config("deepseek-v2-lite"), jax_get_config(
        "deepseek-v2-lite")
    assert dataclasses.asdict(full) == dataclasses.asdict(j)
    assert dataclasses.asdict(CFG) == dataclasses.asdict(
        jax_reduce_config(j, **SMALL))
    specs = transformer.all_specs(full)
    assert [s.is_moe for s in specs] == [False] + [True] * 26


# ---------------------------------------------------------------------------
# fused_mla_decode_attention
# ---------------------------------------------------------------------------

MLA_CASES = {
    # name: (cache lengths, S, H, R, P)
    "ragged_0_and_S-1": ([0, 7, 15], 16, 4, 32, 8),
    "two_chunks": ([200, 255, 0, 130], 256, 4, 32, 8),
    "deepseek_decode_shape": ([0, 63, 128, 255], 256, 16, 512, 64),
    # f32 c_new, pe_new, latent and pe, as the reference's own f32 test
    "f32_ragged_0_and_S-1": ([0, 5, 15], 16, 4, 32, 8),
    "f32_two_chunks": ([200, 255, 0, 130], 256, 4, 32, 8),
}
TOL_F32 = 2e-5      # the reference's f32 tolerance


def _mla_inputs(seed, clens, S, H, R, P):
    rng = np.random.default_rng(seed)
    B = len(clens)
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return (f32(B, H, R) * 0.3, f32(B, H, P) * 0.3,
            _bf16(rng.standard_normal((B, R))),
            _bf16(rng.standard_normal((B, P))),
            _bf16(rng.standard_normal((B, S, R))),
            _bf16(rng.standard_normal((B, S, P))),
            np.asarray(clens, np.int64))


@pytest.mark.parametrize("case", list(MLA_CASES))
def test_fused_mla_decode_attention_plain_matches_reference_kernel(case):
    clens, S, H, R, P = MLA_CASES[case]
    args = _mla_inputs(len(case), clens, S, H, R, P)
    f32 = case.startswith("f32")
    if f32:
        args = tuple(a.astype(np.float32) if a.dtype == _bf16(0).dtype
                     else a for a in args)
    scale = float(R + P) ** -0.5
    cj, lj, pj = jax_ops.fused_mla_decode_attention(
        *(jnp.asarray(a) for a in args[:6]), jnp.asarray(args[6], jnp.int32),
        scale=scale, interpret=True)
    t = [to_tensor(a) for a in args]
    before = dsk.fused_mla_decode_attention.launches
    ctx, lat, pe = dsk.fused_mla_decode_attention(*t, scale=scale)
    assert dsk.fused_mla_decode_attention.launches == before   # CPU: plain
    assert ctx.dtype == torch.float32
    assert lat.dtype == (torch.float32 if f32 else torch.bfloat16)
    if f32:
        np.testing.assert_array_equal(lat.numpy(), np.asarray(lj))
        np.testing.assert_array_equal(pe.numpy(), np.asarray(pj))
    else:
        np.testing.assert_array_equal(_u16(lat), _u16(lj))
        np.testing.assert_array_equal(_u16(pe), _u16(pj))
    tol = TOL_F32 if f32 else TOL_CTX
    np.testing.assert_allclose(ctx.numpy(), np.asarray(cj), rtol=tol,
                               atol=tol)
    # positional insert, and the input caches are left as they were
    for b, c in enumerate(clens):
        assert torch.equal(lat[b, c], t[2][b]) and torch.equal(pe[b, c],
                                                                t[3][b])
    assert torch.equal(t[4], to_tensor(args[4]))
    assert torch.equal(t[5], to_tensor(args[5]))


def test_fused_mla_decode_attention_takes_one_length_and_rejects_overflow():
    args = [to_tensor(a) for a in _mla_inputs(1, [9, 9, 9], 16, 4, 32, 8)]
    one = dsk.fused_mla_decode_attention(*args[:6], torch.tensor(9),
                                         scale=0.2)
    per_row = dsk.fused_mla_decode_attention(*args, scale=0.2)
    assert all(torch.equal(a, b) for a, b in zip(one, per_row))
    for bad in (torch.tensor(16), torch.tensor([3, 16, 0]),
                torch.tensor([3, -1, 0])):
        with pytest.raises(ValueError, match="does not fit"):
            dsk.fused_mla_decode_attention(*args[:6], bad, scale=0.2)
    with pytest.raises(ValueError):
        dsk.fused_mla_decode_attention(*(a.to("meta") for a in args[:6]),
                                       args[6], scale=0.2)


# ---------------------------------------------------------------------------
# MLA attention pieces and layers
# ---------------------------------------------------------------------------

def test_flash_attention_takes_mla_widths_and_scale():
    """The port's flash_attention scales by q's width ** -0.5 (MLA's
    (nope + rope) ** -0.5 when q is [q_nope | q_pe]) and takes v narrower
    than q and k."""
    m = CFG.mla
    D, Dv = m.qk_nope_head_dim + m.qk_rope_head_dim, m.v_head_dim
    rng = np.random.default_rng(3)
    q, k = (rng.standard_normal((2, 11, 4, D)).astype(np.float32)
            for _ in range(2))
    v = rng.standard_normal((2, 11, 4, Dv)).astype(np.float32)
    want = jax_attn.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), scale=D ** -0.5,
                                    q_chunk=4, kv_chunk=8)
    got = attention.flash_attention(*(torch.as_tensor(a) for a in (q, k, v)),
                                    q_chunk=4, kv_chunk=8)
    assert got.shape == (2, 11, 4, Dv)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.fixture(scope="module")
def mla_params():
    """Reduced MLA attention weights of the reference's init, and a copy."""
    p = jax_attn.init_mla_params(jax.random.PRNGKey(4), CFG.d_model,
                                 CFG.num_heads, CFG.mla)
    tree = jax.tree.map(np.asarray, p)
    return p, {k: to_tensor(v) for k, v in tree.items()}


def test_mla_attention_matches_reference(mla_params):
    pj, pt = mla_params
    rng = np.random.default_rng(6)
    x = _bf16(rng.standard_normal((2, 9, CFG.d_model)))
    pos = np.tile(np.arange(9), (2, 1)).astype(np.int32)
    kw = dict(mla=CFG.mla, rope_theta=CFG.rope_theta, norm_eps=CFG.norm_eps)
    want = jax_attn.mla_attention(pj, jnp.asarray(x),
                                  positions=jnp.asarray(pos), **kw)
    got = attention.mla_attention(pt, to_tensor(x),
                                  positions=torch.as_tensor(pos), **kw)
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("clens", [[5, 0, 15], [7]], ids=["per_row", "one"])
def test_mla_decode_branches_match_reference(mla_params, clens):
    pj, pt = mla_params
    m, S, B = CFG.mla, 16, 3
    rng = np.random.default_rng(len(clens))
    x = _bf16(rng.standard_normal((B, 1, CFG.d_model)))
    lat = _bf16(rng.standard_normal((B, S, m.kv_lora_rank)))
    pe = _bf16(rng.standard_normal((B, S, 1, m.qk_rope_head_dim)))
    clen = np.asarray(clens if len(clens) > 1 else clens[0], np.int64)
    kw = dict(mla=m, rope_theta=CFG.rope_theta, norm_eps=CFG.norm_eps)
    outs = {}
    for use_kernel in (False, True):
        oj, lj, ej = jax_attn.mla_decode(
            pj, jnp.asarray(x), jnp.asarray(lat), jnp.asarray(pe),
            jnp.asarray(clen, jnp.int32), use_kernel=use_kernel, **kw)
        ot, lt, et = attention.mla_decode(
            pt, to_tensor(x), to_tensor(lat), to_tensor(pe),
            torch.as_tensor(clen), use_kernel=use_kernel, **kw)
        assert lt.shape == lat.shape and et.shape == pe.shape
        for got, want in ((ot, oj), (lt, lj), (et, ej)):
            np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                                       rtol=TOL, atol=TOL)
        outs[use_kernel] = (ot, lt, et)
    # the two branches of the port: the same caches, bit for bit
    assert torch.equal(outs[False][1], outs[True][1])
    assert torch.equal(outs[False][2], outs[True][2])
    np.testing.assert_allclose(_np(outs[False][0]), _np(outs[True][0]),
                               rtol=1e-2, atol=1e-2)


def test_bridge_carries_the_deepseek_tree_bitwise(ref):
    jcfg, eng, tree, ported = ref
    assert len(ported["layers"]) == CFG.num_layers == 4
    assert "ffn" in ported["layers"][0] and "moe" not in ported["layers"][0]
    for i in range(1, 4):
        assert set(ported["layers"][i]["moe"]) == {"router", "w_gate", "w_up",
                                                   "w_down", "shared"}
    assert {"wq", "wkv_a", "kv_a_norm", "wkv_b", "wo"} == set(
        ported["layers"][0]["attn"])
    for i in range(CFG.num_layers):
        want = jax.tree.map(np.asarray, _layer_params(eng.model, eng.params,
                                                      i))
        for path, leaf in jax.tree_util.tree_leaves_with_path(want):
            t = ported["layers"][i]
            for k in path:
                t = t[k.key]
            assert t.dtype == to_tensor(leaf).dtype and t.shape == leaf.shape
            back = _u16(t) if leaf.dtype.name == "bfloat16" else t.numpy()
            np.testing.assert_array_equal(
                back, leaf.view(np.uint16) if leaf.dtype.name == "bfloat16"
                else leaf)


def _shapes(tree, prefix=()):
    """{key path: (shape, dtype name)} of a nested dict of arrays."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_shapes(v, prefix + (k,)))
        return out
    return {prefix: (tuple(tree.shape), str(tree.dtype).split(".")[-1])}


def test_port_init_has_the_references_tree(ref):
    """`Model.init` draws the same keys, shapes and dtypes as the
    reference's (the values differ: the frameworks' generators differ)."""
    _, eng, _, _ = ref
    tp = Model(CFG).init(torch.Generator().manual_seed(0), device="cpu")
    for i in range(CFG.num_layers):
        assert _shapes(tp["layers"][i]) == _shapes(
            _layer_params(eng.model, eng.params, i))


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("layer", [0, 1], ids=["dense", "moe_shared"])
def test_layer_prefill_and_decode_match_reference(ref, layer, use_kernel):
    jcfg, eng, tree, ported = ref
    spec_j = (jax_tf.build_layout(jcfg)[0] + jax_tf.build_layout(jcfg)[1])[
        layer]
    spec_t = transformer.all_specs(CFG)[layer]
    assert spec_t.is_moe == spec_j.is_moe == bool(layer)
    rng = np.random.default_rng(2 + layer)
    B, T, S = 2, 7, 16
    x = _bf16(rng.standard_normal((B, T, CFG.d_model)))
    pos = np.tile(np.arange(T), (B, 1)).astype(np.int32)
    pj = _layer_params(eng.model, eng.params, layer)
    pt = ported["layers"][layer]
    yj, cj = jax_tf.layer_prefill(pj, jcfg, spec_j, jnp.asarray(x),
                                  jnp.asarray(pos), S)
    yt, ct = transformer.layer_prefill(pt, CFG, spec_t, to_tensor(x),
                                       torch.as_tensor(pos), S)
    assert set(ct) == {"latent", "pe"}
    for got, want in ((yt, yj), (ct["latent"], cj["latent"]),
                      (ct["pe"], cj["pe"])):
        np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                                   rtol=TOL, atol=TOL)
    xd = _bf16(rng.standard_normal((B, 1, CFG.d_model)))
    clen = np.asarray([T, T - 2], np.int64)
    yj, cj2 = jax_tf.layer_decode(pj, jcfg, spec_j, jnp.asarray(xd), cj,
                                  jnp.asarray(clen, jnp.int32))
    ct_in = {k: v.clone() for k, v in ct.items()}
    yt, ct2 = transformer.layer_decode(pt, CFG, spec_t, to_tensor(xd), ct,
                                       torch.as_tensor(clen),
                                       use_kernel=use_kernel)
    for got, want in ((yt, yj), (ct2["latent"], cj2["latent"]),
                      (ct2["pe"], cj2["pe"])):
        np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                                   rtol=TOL, atol=TOL)
    for name in ("latent", "pe"):                # copy semantics
        assert torch.equal(ct[name], ct_in[name])


@pytest.mark.parametrize("fn", ["reference", "slotbuf_einsum",
                                "slotbuf_kernel", "slotbuf_fused"])
def test_shared_experts_match_reference(ref, fn):
    jcfg, eng, tree, ported = ref
    pj = _layer_params(eng.model, eng.params, 1)["moe"]
    pt = ported["layers"][1]["moe"]
    m = CFG.moe
    x = _bf16(np.random.default_rng(9).standard_normal((6, CFG.d_model)))
    ident_j = jnp.arange(m.num_experts, dtype=jnp.int32)
    ident_t = torch.arange(m.num_experts, dtype=torch.int32)
    wj = {k: pj[k] for k in ("w_gate", "w_up", "w_down")}
    wt = {k: pt[k] for k in ("w_gate", "w_up", "w_down")}
    if fn == "reference":
        oj, _ = jax_moe.moe_reference(pj, jnp.asarray(x), m)
        ot, _ = moe_mod.moe_reference(pt, to_tensor(x), m)
    elif fn == "slotbuf_fused":
        oj, _, _ = jax_moe.moe_slotbuf_fused(pj, wj, ident_j, jnp.asarray(x),
                                             m, interpret=True)
        ot, _, _ = moe_mod.moe_slotbuf_fused(pt, wt, ident_t, to_tensor(x), m)
    else:
        uk = fn == "slotbuf_kernel"
        oj, _ = jax_moe.moe_slotbuf(pj, wj, ident_j, jnp.asarray(x), m,
                                    capacity=12, use_kernel=uk)
        ot, _ = moe_mod.moe_slotbuf(pt, wt, ident_t, to_tensor(x), m,
                                    capacity=12, use_kernel=uk)
    np.testing.assert_allclose(_np(ot), np.asarray(oj, np.float32),
                               rtol=TOL, atol=TOL)
    # the shared experts' term is there: the routed part alone is not it
    shared = pt["shared"]
    alone = ot.float() - moe_mod.swiglu(to_tensor(x), shared["w_gate"],
                                        shared["w_up"],
                                        shared["w_down"]).float()
    assert (alone - ot.float()).abs().max() > 10 * TOL


def _near_tie_ok(tok, ref_row, where):
    want = int(np.argmax(ref_row))
    if int(tok) != want:
        top2 = np.sort(ref_row)[-2:]
        assert top2[1] - top2[0] <= TOL, (
            f"{where}: token {int(tok)} != reference {want}, top-2 gap "
            f"{top2[1] - top2[0]:.4f}")
        return False
    return True


@pytest.mark.parametrize("use_kernel", [False, True])
def test_model_prefill_and_decode_logits_match_reference(ref, use_kernel):
    """The port's layer stack (the functions the engine runs) against the
    reference's `Model.prefill` / `Model.decode_step`, teacher-forced on
    the reference's greedy tokens."""
    jcfg, eng, tree, ported = ref
    jm, jp = eng.model, eng.params
    model = Model(CFG)
    specs = transformer.all_specs(CFG)
    prompt = np.random.default_rng(11).integers(0, CFG.vocab_size, (2, 9))
    jl, jc = jm.prefill(jp, jnp.asarray(prompt, jnp.int32), max_seq=MAX_SEQ)
    toks = torch.as_tensor(prompt)
    x = model.embed(ported, toks)
    pos = torch.arange(9)[None].expand(2, 9)
    caches = []
    for p, s in zip(ported["layers"], specs):
        x, c = transformer.layer_prefill(p, CFG, s, x, pos, MAX_SEQ)
        caches.append(c)
    tl = model.logits(ported, x[:, -1])
    clen = torch.tensor(9)
    for step in range(5):
        jl_h = np.asarray(jl)
        np.testing.assert_allclose(tl.numpy(), jl_h, rtol=TOL, atol=TOL,
                                   err_msg=f"step {step}")
        for b in range(2):
            _near_tie_ok(tl.argmax(-1)[b], jl_h[b], f"step {step} row {b}")
        tok = jl_h.argmax(-1).astype(np.int32)
        jl, jc = jm.decode_step(jp, jnp.asarray(tok), jc)
        x = model.embed(ported,
                        torch.as_tensor(tok, dtype=torch.long)[:, None])
        for i, (p, s) in enumerate(zip(ported["layers"], specs)):
            x, caches[i] = transformer.layer_decode(p, CFG, s, x, caches[i],
                                                    clen,
                                                    use_kernel=use_kernel)
        tl = model.logits(ported, x[:, -1])
        clen = clen + 1


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------

KEYS = ("swap_calls", "swap_experts", "prefetched", "prefetch_hits",
        "late_hits", "demand_misses", "host_syncs", "steps", "spec_layers",
        "replays", "dispatches")


def test_unfused_engine_matches_reference_engine_counter_for_counter(ref):
    jcfg, jeng, _, tparams = ref
    je = JaxSlotBufferEngine(jcfg, jeng.params, jeng.model, max_seq=MAX_SEQ,
                             n_slots_per_layer=3, use_kernel=True)
    te = SlotBufferEngine(CFG, tparams, Model(CFG), max_seq=MAX_SEQ,
                          n_slots_per_layer=3, use_kernel=True, device="cpu")
    # the slot buffer and host store take DeepSeek's expert shapes as they are
    n = 3 * 3
    assert tuple(te.buffer["w_gate"].shape) == (n, CFG.d_model, 32)
    assert tuple(te.buffer["w_down"].shape) == (n, 32, CFG.d_model)
    assert [tuple(w.shape) for w in te.store.layer(2)] == [
        (8, CFG.d_model, 32), (8, CFG.d_model, 32), (8, 32, CFG.d_model)]
    assert te.moe_layer_ids == [1, 2, 3]
    prompt = np.random.default_rng(2).integers(0, CFG.vocab_size, (2, 10))
    jl, js = je.prefill(jnp.asarray(prompt, jnp.int32))
    tl, ts = te.prefill(prompt)
    for step in range(9):
        jl_h = np.asarray(jl)
        np.testing.assert_allclose(tl.numpy(), jl_h, rtol=TOL, atol=TOL,
                                   err_msg=f"step {step}")
        for b in range(2):
            _near_tie_ok(tl.argmax(-1)[b], jl_h[b], f"step {step} row {b}")
        a, w = te.stats.snapshot(), je.stats.snapshot()
        w["dispatches"] = w["jit_calls"]
        assert [a[k] for k in KEYS] == [w[k] for k in KEYS], (step, a, w)
        assert te.controller.s_history == je.controller.s_history
        if step == 8:
            break
        tok = jl_h.argmax(-1).astype(np.int32)
        jl, js = je.decode_step(jnp.asarray(tok), js)
        tl, ts = te.decode_step(tok, ts)
    assert te.stats.replays > 0 and te.stats.evictions > 0


@pytest.mark.parametrize("superkernel", [False, True],
                         ids=["unfused", "superkernel"])
def test_slot_path_bitwise_vs_own_oracle_under_churn(ref, superkernel):
    _, _, _, tparams = ref
    te = SlotBufferEngine(CFG, tparams, Model(CFG), max_seq=MAX_SEQ,
                          n_slots_per_layer=3, use_kernel=True,
                          use_superkernel=superkernel, step_size=1,
                          pregate_margin=0, device="cpu")
    oracle = sk_reference_decode_step if superkernel else \
        (lambda e, t, s: e.reference_decode_step(t, s))
    rng = np.random.default_rng(5)
    for trial in range(2):
        prompt = rng.integers(0, CFG.vocab_size, (2, 8))
        lg, st = te.prefill(prompt)
        lr, sr = te.reference_prefill(prompt)
        assert torch.equal(lg, lr)
        tok = lr.argmax(-1)
        for step in range(8):
            lg, st = te.decode_step(tok, st)
            lr, sr = oracle(te, tok, sr)
            assert torch.equal(lg, lr), f"trial {trial} step {step}"
            for a, b in zip(st.caches, sr.caches):
                assert torch.equal(a["latent"], b["latent"])
                assert torch.equal(a["pe"], b["pe"])
            tok = lr.argmax(-1)
    assert te.stats.replays > 0 and te.stats.evictions > 0


def test_forward_bitwise_vs_reference_forward(ref):
    _, _, _, tparams = ref
    te = SlotBufferEngine(CFG, tparams, Model(CFG), n_slots_per_layer=3,
                          use_kernel=True, device="cpu")
    toks = np.random.default_rng(7).integers(0, CFG.vocab_size, (2, 7))
    assert torch.equal(te.forward(toks), te.reference_forward(toks))
    assert te.stats.evictions > 0


def test_superkernel_tracks_unfused_path_with_half_the_dispatches(ref):
    _, _, _, tparams = ref
    model = Model(CFG)
    kw = dict(max_seq=MAX_SEQ, n_slots_per_layer=6, step_size=2,
              device="cpu")
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
    sk = SlotBufferEngine(CFG, tparams, model, use_superkernel=True, **kw)
    base.stats.reset()
    d_base = d_sk = 0
    for _ in range(3):
        lo_b, st_b = base.decode_step(toks, copy.deepcopy(state))
        n0 = sk.stats.dispatches
        lo_s, st_s = sk.decode_step(toks, copy.deepcopy(state))
        d_sk += sk.stats.dispatches - n0
        assert torch.equal(st_s.cache_len, st_b.cache_len)
        np.testing.assert_allclose(lo_s.numpy(), lo_b.numpy(), rtol=TOL,
                                   atol=TOL)
        assert torch.equal(lo_s.argmax(-1), lo_b.argmax(-1))
        state, toks = st_b, lo_b.argmax(-1).numpy()
    d_base = base.stats.dispatches
    assert d_base / d_sk >= 2.0, (d_base, d_sk)


def _reference_greedy(je, prompt, n_new):
    logits, st = je.reference_prefill(jnp.asarray(prompt[None], jnp.int32))
    toks, rows = [], []
    for step in range(n_new):
        row = np.asarray(logits)[0]
        toks.append(int(row.argmax()))
        rows.append(row)
        if step < n_new - 1:
            logits, st = je.reference_decode_step(
                jnp.asarray([toks[-1]], jnp.int32), st)
    return toks, rows


@pytest.mark.parametrize("superkernel", [False, True],
                         ids=["unfused", "superkernel"])
def test_serving_rows_match_single_request_reference(ref, superkernel):
    """Four greedy requests of ragged lengths served at batch 2 (eviction
    churn, admission into freed rows) each give the reference engine's
    single-request tokens, up to a near-tie."""
    jcfg, jeng, _, tparams = ref
    je = JaxSlotBufferEngine(jcfg, jeng.params, jeng.model, max_seq=MAX_SEQ,
                             n_slots_per_layer=4, use_kernel=True)
    te = SlotBufferEngine(CFG, tparams, Model(CFG), max_seq=MAX_SEQ,
                          n_slots_per_layer=4, use_kernel=True,
                          use_superkernel=superkernel, device="cpu")
    # prompts whose routing meets no near-tie (with the seed 2 draw, one
    # request's layer-1 router has its 2nd and 3rd experts 1.1e-3 apart in
    # probability at a decode step, and the frameworks pick differently)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, CFG.vocab_size, n) for n in (8, 5, 11, 7)]
    reqs = [Request(p, max_new_tokens=6) for p in prompts]
    ServingEngine(te, EngineServingConfig(max_batch=2)).serve(reqs)
    assert te.stats.swap_experts > 0 and te.stats.evictions > 0
    for req, prompt in zip(reqs, prompts):
        assert len(req.output) == 6
        want, rows = _reference_greedy(je, prompt, 6)
        for step, (got_t, want_t) in enumerate(zip(req.output, want)):
            if not _near_tie_ok(got_t, rows[step],
                                f"request {req.request_id} step {step}"):
                break
