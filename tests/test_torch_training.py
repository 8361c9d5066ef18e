"""Training on the port against the reference, on the CPU at smoke sizes:
the chunked cross-entropy and the load-balancing loss (f32, 1e-6), AdamW
(three steps with clipping, 1e-6), the f32 loss value and every gradient
against `jax.value_and_grad` (1e-4) on olmoe, yi, recurrentgemma and xlstm
smoke (autograd through the recurrent mixers' time loops) and on whisper
smoke with a batch of frames, train steps that descend (xlstm too, as the
reference's test), the data pipeline bitwise, and int8 gradient
compression."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_smoke_config as jax_smoke
from repro.data import pipeline as jax_pipe
from repro.distributed import compression as jax_comp
from repro.models import moe as jax_moe
from repro.models import transformer as jax_tf
from repro.training import loss as jax_loss
from repro.training import optimizer as jax_opt
from repro.training import steps as jax_steps
from repro_torch.bridge import params_from_reference, unstack_layers
from repro_torch.configs import get_smoke_config
from repro_torch.data import pipeline
from repro_torch.distributed import compression
from repro_torch.models import Model, moe
from repro_torch.training import loss, optimizer, steps
from repro_torch.tree import leaves_with_paths, tree_leaves, tree_map


def _t(a):
    return torch.as_tensor(np.asarray(a))


@pytest.mark.parametrize("case", [
    dict(T=16, chunk=2048, cap=0.0), dict(T=13, chunk=8, cap=0.0),
    dict(T=13, chunk=8, cap=30.0), dict(T=16, chunk=5, cap=5.0)],
    ids=["one_chunk", "padded_tail", "softcap", "small_cap"])
def test_chunked_cross_entropy_matches_reference(case):
    rng = np.random.default_rng(0)
    B, T, d, V = 2, case["T"], 16, 50
    h = rng.standard_normal((B, T, d)).astype(np.float32)
    w = rng.standard_normal((d, V)).astype(np.float32)
    labels = rng.integers(0, V, (B, T))
    labels[0, :3] = -100                     # ignored positions
    want = jax_loss.chunked_cross_entropy(
        jnp.asarray(h), jnp.asarray(w), jnp.asarray(labels),
        chunk=case["chunk"], logit_softcap=case["cap"])
    got = loss.chunked_cross_entropy(_t(h), _t(w), _t(labels),
                                     chunk=case["chunk"],
                                     logit_softcap=case["cap"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_chunked_cross_entropy_all_ignored_is_zero():
    h = torch.ones((1, 4, 8))
    w = torch.ones((8, 10))
    assert float(loss.chunked_cross_entropy(
        h, w, torch.full((1, 4), -100))) == 0.0


@pytest.mark.parametrize("T,E,k", [(32, 8, 2), (7, 64, 8)])
def test_load_balancing_loss_matches_reference(T, E, k):
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((T, E)).astype(np.float32)
    probs = np.asarray(jax.nn.softmax(jnp.asarray(logits), -1))
    ids = np.argsort(-probs, -1)[:, :k].astype(np.int32)
    want = jax_moe.load_balancing_loss(jnp.asarray(probs), jnp.asarray(ids),
                                       E)
    got = moe.load_balancing_loss(_t(probs), _t(ids), E)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("clip,wd", [(1.0, 0.0), (0.05, 0.1), (0.0, 0.0)],
                         ids=["clip1", "clip_small_decay", "no_clip"])
def test_adamw_three_steps_match_reference(clip, wd):
    rng = np.random.default_rng(2)
    shapes = {"a": (4, 3), "b": [(5,), (2, 2)]}
    params = {"a": rng.standard_normal(shapes["a"]).astype(np.float32),
              "b": [rng.standard_normal(s).astype(np.float32)
                    for s in shapes["b"]]}
    jp = jax.tree.map(jnp.asarray, params)
    tp = tree_map(_t, params)
    js, ts = jax_opt.adamw_init(jp), optimizer.adamw_init(tp)
    for i in range(3):
        g = jax.tree.map(lambda p: rng.standard_normal(p.shape).astype(
            np.float32) * (i + 1), params)
        jp, js = jax_opt.adamw_update(jax.tree.map(jnp.asarray, g), js, jp,
                                      lr=1e-2, weight_decay=wd,
                                      grad_clip=clip)
        tp, ts = optimizer.adamw_update(tree_map(_t, g), ts, tp, lr=1e-2,
                                        weight_decay=wd, grad_clip=clip)
    assert int(ts.step) == int(js.step) == 3
    for got, want in zip(tree_leaves((tp, ts.m, ts.v)),
                         jax.tree.leaves((jp, js.m, js.v))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)


def test_adamw_keeps_bf16_params_in_their_dtype():
    p = {"w": torch.randn(8, 8).bfloat16()}
    st = optimizer.adamw_init(p)
    p2, st2 = optimizer.adamw_update({"w": torch.randn(8, 8).bfloat16()},
                                     st, p, lr=1e-2)
    assert p2["w"].dtype == torch.bfloat16
    assert st2.m["w"].dtype == torch.float32
    assert not torch.equal(p2["w"], p["w"])
    assert int(st.step) == 0                 # the input state is untouched


# ---------------------------------------------------------------------------
# loss and gradients of whole models against jax.value_and_grad (f32)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=["olmoe-1b-7b", "yi-9b",
                                        "recurrentgemma-2b", "xlstm-1.3b",
                                        "whisper-large-v3"])
def grads_run(request):
    """The reference's f32 loss and gradients on one batch; whisper's
    batch adds 24 frames made from a seed (its loss encodes them)."""
    arch = request.param
    jcfg = dataclasses.replace(jax_smoke(arch), dtype="float32")
    tcfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    jm = jax_tf.Model(jcfg)
    params = jax.jit(jm.init)(jax.random.PRNGKey(4))
    toks, labels = next(jax_pipe.token_batches(jcfg.vocab_size, 2, 16))
    batch = {"tokens": toks, "labels": labels}
    if jcfg.is_encoder_decoder:
        batch["frames"] = np.random.default_rng(5).standard_normal(
            (2, 24, jcfg.d_model)).astype(np.float32)
    lf = jax_steps.make_loss_fn(jm, remat=False, ce_chunk=8)
    lv, g = jax.jit(jax.value_and_grad(lf))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    tree = jax.tree.map(np.asarray, params)
    return (arch, tcfg, params_from_reference(tree), float(lv),
            jax.tree.map(np.asarray, g), batch)


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_loss_and_every_gradient_match_reference(grads_run, remat):
    arch, cfg, ported, want_loss, want_g, batch = grads_run
    m = Model(cfg)
    vg = steps.value_and_grad(steps.make_loss_fn(m, remat=remat,
                                                 ce_chunk=8))
    got_loss, got_g = vg(ported, {k: _t(v) if k == "frames" else
                                  _t(v).long() for k, v in batch.items()})
    np.testing.assert_allclose(float(got_loss), want_loss, rtol=1e-4,
                               atol=1e-4)
    flat_want = {k: _t(want_g[k]) for k in ("embed", "final_norm", "lm_head")
                 if k in want_g}
    flat_want["layers"] = [tree_map(_t, p) for p in unstack_layers(want_g)]
    if "encoder" in want_g:
        enc = want_g["encoder"]
        flat_want["encoder"] = {
            "final_norm": _t(enc["final_norm"]),
            "layers": [tree_map(lambda a, i=i: _t(a[i]), enc["layers"])
                       for i in range(cfg.encoder_layers)]}
    want = dict(leaves_with_paths(flat_want))
    got = dict(leaves_with_paths(got_g))
    assert set(got) == set(want)
    for key, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[key].numpy(), rtol=1e-4,
                                   atol=1e-4, err_msg=key)


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "yi-9b", "xlstm-1.3b"])
def test_train_steps_descend(arch):
    """The reference test's contract on the port: 5 steps memorising one
    batch must lower the loss."""
    cfg = get_smoke_config(arch)
    m = Model(cfg)
    params, opt = steps.init_train_state(m, torch.Generator().manual_seed(2),
                                         device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 16),
                         generator=torch.Generator().manual_seed(3))
    step = steps.make_train_step(m, lr=1e-3, remat=False, ce_chunk=64)
    losses = []
    for _ in range(5):
        params, opt, met = step(params, opt, {"tokens": toks,
                                              "labels": toks})
        losses.append(float(met["loss"]))
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0], losses


def test_prefill_and_serve_steps_match_the_model():
    cfg = get_smoke_config("gemma2-9b")
    m = Model(cfg)
    params = m.init(torch.Generator().manual_seed(5), device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 6))
    lp, cache = steps.make_prefill_step(m, 12)(params, {"tokens": toks})
    lp2, _ = m.prefill(params, toks, max_seq=12)
    assert torch.equal(lp, lp2)
    ld, c2 = steps.make_serve_step(m)(params, lp.argmax(-1), cache)
    assert ld.shape == (2, cfg.vocab_size) and int(c2["len"]) == 7


# ---------------------------------------------------------------------------
# data and compression
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 3])
def test_token_batches_bitwise(seed):
    a = pipeline.token_batches(512, 3, 20, seed=seed)
    b = jax_pipe.token_batches(512, 3, 20, seed=seed)
    for _ in range(3):
        (t1, l1), (t2, l2) = next(a), next(b)
        assert np.array_equal(t1, t2) and np.array_equal(l1, l2)
        assert t1.dtype == t2.dtype


def test_sharegpt_like_and_batch_requests_bitwise():
    kw = dict(seed=5, vocab_size=256, per_group=3, length_groups=(8, 16),
              topic_mix=0.3)
    mine, ref = pipeline.sharegpt_like(**kw), jax_pipe.sharegpt_like(**kw)
    assert len(mine) == len(ref)
    for r1, r2 in zip(mine, ref):
        assert np.array_equal(r1.tokens, r2.tokens)
        assert (r1.topic, r1.group_len) == (r2.topic, r2.group_len)
    for got, want in zip(pipeline.batch_requests(mine, 4),
                         jax_pipe.batch_requests(ref, 4)):
        assert np.array_equal(got, want) and got.dtype == want.dtype


def test_compression_matches_reference():
    rng = np.random.default_rng(6)
    g = {"w": rng.standard_normal((6, 5)).astype(np.float32),
         "b": [rng.standard_normal(7).astype(np.float32) * 1e-3]}
    e = jax.tree.map(lambda a: (rng.standard_normal(a.shape) * 1e-3).astype(
        np.float32), g)
    jg, je = jax_comp.compress_with_feedback(jax.tree.map(jnp.asarray, g),
                                             jax.tree.map(jnp.asarray, e))
    tg, te = compression.compress_with_feedback(tree_map(_t, g),
                                                tree_map(_t, e))
    for got, want in zip(tree_leaves((tg, te)), jax.tree.leaves((jg, je))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-7)
    q, s = compression.quantize_int8(_t(g["w"]))
    qj, sj = jax_comp.quantize_int8(jnp.asarray(g["w"]))
    assert np.array_equal(q.numpy(), np.asarray(qj))
    zero = compression.init_error_state(tree_map(_t, g))
    assert all(float(z.abs().sum()) == 0 for z in tree_leaves(zero))


def test_prefill_step_encodes_the_frames():
    """`make_prefill_step` on whisper: the batch's frames go through
    `encode` into the cross K/V, as `Model.prefill(enc_out=)` takes them."""
    cfg = get_smoke_config("whisper-large-v3")
    m = Model(cfg)
    params = m.init(torch.Generator().manual_seed(6), device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 6))
    frames = torch.randn((2, 10, cfg.d_model)).to(m.dtype)
    lp, cache = steps.make_prefill_step(m, 12)(
        params, {"tokens": toks, "frames": frames})
    with torch.no_grad():
        lp2, c2 = m.prefill(params, toks, max_seq=12,
                            enc_out=m.encode(params, frames))
    assert torch.equal(lp, lp2)
    assert torch.equal(cache["layers"][0]["xk"], c2["layers"][0]["xk"])
    assert cache["layers"][0]["xk"].shape[1] == 10
