"""The port's model layers and parameter bridge against the reference, on
the olmoe smoke config. The bridge is bitwise; layer outputs are bf16 and
held to 5e-2."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_smoke_config as jax_smoke
from repro.models import attention as jax_attn
from repro.models import layers as jax_layers
from repro.models import transformer as jax_tf
from repro.runtime.engine import _layer_params
from repro_torch.bridge import params_from_reference, to_tensor
from repro_torch.configs import get_smoke_config
from repro_torch.models import attention, layers, transformer

CFG = get_smoke_config("olmoe-1b-7b")
TOL = 5e-2


@pytest.fixture(scope="module")
def ref():
    """(JAX model, JAX params, numpy tree, port params)."""
    cfg = jax_smoke("olmoe-1b-7b")
    model = jax_tf.Model(cfg)
    params = jax.jit(model.init)(jax.random.PRNGKey(3))
    tree = jax.tree.map(np.asarray, params)
    return model, params, tree, params_from_reference(tree)


def _np(t):
    return t.float().numpy()


def test_bridge_round_trip_is_bitwise(ref):
    model, params, tree, ported = ref
    assert len(ported["layers"]) == CFG.num_layers
    for name in ("embed", "lm_head", "final_norm"):
        back = ported[name].view(torch.int16).numpy().view(tree[name].dtype) \
            if tree[name].dtype.name == "bfloat16" else ported[name].numpy()
        np.testing.assert_array_equal(back, tree[name])
    for i in range(CFG.num_layers):
        want = jax.tree.map(np.asarray, _layer_params(model, params, i))
        got = ported["layers"][i]
        flat_w = jax.tree_util.tree_leaves_with_path(want)
        for path, leaf in flat_w:
            t = got
            for k in path:
                t = t[k.key]
            back = t.view(torch.int16).numpy().view(leaf.dtype) \
                if leaf.dtype.name == "bfloat16" else t.numpy()
            assert back.dtype == leaf.dtype and back.shape == leaf.shape
            np.testing.assert_array_equal(back, leaf)


def test_layer_primitives_match_reference():
    rng = np.random.default_rng(0)
    x = np.asarray(jnp.asarray(rng.standard_normal((2, 5, 4, 16)),
                               jnp.bfloat16))
    scale = np.asarray(jnp.asarray(rng.standard_normal(16), jnp.bfloat16))
    pos = np.tile(np.arange(5), (2, 1)).astype(np.int32)
    np.testing.assert_allclose(
        _np(layers.rms_norm(to_tensor(x), to_tensor(scale))),
        np.asarray(jax_layers.rms_norm(jnp.asarray(x), jnp.asarray(scale)),
                   np.float32), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(
        _np(layers.rope(to_tensor(x), torch.as_tensor(pos), 10000.0)),
        np.asarray(jax_layers.rope(jnp.asarray(x), jnp.asarray(pos), 10000.0),
                   np.float32), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("T,q_chunk,kv_chunk", [(9, 512, 1024), (13, 4, 8)])
def test_flash_and_decode_attention_match_reference(T, q_chunk, kv_chunk):
    rng = np.random.default_rng(1)
    q, k, v = (rng.standard_normal((2, T, 4, 16)).astype(np.float32)
               for _ in range(3))
    want = jax_attn.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), q_chunk=q_chunk,
                                    kv_chunk=kv_chunk)
    got = attention.flash_attention(*(torch.as_tensor(a) for a in (q, k, v)),
                                    q_chunk=q_chunk, kv_chunk=kv_chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    clen = np.asarray([T, T - 3], np.int32)
    want_d = jax_attn.decode_attention(jnp.asarray(q[:, :1]), jnp.asarray(k),
                                       jnp.asarray(v), jnp.asarray(clen))
    got_d = attention.decode_attention(torch.as_tensor(q[:, :1]),
                                       torch.as_tensor(k), torch.as_tensor(v),
                                       torch.as_tensor(clen))
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), rtol=1e-5,
                               atol=1e-5)


def test_layer_prefill_and_decode_match_reference(ref):
    model, params, tree, ported = ref
    cfg = model.cfg
    spec_j = jax_tf.build_layout(cfg)[1][0]
    spec_t = transformer.all_specs(CFG)[0]
    rng = np.random.default_rng(2)
    B, T, max_seq = 2, 7, 16
    x = np.asarray(jnp.asarray(rng.standard_normal((B, T, cfg.d_model)),
                               jnp.bfloat16))
    pos = np.tile(np.arange(T), (B, 1)).astype(np.int32)
    pj = _layer_params(model, params, 0)
    pt = ported["layers"][0]
    yj, cj = jax.jit(lambda p, a, b: jax_tf.layer_prefill(
        p, cfg, spec_j, a, b, max_seq))(pj, jnp.asarray(x), jnp.asarray(pos))
    yt, ct = transformer.layer_prefill(pt, CFG, spec_t, to_tensor(x),
                                       torch.as_tensor(pos), max_seq)
    np.testing.assert_allclose(_np(yt), np.asarray(yj, np.float32),
                               rtol=TOL, atol=TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(_np(ct[name]),
                                   np.asarray(cj[name], np.float32),
                                   rtol=TOL, atol=TOL)
    # one decode step per row at its own position (per-row ring insert)
    xd = np.asarray(jnp.asarray(rng.standard_normal((B, 1, cfg.d_model)),
                                jnp.bfloat16))
    clen = np.asarray([T, T - 2], np.int32)
    yj, cj2 = jax.jit(lambda p, a, c, n: jax_tf.layer_decode(
        p, cfg, spec_j, a, c, n))(pj, jnp.asarray(xd), cj, jnp.asarray(clen))
    ct_in = {k: v.clone() for k, v in ct.items()}
    yt, ct2 = transformer.layer_decode(pt, CFG, spec_t, to_tensor(xd), ct,
                                       torch.as_tensor(clen, dtype=torch.long))
    np.testing.assert_allclose(_np(yt), np.asarray(yj, np.float32),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(_np(ct2["k"]), np.asarray(cj2["k"], np.float32),
                               rtol=TOL, atol=TOL)
    # copy semantics: the input cache is untouched
    for name in ("k", "v"):
        assert torch.equal(ct[name], ct_in[name])


def test_embed_and_logits_match_reference(ref):
    model, params, tree, ported = ref
    tm = transformer.Model(CFG)
    toks = np.random.default_rng(5).integers(0, CFG.vocab_size, (2, 6))
    xj = model.embed(params, jnp.asarray(toks))
    xt = tm.embed(ported, torch.as_tensor(toks))
    np.testing.assert_array_equal(_np(xt), np.asarray(xj, np.float32))
    np.testing.assert_allclose(_np(tm.logits(ported, xt)),
                               np.asarray(model.logits(params, xj)),
                               rtol=TOL, atol=TOL)
