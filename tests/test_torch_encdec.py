"""Whisper's encoder-decoder on the port against the reference, in f32 on
the same weights (the reference's init, bridged) and inputs made from a
seed with numpy: the sinusoidal positions, cross-attention over the whole
sequence (`gqa_attention(kv_override=)`) and for one token
(`gqa_decode(cross=True)`), `Model.encode`, and the smoke model's prefill
and decode with the cross K/V cached, attending to fewer source rows than
the cache holds (`src_len`). Cross-attention has no kernel: it runs plain
on every device, as the reference's does.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_smoke_config as jax_smoke
from repro.models import attention as jax_attn
from repro.models import transformer as jax_tf
from repro_torch.bridge import params_from_reference
from repro_torch.configs import get_smoke_config
from repro_torch.models import Model, attention, transformer

ARCH = "whisper-large-v3"
B, T, SRC, STEPS = 2, 12, 24, 3
TOL = 1e-5
TOL_MODEL = 1e-4


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("d,n", [(64, 40), (1280, 1500)])
def test_sinusoidal_pos_matches(d, n):
    """Positions 0..n-1 (whisper's 1500 source frames at its width). The
    two libraries' fp32 `exp` round a few of the frequencies one ulp apart
    (54 of whisper's 640), and the angle pos * freq carries that ulp times
    pos: so the tolerance is 1e-5, or n ulps of 1 where that is larger
    (1.8e-4 at n = 1500; the largest difference seen is 1.2e-4)."""
    pos = np.arange(n)[None].repeat(2, 0)
    want = jax_tf.sinusoidal_pos(jnp.asarray(pos), d)
    got = transformer.sinusoidal_pos(torch.as_tensor(pos), d)
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, n, d)
    tol = max(TOL, n * 2.0 ** -23)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=tol)


def _attn_params(rng, d=48, h=4, hd=16):
    p = {"wq": rng.standard_normal((d, h, hd)) * d ** -0.5,
         "wk": rng.standard_normal((d, h, hd)) * d ** -0.5,
         "wv": rng.standard_normal((d, h, hd)) * d ** -0.5,
         "wo": rng.standard_normal((h, hd, d)) * (h * hd) ** -0.5}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    return ({k: jnp.asarray(v) for k, v in p.items()},
            {k: torch.as_tensor(v) for k, v in p.items()})


def test_cross_attention_over_the_sequence_matches():
    """T decoder rows over S encoder K/V: bidirectional, no rope."""
    rng = np.random.default_rng(1)
    jp, tp = _attn_params(rng)
    x = rng.standard_normal((B, T, 48)).astype(np.float32)
    k = rng.standard_normal((B, SRC, 4, 16)).astype(np.float32)
    v = rng.standard_normal((B, SRC, 4, 16)).astype(np.float32)
    pos = np.arange(SRC)[None].repeat(B, 0)
    want = jax_attn.gqa_attention(
        jp, jnp.asarray(x), positions=jnp.asarray(pos), rope_theta=0.0,
        causal=False, kv_override=(jnp.asarray(k), jnp.asarray(v),
                                   jnp.asarray(pos)))
    got = attention.gqa_attention(
        tp, torch.as_tensor(x), positions=torch.as_tensor(pos),
        rope_theta=0.0, causal=False,
        kv_override=(torch.as_tensor(k), torch.as_tensor(v),
                     torch.as_tensor(pos)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("src_len", [SRC, 7])
def test_cross_attention_decode_matches(src_len):
    """One token over the first `src_len` cached rows; the caches are
    returned as they came (read-only)."""
    rng = np.random.default_rng(2)
    jp, tp = _attn_params(rng)
    x = rng.standard_normal((B, 1, 48)).astype(np.float32)
    kc = rng.standard_normal((B, SRC, 4, 16)).astype(np.float32)
    vc = rng.standard_normal((B, SRC, 4, 16)).astype(np.float32)
    want, wk, _ = jax_attn.gqa_decode(jp, jnp.asarray(x), jnp.asarray(kc),
                                      jnp.asarray(vc), src_len,
                                      rope_theta=10000.0, cross=True)
    tk, tv = torch.as_tensor(kc), torch.as_tensor(vc)
    got, gk, gv = attention.gqa_decode(tp, torch.as_tensor(x), tk, tv,
                                       src_len, rope_theta=10000.0,
                                       cross=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    assert gk is tk and gv is tv
    assert np.array_equal(gk.numpy(), np.asarray(wk))


def test_cross_attention_decode_has_no_kernel():
    rng = np.random.default_rng(3)
    _, tp = _attn_params(rng)
    kc = torch.zeros((B, SRC, 4, 16))
    with pytest.raises(ValueError, match="no cross"):
        attention.gqa_decode(tp, torch.zeros((B, 1, 48)), kc, kc, SRC,
                             rope_theta=0.0, cross=True, use_kernel=True)


@pytest.fixture(scope="module")
def whisper32():
    """The reference's whisper smoke model in f32: encode, prefill over T
    tokens with the cross K/V cached, then STEPS greedy decode steps that
    attend to the first 16 source rows only; and the port's params bridged
    from its."""
    jcfg = dataclasses.replace(jax_smoke(ARCH), dtype="float32")
    tcfg = dataclasses.replace(get_smoke_config(ARCH), dtype="float32")
    jm = jax_tf.Model(jcfg)
    params = jax.jit(jm.init)(jax.random.PRNGKey(9))
    rng = np.random.default_rng(4)
    frames = rng.standard_normal((B, SRC, jcfg.d_model)).astype(np.float32)
    toks = rng.integers(0, jcfg.vocab_size, (B, T)).astype(np.int32)
    enc = jax.jit(jm.encode)(params, jnp.asarray(frames))
    lp, cache = jax.jit(lambda p, t, e: jm.prefill(p, t, max_seq=T + 8,
                                                   enc_out=e))(
        params, jnp.asarray(toks), enc)
    dec = jax.jit(lambda p, t, c: jm.decode_step(p, t, c, src_len=16))
    steps, fed, nxt, c = [], [], jnp.argmax(lp, -1).astype(jnp.int32), cache
    for _ in range(STEPS):
        fed.append(np.asarray(nxt))
        ld, c = dec(params, nxt, c)
        steps.append(_np(ld))
        nxt = jnp.argmax(ld, -1).astype(jnp.int32)
    out = dict(frames=frames, toks=toks, enc=_np(enc), prefill=_np(lp),
               steps=steps, fed=fed,
               xk=[_np(x["xk"][i]) for x in cache["unit"]
                   for i in range(x["xk"].shape[0])])
    return tcfg, params_from_reference(jax.tree.map(np.asarray, params)), out


def test_encode_matches(whisper32):
    cfg, ported, out = whisper32
    with torch.no_grad():
        got = Model(cfg).encode(ported, torch.as_tensor(out["frames"]))
    np.testing.assert_allclose(got.numpy(), out["enc"], rtol=TOL_MODEL,
                               atol=TOL_MODEL)


def test_prefill_and_decode_with_src_len_match(whisper32):
    """Prefill's last logits and cross K/V, then each decode step's logits
    (over the first 16 of 24 source rows) within 1e-4."""
    cfg, ported, out = whisper32
    m = Model(cfg)
    with torch.no_grad():
        enc = m.encode(ported, torch.as_tensor(out["frames"]))
        lp, cache = m.prefill(ported, torch.as_tensor(out["toks"]).long(),
                              max_seq=T + 8, enc_out=enc)
        np.testing.assert_allclose(lp.numpy(), out["prefill"],
                                   rtol=TOL_MODEL, atol=TOL_MODEL)
        for mine, want in zip(cache["layers"], out["xk"]):
            assert tuple(mine["xk"].shape) == (B, SRC, cfg.num_kv_heads,
                                               cfg.resolved_head_dim)
            np.testing.assert_allclose(mine["xk"].numpy(), want,
                                       rtol=TOL_MODEL, atol=TOL_MODEL)
        for fed, want in zip(out["fed"], out["steps"]):
            ld, cache = m.decode_step(ported, torch.as_tensor(fed).long(),
                                      cache, src_len=16)
            np.testing.assert_allclose(ld.numpy(), want, rtol=TOL_MODEL,
                                       atol=TOL_MODEL)
    assert int(cache["len"]) == T + STEPS


def test_decoder_positions_come_from_the_cache_length(whisper32):
    """A decode step embeds its token at position `cache["len"]`: the same
    token at another length gives other logits, and at the prompt's end
    the same as forward's last row."""
    cfg, ported, out = whisper32
    m = Model(cfg)
    toks = torch.as_tensor(out["toks"]).long()
    with torch.no_grad():
        enc = m.encode(ported, torch.as_tensor(out["frames"]))
        _, cache = m.prefill(ported, toks[:, :-1], max_seq=T + 8,
                             enc_out=enc)
        ld, _ = m.decode_step(ported, toks[:, -1], cache)
        want = m.logits(ported, m.forward(ported, toks, enc_out=enc)[:, -1])
        moved = dict(cache, len=cache["len"] + 3)
        other, _ = m.decode_step(ported, toks[:, -1], moved)
    np.testing.assert_allclose(ld.numpy(), want.numpy(), rtol=TOL_MODEL,
                               atol=TOL_MODEL)
    assert float((other - ld).abs().max()) > 1e-3


def test_chunked_prefill_refuses_a_cross_attention_layer():
    cfg = get_smoke_config(ARCH)
    m = Model(cfg)
    params = m.init(torch.Generator().manual_seed(0), device="cpu")
    spec = m.specs[0]
    cache = transformer.init_layer_cache(cfg, spec, 1, 8, m.dtype, "cpu",
                                         src_len=4)
    assert set(cache) == {"k", "v", "xk", "xv"}
    with pytest.raises(NotImplementedError, match="cross"):
        transformer.layer_prefill_chunk(
            params["layers"][0], cfg, spec, torch.zeros((1, 4, cfg.d_model),
                                                        dtype=m.dtype),
            torch.arange(4)[None], cache, 0, 4)
