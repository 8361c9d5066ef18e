"""The port's self-attention functions `gqa_attention` and `gqa_decode`
against the reference's, in f32 on the same weights and inputs (made from a
seed with numpy): windows, soft-caps, an explicit scale, qk-norm, causal
and bidirectional. `gqa_decode(use_kernel=True)` runs the decode kernel's
plain version on CPU tensors and must agree with the reference's decode
too; with a window it raises (the kernel attends to its whole cache).
Cross-attention is held in `test_torch_encdec.py`.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jax_attn
from repro_torch.models import attention

B, T, D_MODEL, HQ, HKV, HD = 2, 24, 48, 4, 2, 16
S = 32          # decode cache rows
TOL = 1e-5


def _params(rng, qk_norm):
    p = {"wq": rng.standard_normal((D_MODEL, HQ, HD)) * D_MODEL ** -0.5,
         "wk": rng.standard_normal((D_MODEL, HKV, HD)) * D_MODEL ** -0.5,
         "wv": rng.standard_normal((D_MODEL, HKV, HD)) * D_MODEL ** -0.5,
         "wo": rng.standard_normal((HQ, HD, D_MODEL)) * (HQ * HD) ** -0.5}
    if qk_norm:
        p["q_norm"] = 1 + 0.1 * rng.standard_normal(HD)
        p["k_norm"] = 1 + 0.1 * rng.standard_normal(HD)
    return {k: v.astype(np.float32) for k, v in p.items()}


def _both(p):
    return ({k: jnp.asarray(v) for k, v in p.items()},
            {k: torch.as_tensor(v) for k, v in p.items()})


# name: (window, logit_softcap, scale, qk_norm, causal)
CASES = {"plain": (0, 0.0, None, False, True),
         "window": (5, 0.0, None, False, True),
         "softcap": (0, 2.0, None, True, True),
         "window_softcap_scale": (7, 3.0, 0.2, False, True),
         "bidirectional": (0, 0.0, None, True, False)}


@pytest.mark.parametrize("case", list(CASES))
def test_gqa_attention_matches_reference(case):
    window, cap, scale, qk_norm, causal = CASES[case]
    rng = np.random.default_rng(5)
    jp, tp = _both(_params(rng, qk_norm))
    x = (rng.standard_normal((B, T, D_MODEL)) * 2).astype(np.float32)
    pos = np.repeat(np.arange(T)[None], B, axis=0)
    kw = dict(rope_theta=10000.0, window=window, causal=causal,
              logit_softcap=cap, scale=scale)
    want = jax_attn.gqa_attention(jp, jnp.asarray(x),
                                  positions=jnp.asarray(pos), **kw)
    got = attention.gqa_attention(tp, torch.as_tensor(x),
                                  positions=torch.as_tensor(pos), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("case,use_kernel", [
    (c, k) for c in CASES if CASES[c][4] for k in (False, True)
    if not (k and CASES[c][0])])
def test_gqa_decode_matches_reference(case, use_kernel):
    """One token against the reference's plain decode: output and both
    new caches, the input caches left as they were (`use_kernel=True`: the
    decode kernel's wrapper, its plain version on the CPU)."""
    window, cap, scale, qk_norm, _ = CASES[case]
    rng = np.random.default_rng(6)
    jp, tp = _both(_params(rng, qk_norm))
    x = rng.standard_normal((B, 1, D_MODEL)).astype(np.float32)
    kc = rng.standard_normal((B, S, HKV, HD)).astype(np.float32)
    vc = rng.standard_normal((B, S, HKV, HD)).astype(np.float32)
    # one length for every row: the reference inserts at one position
    clen = 19
    kw = dict(rope_theta=10000.0, window=window, logit_softcap=cap,
              scale=scale)
    wo, wk, wv = jax_attn.gqa_decode(jp, jnp.asarray(x), jnp.asarray(kc),
                                     jnp.asarray(vc), jnp.int32(clen),
                                     use_kernel=False, **kw)
    tk, tv = torch.as_tensor(kc), torch.as_tensor(vc)
    go, gk, gv = attention.gqa_decode(tp, torch.as_tensor(x), tk, tv,
                                      torch.tensor(clen),
                                      use_kernel=use_kernel, **kw)
    np.testing.assert_allclose(go.numpy(), np.asarray(wo), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(gk.numpy(), np.asarray(wk), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(gv.numpy(), np.asarray(wv), rtol=TOL,
                               atol=TOL)
    assert np.array_equal(tk.numpy(), kc) and np.array_equal(tv.numpy(), vc)


def test_gqa_decode_kernel_rejects_a_window():
    rng = np.random.default_rng(7)
    _, tp = _both(_params(rng, False))
    x = torch.zeros((B, 1, D_MODEL))
    kc = torch.zeros((B, S, HKV, HD))
    with pytest.raises(ValueError, match="no window"):
        attention.gqa_decode(tp, x, kc, kc.clone(), torch.tensor(3),
                             rope_theta=10000.0, window=8, use_kernel=True)
