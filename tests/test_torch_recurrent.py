"""The port's recurrent mixers against the reference's, on the same weights
(the reference's init, bridged) and the same inputs made from a seed with
numpy: recurrentgemma's RG-LRU (`models/recurrent.py`) and xLSTM's mLSTM /
sLSTM (`models/xlstm.py`).

- `_temporal_conv` sums its taps in bf16 in the reference's order: bitwise.
- f32 within 1e-5: the port's time loop (sequential, fp32) against the
  reference's associative scan (RG-LRU) or `lax.scan` (xLSTM) parts only in
  the last bits of fp32.
- bf16 within 2e-2, each call on the reference's inputs and states: the two
  frameworks' bf16 products round apart in the last bit (the sLSTM's `r_z`
  product runs in bf16 inside the loop).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import recurrent as jax_rec
from repro.models import xlstm as jax_xl
from repro_torch.bridge import to_tensor
from repro_torch.models import recurrent, xlstm

B, T, D_MODEL, H, K = 2, 24, 64, 4, 4
TOL32 = 1e-5
TOL16 = 2e-2
DTYPES = {"f32": jnp.float32, "bf16": jnp.bfloat16}


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _port(tree):
    """A numpy / JAX tree (dicts, named tuples) -> torch, bitwise."""
    if isinstance(tree, dict):
        return {k: _port(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        items = [_port(v) for v in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") \
            else tuple(items)
    return to_tensor(np.asarray(tree))


def _close(got, want, tol):
    if isinstance(want, tuple):
        for g, w in zip(got, want):
            _close(g, w, tol)
        return
    np.testing.assert_allclose(got.float().numpy(), _np(want), rtol=tol,
                               atol=tol)


def _x(dtype, t=T, seed=0):
    rng = np.random.default_rng(seed)
    return jnp.asarray(rng.standard_normal((B, t, D_MODEL)), dtype)


# ---------------------------------------------------------------------------
# RG-LRU
# ---------------------------------------------------------------------------

def _rg_params(dtype):
    return jax_rec.init_rglru_block(jax.random.PRNGKey(3), D_MODEL, D_MODEL,
                                    K, dtype)


def test_rglru_init_matches_the_reference_tree():
    """Keys, shapes and dtypes (a_param and the gate biases fp32 in a bf16
    block); a_param drawn in [0.9, 0.999)."""
    ref = _rg_params(jnp.bfloat16)
    mine = recurrent.init_rglru_block(D_MODEL, D_MODEL, K, torch.bfloat16,
                                      generator=torch.Generator()
                                      .manual_seed(0))
    assert set(mine) == set(ref)
    for k, v in ref.items():
        assert tuple(mine[k].shape) == v.shape, k
        assert str(mine[k].dtype).split(".")[-1] == str(v.dtype), k
    a = mine["a_param"]
    assert float(a.min()) >= 0.9 and float(a.max()) < 0.999


@pytest.mark.parametrize("with_state", [False, True],
                         ids=["no_state", "state"])
def test_temporal_conv_is_bitwise_in_bf16(with_state):
    rng = np.random.default_rng(1)
    x = jnp.asarray(rng.standard_normal((B, 9, D_MODEL)), jnp.bfloat16)
    w = jnp.asarray(rng.standard_normal((K, D_MODEL)), jnp.bfloat16)
    b = jnp.asarray(rng.standard_normal(D_MODEL), jnp.bfloat16)
    st = jnp.asarray(rng.standard_normal((B, K - 1, D_MODEL)),
                     jnp.bfloat16) if with_state else None
    want_y, want_s = jax_rec._temporal_conv(x, w, b, st)
    got_y, got_s = recurrent._temporal_conv(
        *_port((x, w, b)), None if st is None else _port(st))
    assert got_y.dtype == torch.bfloat16
    assert torch.equal(got_y, _port(want_y))
    assert torch.equal(got_s, _port(want_s))


def test_rglru_coeffs_match():
    p = _rg_params(jnp.float32)
    xb = _x(jnp.float32)
    want = jax_rec._rglru_coeffs(p, xb)
    got = recurrent._rglru_coeffs(_port(p), _port(xb))
    _close(got, want, TOL32)


@pytest.mark.parametrize("with_h0", [False, True], ids=["no_h0", "h0"])
def test_rglru_scan_matches_the_associative_scan(with_h0):
    """Decays drawn in (0.5, 1) over 64 steps, so the products span many
    orders of magnitude; h0 is folded into the first input term."""
    rng = np.random.default_rng(2)
    a = jnp.asarray(rng.uniform(0.5, 1.0, (B, 64, D_MODEL)), jnp.float32)
    b = jnp.asarray(rng.standard_normal((B, 64, D_MODEL)), jnp.float32)
    h0 = jnp.asarray(rng.standard_normal((B, D_MODEL)), jnp.float32) \
        if with_h0 else None
    want = jax.jit(jax_rec.rglru_scan)(a, b, h0)
    got = recurrent.rglru_scan(_port(a), _port(b),
                               None if h0 is None else _port(h0))
    _close(got, want, TOL32)


@pytest.mark.parametrize("dt", list(DTYPES))
def test_rglru_block_prefill_then_decode(dt):
    """A prefill over T tokens from no state, then one decode step from the
    reference's states: output and both states."""
    dtype = DTYPES[dt]
    tol = TOL32 if dt == "f32" else TOL16
    p = _rg_params(dtype)
    pt = _port(p)
    x = _x(dtype)
    want = jax.jit(jax_rec.rglru_block)(p, x)
    got = recurrent.rglru_block(pt, _port(x))
    _close(got, want, tol)
    xd = _x(dtype, 1, seed=4)
    want_d = jax_rec.rglru_block(p, xd, conv_state=want[1],
                                 rec_state=want[2], decode=True)
    got_d = recurrent.rglru_block(pt, _port(xd), conv_state=_port(want[1]),
                                  rec_state=_port(want[2]), decode=True)
    _close(got_d, want_d, tol)
    assert got_d[2].dtype == torch.float32


def test_rglru_block_with_a_prompt_state():
    """A prefill resumed from a state (rec_state folded into the scan)."""
    p = _rg_params(jnp.float32)
    x1, x2 = _x(jnp.float32, 10, seed=5), _x(jnp.float32, 14, seed=6)
    block = jax.jit(jax_rec.rglru_block)
    _, cs, rs = block(p, x1)
    want = block(p, x2, conv_state=cs, rec_state=rs)
    got = recurrent.rglru_block(_port(p), _port(x2), conv_state=_port(cs),
                                rec_state=_port(rs))
    _close(got, want, TOL32)


# ---------------------------------------------------------------------------
# xLSTM
# ---------------------------------------------------------------------------

def _ml_params(dtype):
    return jax_xl.init_mlstm_block(jax.random.PRNGKey(5), D_MODEL, H, 2.0,
                                   dtype)


def _sl_params(dtype):
    return jax_xl.init_slstm_block(jax.random.PRNGKey(6), D_MODEL, H, 2.0,
                                   dtype)


@pytest.mark.parametrize("f", [-30.0, -20.5, 20.5, 30.0])
def test_steps_at_large_forget_preactivations(f):
    """Both steps with every forget pre-activation at f, past torch's
    softplus threshold of 20: the port's log-sigmoid against the
    reference's -softplus(-f), through the stabiliser and the states (f32,
    1e-5)."""
    rng = np.random.default_rng(13)
    i_f = (jnp.asarray(rng.standard_normal((B, H)), jnp.float32),
           jnp.full((B, H), f, jnp.float32))
    D = int(D_MODEL * 2.0) // H
    qkv = tuple(jnp.asarray(rng.standard_normal((B, H, D)), jnp.float32)
                for _ in range(3))
    st = _ml_state(jnp.float32)
    want = jax_xl._mlstm_step(H, st, qkv + i_f)
    got = xlstm._mlstm_step(_port(st), _port(qkv + i_f))
    _close(got, want, TOL32)
    p = _sl_params(jnp.float32)
    _, sst = jax_xl.slstm_block(p, _x(jnp.float32, 8, seed=14), H)
    z = jnp.asarray(rng.standard_normal((B, H, D_MODEL // H)), jnp.float32)
    o = jnp.asarray(rng.uniform(0, 1, (B, H, D_MODEL // H)), jnp.float32)
    want = jax_xl._slstm_step(p, H, sst, (z,) + i_f + (o,))
    got = xlstm._slstm_step(_port(p), _port(sst), _port((z,) + i_f + (o,)))
    _close(got, want, TOL32)


@pytest.mark.parametrize("block", ["mlstm", "slstm"])
def test_xlstm_init_matches_the_reference_tree(block):
    ref = (_ml_params if block == "mlstm" else _sl_params)(jnp.bfloat16)
    init = xlstm.init_mlstm_block if block == "mlstm" else \
        xlstm.init_slstm_block
    mine = init(D_MODEL, H, 2.0, torch.bfloat16,
                generator=torch.Generator().manual_seed(0))
    assert set(mine) == set(ref)
    for k, v in ref.items():
        assert tuple(mine[k].shape) == v.shape, k
        assert str(mine[k].dtype).split(".")[-1] == str(v.dtype), k
    assert torch.equal(mine["b_f"], torch.full((H,), 3.0))


def _ml_state(dtype):
    """A state the reference reached over a prompt (m finite)."""
    p = _ml_params(dtype)
    _, st = jax_xl.mlstm_block(p, _x(dtype, 8, seed=7), H)
    return st


@pytest.mark.parametrize("dt", list(DTYPES))
def test_mlstm_step_matches(dt):
    dtype = DTYPES[dt]
    up = int(D_MODEL * 2.0)
    D = up // H
    rng = np.random.default_rng(8)
    qkv = tuple(jnp.asarray(rng.standard_normal((B, H, D)), dtype)
                for _ in range(3))
    i_f = (jnp.asarray(rng.standard_normal((B, H)) * 3, jnp.float32),
           jnp.asarray(rng.standard_normal((B, H)) * 3 + 2, jnp.float32))
    st = _ml_state(dtype)
    want = jax_xl._mlstm_step(H, st, qkv + i_f)
    got = xlstm._mlstm_step(_port(st), _port(qkv + i_f))
    _close(got[0], want[0], TOL32 if dt == "f32" else TOL16)
    _close(got[1], want[1], TOL32 if dt == "f32" else TOL16)


@pytest.mark.parametrize("dt", list(DTYPES))
def test_mlstm_block_prefill_then_decode(dt):
    dtype = DTYPES[dt]
    tol = TOL32 if dt == "f32" else TOL16
    p = _ml_params(dtype)
    pt = _port(p)
    x = _x(dtype)
    want = jax_xl.mlstm_block(p, x, H)
    got = xlstm.mlstm_block(pt, _port(x), H)
    _close(got[0], want[0], tol)
    _close(got[1], want[1], tol)
    xd = _x(dtype, 1, seed=9)
    want_d = jax_xl.mlstm_block(p, xd, H, state=want[1], decode=True)
    got_d = xlstm.mlstm_block(pt, _port(xd), H, state=_port(want[1]),
                              decode=True)
    _close(got_d[0], want_d[0], tol)
    _close(got_d[1], want_d[1], tol)


@pytest.mark.parametrize("dt", list(DTYPES))
def test_slstm_step_matches(dt):
    dtype = DTYPES[dt]
    D = D_MODEL // H
    rng = np.random.default_rng(10)
    p = _sl_params(dtype)
    _, st = jax_xl.slstm_block(p, _x(dtype, 8, seed=11), H)
    z = jnp.asarray(rng.standard_normal((B, H, D)), dtype)
    i_f = (jnp.asarray(rng.standard_normal((B, H)) * 3, jnp.float32),
           jnp.asarray(rng.standard_normal((B, H)) * 3 + 2, jnp.float32))
    o = jnp.asarray(rng.uniform(0, 1, (B, H, D)), jnp.float32)
    want = jax_xl._slstm_step(p, H, st, (z,) + i_f + (o,))
    got = xlstm._slstm_step(_port(p), _port(st), _port((z,) + i_f + (o,)))
    _close(got[0], want[0], TOL32 if dt == "f32" else TOL16)
    _close(got[1], want[1], TOL32 if dt == "f32" else TOL16)


@pytest.mark.parametrize("dt", list(DTYPES))
def test_slstm_block_prefill_then_decode(dt):
    dtype = DTYPES[dt]
    tol = TOL32 if dt == "f32" else TOL16
    p = _sl_params(dtype)
    pt = _port(p)
    x = _x(dtype)
    want = jax_xl.slstm_block(p, x, H)
    got = xlstm.slstm_block(pt, _port(x), H)
    _close(got[0], want[0], tol)
    _close(got[1], want[1], tol)
    xd = _x(dtype, 1, seed=12)
    want_d = jax_xl.slstm_block(p, xd, H, state=want[1], decode=True)
    got_d = xlstm.slstm_block(pt, _port(xd), H, state=_port(want[1]),
                              decode=True)
    _close(got_d[0], want_d[0], tol)
    _close(got_d[1], want_d[1], tol)


def test_xlstm_states_start_at_the_reference_values():
    """m starts at -1e30 and C, n (and the sLSTM's h) at zero, fp32."""
    m = xlstm.mlstm_zero_state(B, H, 8, "cpu")
    s = xlstm.slstm_zero_state(B, H, 8, "cpu")
    for st in (m, s):
        assert all(t.dtype == torch.float32 for t in st)
        assert torch.equal(st.m, torch.full((B, H), -1e30))
    assert m.c.shape == (B, H, 8, 8) and float(m.c.abs().sum()) == 0
    assert float(s.h.abs().sum()) == 0
