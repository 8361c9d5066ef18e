"""The f32 SwiGLU GEMM's 3xTF32 arithmetic (csrc/swiglu_f32.cuh), on the CPU.

- `kernels/ref.py::tf32_split` rounds hi to TF32 as `cvt.rna.tf32.f32`
  does: to nearest on the bit pattern, ties away from zero; lo is x - hi
  truncated to TF32, as the tensor cores read it; x - (hi + lo) is below
  2^-21 of |x|, and a NaN x always gives a NaN lo.
- `expert_ffn_3xtf32`, the twin of the kernel's products (k ascending in
  8-deep steps, lo.hi + hi.lo + hi.hi each step), stays within the
  reference's f32 tolerance, 2e-5, of `expert_ffn_ref` at the card tests'
  shapes and at olmoe-1b-7b's width (D = 2048, F = 1024, 32 rows).
- Why three products: a single TF32 product misses 2e-5 at that width.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.ref import expert_ffn_3xtf32, expert_ffn_ref, tf32_split

TOL_F32 = 2e-5   # the reference's own f32 tolerance


def _rna_numpy(x: np.ndarray) -> np.ndarray:
    """TF32 rounding by arithmetic, not bits: |x| to 11 significant bits,
    half-way cases away from zero (finite, normal inputs)."""
    m, e = np.frexp(np.abs(x).astype(np.float64))      # m in [0.5, 1)
    r = np.floor(m * 2.0 ** 11 + 0.5) / 2.0 ** 11
    return (np.sign(x) * np.ldexp(r, e)).astype(np.float32)


def _trunc_numpy(x: np.ndarray) -> np.ndarray:
    """TF32 truncation by arithmetic: |x| to 11 significant bits, toward
    zero (finite, normal inputs)."""
    m, e = np.frexp(np.abs(x).astype(np.float64))
    return (np.sign(x) * np.ldexp(np.floor(m * 2.0 ** 11) / 2.0 ** 11,
                                  e)).astype(np.float32)


def _bits(v) -> torch.Tensor:
    return torch.tensor(np.asarray(v, np.uint32).view(np.float32))


@pytest.mark.parametrize("low, up", [(0x0FFF, False), (0x1000, True),
                                     (0x1001, True), (0x1FFF, True),
                                     (0x0000, False), (0x0001, False)])
@pytest.mark.parametrize("sign", [0, 0x80000000])
def test_tf32_rounds_to_nearest_ties_away_from_zero(low, up, sign):
    base = 0x3F8AC000                     # 1.08..., TF32-exact
    x = _bits([sign | base | low])
    hi, _ = tf32_split(x)
    want = sign | (base + (0x2000 if up else 0))
    assert hi.view(torch.int32).item() & 0xFFFFFFFF == want


@pytest.mark.parametrize("scale", [1e-3, 1.0, 37.0, 1e6])
def test_tf32_split_matches_arithmetic_rounding(scale):
    rng = np.random.default_rng(int(scale * 7) % 1000)
    x = (rng.standard_normal(4096) * scale).astype(np.float32)
    hi, lo = tf32_split(torch.from_numpy(x))
    np.testing.assert_array_equal(hi.numpy(), _rna_numpy(x))
    np.testing.assert_array_equal(lo.numpy(),
                                  _trunc_numpy((x - hi.numpy()).astype(
                                      np.float32)))
    # both halves carry 10 mantissa bits; hi + lo is x to 2^-21 relative
    for t in (hi, lo):
        assert not (t.view(torch.int32) & 0x1FFF).any()
    err = np.abs(x.astype(np.float64) - hi.numpy() - lo.numpy())
    assert (err <= np.abs(x) * 2.0 ** -21).all()


def test_tf32_split_keeps_infinities_and_zeros():
    x = torch.tensor([float("inf"), float("-inf"), 0.0, -0.0, 3.4028235e38])
    hi, lo = tf32_split(x)
    assert torch.isinf(hi[:2]).all()
    assert torch.equal(torch.signbit(hi[:4]), torch.signbit(x[:4]))
    assert hi[2].item() == 0.0 and lo[2].item() == 0.0
    assert hi[3].item() == 0.0 and lo[3].item() == 0.0
    assert torch.isinf(hi[4])        # rounds past the largest float


@pytest.mark.parametrize("nan", [0x7FFFFFFF, 0xFFFFFFFF, 0x7FC00000,
                                 0xFFC00000, 0x7F800001, 0x7FFFF000])
def test_tf32_split_keeps_every_nan_in_lo(nan):
    """Rounding alone carries a NaN with high payload bits into the
    exponent and sign (0x7FFFFFFF to -0.0, 0xFFFFFFFF to +0.0) and one with
    only low payload bits to an infinity; lo = x - hi is the canonical NaN
    whatever hi became, and stays a NaN when the tensor cores read it."""
    hi, lo = tf32_split(_bits([nan]))
    assert lo.view(torch.int32).item() == 0x7FFFE000
    assert torch.isnan(lo).all()
    if nan in (0x7FFFFFFF, 0xFFFFFFFF):
        assert hi.item() == 0.0


def _ffn_inputs(seed, E, C, D, F):
    """x ~ N(0, 1), weights ~ N(0, 1/K), as the card's tests draw them."""
    rng = np.random.default_rng(seed)
    f = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32) * s[-2] ** -0.5)
    x = torch.from_numpy(rng.standard_normal((E, C, D)).astype(np.float32))
    return x, f(E, D, F), f(E, D, F), f(E, F, D)


SHAPES = {
    # the card tests' f32 expert_ffn shapes
    "ragged": (3, 40, 64, 48),
    "small": (8, 128, 256, 128),
    # olmoe-1b-7b's expert width, 32 rows (a decode batch's assignments)
    "olmoe_width": (1, 32, 2048, 1024),
}


@pytest.mark.parametrize("shape", list(SHAPES))
def test_3xtf32_twin_within_the_reference_tolerance(shape):
    args = _ffn_inputs(len(shape), *SHAPES[shape])
    got = expert_ffn_3xtf32(*args)
    want = expert_ffn_ref(*args)
    torch.testing.assert_close(got, want, rtol=TOL_F32, atol=TOL_F32)
    assert float((got - want).abs().max()) < TOL_F32 / 2


def test_one_tf32_product_misses_the_reference_tolerance():
    args = _ffn_inputs(3, *SHAPES["olmoe_width"])
    want = expert_ffn_ref(*args)
    err1 = float((expert_ffn_3xtf32(*args, products=1) - want).abs().max())
    err3 = float((expert_ffn_3xtf32(*args) - want).abs().max())
    assert err1 > 10 * TOL_F32        # about 1e-3 off
    assert err3 < TOL_F32 / 2
