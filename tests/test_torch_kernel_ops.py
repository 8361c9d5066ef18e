"""The port's kernel API (`repro_torch.kernels.ops`) against the reference's
(`repro.kernels.ops`, Pallas kernels in interpret mode), at the reference's
own test shapes (`tests/test_kernels.py`).

On the CPU the port's wrappers run their plain versions, which follow the
kernels' rounding points. Tolerances (the reference's own for these
kernels):
- `expert_ffn`: 3e-2 for bf16 (one bf16 rounding of h that a different
  fp32 summation order can flip), 2e-5 for f32;
- `topk`: ids equal; gates within rtol 1e-5, atol 1e-6 (fp32 softmax,
  summed in another order).
The card-only tests (`tests/test_torch_cuda.py`) hold the CUDA kernels
against the plain versions.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jax_ops
from repro_torch.bridge import to_tensor
from repro_torch.kernels import (decode_superkernel, moe_gemm, ops,
                                 slot_gather, topk_gating)
from repro_torch.kernels import ref as plain

SHAPES_FFN = [
    # (E, C, D, F, block_c, block_f) of the reference's tests
    (2, 128, 64, 128, 128, 128),
    (4, 256, 64, 128, 128, 128),
    (4, 256, 128, 256, 128, 128),
    (8, 128, 32, 64, 64, 64),
    (1, 512, 256, 512, 128, 256),
]
TOPK_SHAPES = [(64, 8, 2), (100, 16, 4), (256, 64, 8), (33, 128, 8),
               (7, 8, 8)]


def _np(a):
    return np.asarray(a.float() if isinstance(a, torch.Tensor) else a,
                      np.float32)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("shape", SHAPES_FFN, ids=str)
def test_expert_ffn_matches_reference_kernel(shape, dtype):
    E, C, D, F, bc, bf = shape
    rng = np.random.default_rng(E * 1000 + C)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    x = jnp.asarray(rng.standard_normal((E, C, D)), jdt) * 0.5
    wg = jnp.asarray(rng.standard_normal((E, D, F)), jdt) * 0.1
    wu = jnp.asarray(rng.standard_normal((E, D, F)), jdt) * 0.1
    wd = jnp.asarray(rng.standard_normal((E, F, D)), jdt) * 0.1
    want = np.asarray(jax_ops.expert_ffn(x, wg, wu, wd, block_c=bc,
                                         block_f=bf, interpret=True))
    got = ops.expert_ffn(*(to_tensor(np.asarray(a)) for a in (x, wg, wu, wd)))
    assert got.dtype == torch.float32 and tuple(got.shape) == (E, C, D)
    tol = 3e-2 if dtype == "bfloat16" else 2e-5
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)


def test_expert_ffn_rounds_h_to_the_input_dtype():
    """The plain version follows the kernel (h rounded to x's dtype before
    the down product), not the reference's f32-h einsum oracle."""
    rng = np.random.default_rng(3)
    bf = lambda s, sc: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32) * sc).bfloat16()
    x, wg, wu, wd = (bf((2, 8, 32), 1.0), bf((2, 32, 16), 0.3),
                     bf((2, 32, 16), 0.3), bf((2, 16, 32), 0.3))
    g = torch.bmm(x.float(), wg.float())
    u = torch.bmm(x.float(), wu.float())
    h = torch.nn.functional.silu(g) * u
    want = torch.bmm(h.bfloat16().float(), wd.float())
    assert torch.equal(ops.expert_ffn(x, wg, wu, wd), want)
    assert not torch.equal(ops.expert_ffn(x, wg, wu, wd),
                           torch.bmm(h, wd.float()))


def test_slot_ffn_equals_expert_ffn_under_identity_mapping():
    rng = np.random.default_rng(0)
    E, C, D, F = 4, 16, 64, 32
    bf = lambda s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32) * 0.3).bfloat16()
    x, wg, wu, wd = bf((E, C, D)), bf((E, D, F)), bf((E, D, F)), bf((E, F, D))
    ident = torch.arange(E, dtype=torch.int32)
    assert torch.equal(ops.slot_ffn(x, ident, wg, wu, wd),
                       ops.expert_ffn(x, wg, wu, wd))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("norm", [True, False])
@pytest.mark.parametrize("T,E,k", TOPK_SHAPES, ids=str)
def test_topk_matches_reference_kernel(T, E, k, norm, dtype):
    rng = np.random.default_rng(T * E)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    logits = jnp.asarray(rng.standard_normal((T, E)), jdt)
    gw, iw = jax_ops.topk(logits, k, norm=norm, interpret=True)
    g, i = ops.topk(to_tensor(np.asarray(logits)), k, norm=norm)
    assert g.dtype == torch.float32 and i.dtype == torch.int32
    np.testing.assert_array_equal(i.numpy(), np.asarray(iw))
    np.testing.assert_allclose(g.numpy(), np.asarray(gw), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("case", ["all_tied", "pairs_tied", "k_equals_E"])
def test_topk_ties_go_to_the_lowest_index(case):
    """Exactly tied logits: the first (lowest-index) maximum wins each
    round, as in the reference kernel; with k = E every index comes out
    once and the -1e30 mask is never chosen."""
    rng = np.random.default_rng(5)
    if case == "all_tied":
        logits, k = np.zeros((4, 16), np.float32), 5
    elif case == "pairs_tied":
        logits, k = np.repeat(rng.standard_normal((6, 8)), 2, 1), 6
    else:
        logits, k = rng.standard_normal((5, 8)), 8
    logits = logits.astype(np.float32)
    gw, iw = jax_ops.topk(jnp.asarray(logits), k, interpret=True)
    g, i = ops.topk(torch.from_numpy(logits), k)
    np.testing.assert_array_equal(i.numpy(), np.asarray(iw))
    np.testing.assert_allclose(g.numpy(), np.asarray(gw), rtol=1e-5,
                               atol=1e-6)
    if case == "all_tied":
        assert (i.numpy() == np.arange(k)).all()
    if case == "k_equals_E":
        assert (np.sort(i.numpy(), 1) == np.arange(8)).all()
        np.testing.assert_allclose(g.sum(-1).numpy(), 1.0, rtol=1e-6)


def test_topk_rejects_what_the_kernel_does_not_take():
    with pytest.raises(ValueError):
        ops.topk(torch.zeros(2, 257), 2)          # E > 256
    with pytest.raises(ValueError):
        ops.topk(torch.zeros(2, 8), 9)            # k > E
    with pytest.raises(ValueError):
        ops.topk(torch.zeros(2, 8), 0)
    with pytest.raises(ValueError):
        ops.topk(torch.zeros(8), 2)


def test_api_names_are_the_wrappers_and_the_plain_versions():
    assert ops.expert_ffn is moe_gemm.expert_ffn
    assert ops.topk is topk_gating.topk_gating
    assert ops.slot_ffn is slot_gather.slot_ffn
    assert ops.fused_moe_entry is decode_superkernel.fused_moe_entry
    assert ops.fused_decode_attention is \
        decode_superkernel.fused_decode_attention
    assert ops.fused_mla_decode_attention is \
        decode_superkernel.fused_mla_decode_attention
    assert ops.expert_ffn_ref is plain.expert_ffn_ref
    assert ops.topk_ref is plain.topk_gating_ref
    for name in ("expert_ffn", "topk", "slot_ffn", "fused_moe_entry",
                 "fused_decode_attention", "fused_mla_decode_attention"):
        assert hasattr(jax_ops, name)     # the reference's names


def test_cpu_calls_run_the_plain_versions_and_are_not_counted():
    rng = np.random.default_rng(1)
    logits = torch.from_numpy(rng.standard_normal((9, 16)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((2, 5, 16)).astype(
        np.float32)).bfloat16()
    w = torch.full((2, 16, 8), 0.1).bfloat16()
    wd = torch.full((2, 8, 16), 0.1).bfloat16()
    n_topk, n_ffn = ops.topk.launches, ops.expert_ffn.launches
    g, i = ops.topk(logits, 4)
    gr, ir = plain.topk_gating_ref(logits, 4)
    assert torch.equal(g, gr) and torch.equal(i, ir)
    assert torch.equal(ops.expert_ffn(x, w, w, wd),
                       plain.expert_ffn_ref(x, w, w, wd))
    assert (ops.topk.launches, ops.expert_ffn.launches) == (n_topk, n_ffn)


def test_devices_other_than_cpu_and_cuda_raise():
    with pytest.raises(ValueError):
        ops.topk(torch.zeros(4, 8, device="meta"), 2)
    x = torch.zeros(2, 4, 16, dtype=torch.bfloat16, device="meta")
    w = torch.zeros(2, 16, 8, dtype=torch.bfloat16, device="meta")
    wd = torch.zeros(2, 8, 16, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError):
        ops.expert_ffn(x, w, w, wd)
