"""`fused_decode_attention`: the kernel's split-S walk, on the CPU.

`kernels/ref.py::gqa_split_merge` computes the function the kernel's way
(csrc/fused_decode_attention.cu): 8 splits of each row's positions per kv
head, an online softmax over 32-position chunks in each, the splits merged
in ascending order. In f32 it agrees with the plain version within 1e-6
(only the summation order differs), its new caches bitwise; against the
reference's Pallas kernel in interpret mode it agrees within the
reference's tolerances (2e-2 bf16, 2e-5 f32), caches bitwise.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jax_ops
from repro_torch.bridge import to_tensor
from repro_torch.kernels.ref import fused_decode_attention_ref, gqa_split_merge

TOL_TWIN = 1e-6
TOL_BF16 = 2e-2
TOL_F32 = 2e-5

CASES = {
    # name: (cache lengths, or one int for a () length; S, Hq, Hkv, D)
    "lengths_0_and_S-1": ([0, 255, 63, 128], 256, 4, 4, 128),
    "wrapped": ([256, 300, 511, 1000], 256, 4, 4, 64),
    "one_length": (100, 256, 8, 2, 64),
    "g16_d256": ([0, 17, 63], 64, 16, 1, 256),
    "g16_d64": ([5, 63], 64, 32, 2, 64),
    "s130_off_split": ([0, 129, 70, 300], 130, 8, 2, 128),
    # 256 positions a split: 8 chunks each
    "many_chunks": ([1500, 2047], 2048, 2, 1, 16),
    # 5 positions a split: rows of length 0 and 3 attend in split 0 only
    "empty_splits": ([0, 3, 9], 40, 4, 1, 32),
    # one position a split: splits 5-7 own no position at all
    "s_below_splits": ([0, 2, 7], 5, 4, 2, 16),
}


def _args(seed, clens, S, Hq, Hkv, D):
    rng = np.random.default_rng(seed)
    B = 3 if isinstance(clens, int) else len(clens)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return (f(B, 1, Hq, D), f(B, 1, Hkv, D), f(B, 1, Hkv, D),
            f(B, S, Hkv, D), f(B, S, Hkv, D),
            np.asarray(clens, np.int64))


@pytest.mark.parametrize("softcap", [0.0, 30.0])
@pytest.mark.parametrize("case", list(CASES))
def test_split_merge_twin_matches_plain_version(case, softcap):
    args = [torch.from_numpy(a) for a in _args(len(case), *CASES[case])]
    out, kc, vc = gqa_split_merge(*args, logit_softcap=softcap)
    want, kr, vr = fused_decode_attention_ref(*args, logit_softcap=softcap)
    assert torch.equal(kc, kr) and torch.equal(vc, vr)
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out, want, rtol=TOL_TWIN, atol=TOL_TWIN)


JAX_CASES = ["lengths_0_and_S-1", "one_length", "g16_d64",
             "s130_off_split", "s_below_splits"]


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("case", JAX_CASES)
def test_split_merge_twin_matches_reference_kernel(case, dtype):
    args = _args(len(case) + 7, *CASES[case])
    if dtype == "bf16":
        args = tuple(np.asarray(jnp.asarray(a, jnp.bfloat16))
                     if a.dtype == np.float32 else a for a in args)
    q, kn, vn, kc, vc, clen = args
    B = q.shape[0]
    oj, kj, vj = jax_ops.fused_decode_attention(
        *(jnp.asarray(a) for a in (q, kn, vn, kc, vc)),
        jnp.asarray(np.broadcast_to(clen, (B,)), jnp.int32),
        logit_softcap=30.0, interpret=True)
    out, k2, v2 = gqa_split_merge(*(to_tensor(a) for a in args),
                                  logit_softcap=30.0)
    bits = np.uint16 if dtype == "bf16" else np.uint32
    for got, want in ((k2, kj), (v2, vj)):
        np.testing.assert_array_equal(
            got.view(torch.int16 if dtype == "bf16" else torch.int32)
            .numpy().view(bits), np.asarray(want).view(bits))
    tol = TOL_BF16 if dtype == "bf16" else TOL_F32
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(oj).astype(np.float32),
                               rtol=tol, atol=tol)
