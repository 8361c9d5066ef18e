"""The port's slot_ffn against the reference Pallas kernel (interpret mode).

On the CPU the port's wrapper runs its plain version, which follows the
kernel's rounding points (fp32 g/u, bf16 h, fp32 down-projection). The
tolerance 2e-2 covers one bf16 rounding of h that a different fp32
summation order can flip. The card-only test holds the CUDA kernel against
the plain version on the same inputs.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import slot_gather as jax_slot_gather
from repro_torch.bridge import to_tensor
from repro_torch.kernels import slot_gather
from repro_torch.kernels.ref import slot_ffn_ref

TOL = 2e-2


def _inputs(seed, E, C, D, F, S, table=None):
    rng = np.random.default_rng(seed)
    bf = lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16))  # noqa: E731
    x = bf(rng.standard_normal((E, C, D)))
    wg = bf(rng.standard_normal((S, D, F)) * D ** -0.5)
    wu = bf(rng.standard_normal((S, D, F)) * D ** -0.5)
    wd = bf(rng.standard_normal((S, F, D)) * F ** -0.5)
    soe = (np.asarray(table, np.int32) if table is not None
           else rng.permutation(S)[:E].astype(np.int32))
    return x, soe, wg, wu, wd


def _jax_slot_ffn(x, soe, wg, wu, wd):
    return np.asarray(jax_slot_gather.slot_ffn(
        jnp.asarray(x), jnp.asarray(soe), jnp.asarray(wg), jnp.asarray(wu),
        jnp.asarray(wd), interpret=True))


CASES = {
    "aligned": dict(E=4, C=16, D=64, F=32, S=6),
    "ragged": dict(E=3, C=5, D=96, F=40, S=4),
    "duplicate_slots": dict(E=4, C=8, D=64, F=32, S=3, table=[1, 1, 2, 1]),
    "clamped_slot0": dict(E=4, C=8, D=64, F=32, S=4, table=[0, 0, 3, 0]),
    # f32 x and slot buffers: the reference's f32 tolerance, 2e-5
    "f32_aligned": dict(E=4, C=16, D=64, F=32, S=6),
    "f32_duplicate_slots": dict(E=4, C=8, D=64, F=32, S=3,
                                table=[1, 1, 2, 1]),
}
TOL_F32 = 2e-5


@pytest.mark.parametrize("name", list(CASES))
def test_slot_ffn_plain_matches_reference_kernel(name):
    c = CASES[name]
    x, soe, wg, wu, wd = _inputs(7, c["E"], c["C"], c["D"], c["F"], c["S"],
                                 c.get("table"))
    tol = TOL
    if name.startswith("f32"):
        x, wg, wu, wd = (a.astype(np.float32) for a in (x, wg, wu, wd))
        tol = TOL_F32
    want = _jax_slot_ffn(x, soe, wg, wu, wd)
    got = slot_gather.slot_ffn(*(to_tensor(a) for a in (x, soe, wg, wu, wd)))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)


def test_slot_ffn_cpu_path_is_plain_version_and_not_counted():
    x, soe, wg, wu, wd = (to_tensor(a) for a in
                          _inputs(3, **CASES["aligned"]))
    before = slot_gather.slot_ffn.launches
    got = slot_gather.slot_ffn(x, soe, wg, wu, wd)
    assert torch.equal(got, slot_ffn_ref(x, soe, wg, wu, wd))
    assert slot_gather.slot_ffn.launches == before


def test_slot_ffn_raises_on_devices_it_does_not_run_on():
    x, soe, wg, wu, wd = (to_tensor(a).to("meta") for a in
                          _inputs(3, **CASES["aligned"]))
    with pytest.raises(ValueError):
        slot_gather.slot_ffn(x, soe, wg, wu, wd)
