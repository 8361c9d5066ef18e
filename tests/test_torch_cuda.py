"""Card-only tests of the port: the CUDA kernel against its plain version,
the wrapper's checks, and the slot path against its fully-resident oracle
with asynchronous swap-ins. They skip without a CUDA device; on a machine
with one (and the CUDA toolkit), run them with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

This file imports no JAX: the card's machine need not have it.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.kernels import slot_gather
from repro_torch.kernels.ref import slot_ffn_ref
from repro_torch.models.transformer import Model
from repro_torch.runtime.engine import SlotBufferEngine

pytestmark = pytest.mark.cuda
TOL = 2e-2


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.Generator(device="cuda").manual_seed(0)


def _inputs(g, E, C, D, F, S):
    x = torch.randn((E, C, D), generator=g, device="cuda").bfloat16()
    w = lambda *s: (torch.randn(s, generator=g, device="cuda")  # noqa: E731
                    * s[-2] ** -0.5).bfloat16()
    slot = torch.randint(0, S, (E,), generator=g, device="cuda",
                         dtype=torch.int32)
    return x, slot, w(S, D, F), w(S, D, F), w(S, F, D)


@pytest.mark.parametrize("shape", [(64, 32, 2048, 1024, 256),
                                   (64, 1024, 2048, 1024, 64),
                                   (3, 5, 96, 40, 4), (2, 70, 136, 72, 3)])
def test_slot_ffn_kernel_matches_plain_version(gen, shape):
    args = _inputs(gen, *shape)
    before = slot_gather.slot_ffn.launches
    got = slot_gather.slot_ffn(*args)
    again = slot_gather.slot_ffn(*args)
    want = slot_ffn_ref(*args)
    torch.cuda.synchronize()
    assert slot_gather.slot_ffn.launches == before + 2
    torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)
    assert torch.equal(got, again), "the kernel must be deterministic"


def test_slot_ffn_wrapper_rejects_what_the_kernel_does_not_take(gen):
    x, slot, wg, wu, wd = _inputs(gen, 2, 4, 64, 32, 3)
    with pytest.raises(TypeError):
        slot_gather.slot_ffn(x.float(), slot, wg, wu, wd)
    with pytest.raises(TypeError):
        slot_gather.slot_ffn(x, slot.long(), wg, wu, wd)
    with pytest.raises(ValueError):
        slot_gather.slot_ffn(x, slot, wg.transpose(1, 2), wu, wd)
    x2, slot2, wg2, wu2, wd2 = _inputs(gen, 2, 4, 60, 32, 3)
    with pytest.raises(ValueError):
        slot_gather.slot_ffn(x2, slot2, wg2, wu2, wd2)


def test_slot_path_bitwise_vs_oracle_on_the_card(gen):
    cfg = get_smoke_config("olmoe-1b-7b")
    model = Model(cfg)
    params = model.init(gen, device="cuda")
    eng = SlotBufferEngine(cfg, params, model, n_slots_per_layer=4,
                           use_kernel=True, step_size=1, pregate_margin=0)
    rng = np.random.default_rng(0)
    for _ in range(2):
        prompt = rng.integers(0, cfg.vocab_size, (2, 9))
        lg, st = eng.prefill(prompt)
        lr, sr = eng.reference_prefill(prompt)
        assert torch.equal(lg, lr)
        tok = lr.argmax(-1)
        for _ in range(8):
            lg, st = eng.decode_step(tok, st)
            lr, sr = eng.reference_decode_step(tok, sr)
            assert torch.equal(lg, lr)
            tok = lr.argmax(-1)
    eng.synchronize()
    assert eng.stats.evictions > 0 and eng.stats.copy_s > 0
