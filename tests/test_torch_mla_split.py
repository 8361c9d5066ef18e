"""`fused_mla_decode_attention`: the kernel's split-S walk and the wrapper's
host bound, on the CPU.

- `kernels/ref.py::mla_split_merge` computes the function the kernel's way
  (8 splits of the positions a row, an online softmax over 32-position
  chunks in each, the splits merged in ascending order); in f32 it agrees
  with the plain version within 1e-6 (only the summation order differs),
  and its caches are bitwise equal.
- With `max_len`, a host int bounding the lengths, the wrapper checks the
  room in the cache without reading `cache_len` (here: `torch.aminmax`
  raises if called) and gives the same results.
- The superkernel decode step passes the engine's host mirror of the
  lengths to the wrapper as that bound, single-stream and batched.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduce_config
from repro_torch.kernels import decode_superkernel as dsk
from repro_torch.kernels.ref import (fused_mla_decode_attention_ref,
                                     mla_split_merge)
from repro_torch.models import attention as attn_mod
from repro_torch.models.transformer import Model
from repro_torch.runtime.engine import SlotBufferEngine

TOL_TWIN = 1e-6

CASES = {
    # name: (cache lengths, S, H, R, P)
    "ragged_0_and_S-1": ([0, 5, 15], 16, 4, 32, 8),
    "deepseek_decode_shape": ([0, 63, 128, 255], 256, 16, 512, 64),
    "splits_past_S": ([3, 0], 5, 2, 16, 8),
    "off_split": ([100, 7, 129], 130, 3, 40, 16),
    "one_length": ([9], 16, 4, 32, 8),
}


def _args(seed, clens, S, H, R, P, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    f = lambda *s: torch.randn(s, generator=g)  # noqa: E731
    B = len(clens)
    return (f(B, H, R) * 0.3, f(B, H, P) * 0.3, f(B, R).to(dtype),
            f(B, P).to(dtype), f(B, S, R).to(dtype), f(B, S, P).to(dtype),
            torch.tensor(clens))


@pytest.mark.parametrize("case", list(CASES))
def test_split_merge_twin_matches_plain_version(case):
    clens, S, H, R, P = CASES[case]
    args = _args(len(case), clens, S, H, R, P)
    ctx, lat, pe = mla_split_merge(*args, scale=0.2)
    cr, lr, pr = fused_mla_decode_attention_ref(*args, scale=0.2)
    assert torch.equal(lat, lr) and torch.equal(pe, pr)
    torch.testing.assert_close(ctx, cr, rtol=TOL_TWIN, atol=TOL_TWIN)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_host_bound_reads_no_length(monkeypatch, dtype):
    args = _args(3, [0, 9, 15], 16, 4, 32, 8, dtype)
    want = dsk.fused_mla_decode_attention(*args, scale=0.2)

    def no_read(*a, **k):
        raise AssertionError("the lengths were read")

    monkeypatch.setattr(torch, "aminmax", no_read)
    got = dsk.fused_mla_decode_attention(*args, scale=0.2, max_len=15)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    with pytest.raises(ValueError, match="does not fit"):
        dsk.fused_mla_decode_attention(*args, scale=0.2, max_len=16)


CFG = reduce_config(get_config("deepseek-v2-lite"), layers=4, d_model=64,
                    heads=4, kv_heads=4, d_ff=128, vocab=512, experts=8,
                    top_k=2, d_expert=32)


def test_superkernel_step_passes_the_host_bound(monkeypatch):
    model = Model(CFG)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    eng = SlotBufferEngine(CFG, params, model, n_slots_per_layer=3,
                           use_superkernel=True, max_seq=64, device="cpu")
    seen = []
    real = attn_mod.fused_mla_decode_attention

    def spy(*a, **k):
        seen.append((k.get("max_len"), int(a[6].max())))
        return real(*a, **k)

    monkeypatch.setattr(attn_mod, "fused_mla_decode_attention", spy)
    rng = np.random.default_rng(0)
    # single-stream
    _, st = eng.prefill(rng.integers(0, CFG.vocab_size, (2, 7)))
    tok = np.zeros(2, np.int64)
    for _ in range(2):
        _, st = eng.decode_step(tok, st)
    # batched, rows at different positions and one idle row
    state = eng.alloc_decode_state(3)
    for slot, n in ((0, 5), (2, 11)):
        eng.prefill_into(state, slot, rng.integers(0, CFG.vocab_size, (1, n)))
    for _ in range(2):
        _, state = eng.decode_step(np.zeros(3, np.int64), state)
    assert seen, "the superkernel step never called the MLA kernel's wrapper"
    for bound, longest in seen:
        assert isinstance(bound, int) and bound == longest
    assert {b for b, _ in seen} == {7, 8, 11, 12}
