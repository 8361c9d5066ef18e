"""`slot_ffn` with per-expert row counts, on the CPU.

The kernel computes only the rows of each expert that hold tokens (its
first counts[e] rows) and reads no weights for an expert whose count is 0.
Here: the plain version with counts against the reference Pallas kernel
(interpret mode) on the counted rows, within 2e-2 (one bf16 rounding of h
that a different fp32 summation order can flip), and zeros past them; the
Python twin of the kernel's tile walk; the MoE layer passing counts; and
the engine no longer waiting on the slot a non-resident expert's entry is
clamped to.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import slot_gather as jax_slot_gather
from repro.models import moe as jax_moe
from repro_torch.bridge import to_tensor
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import slot_gather
from repro_torch.kernels.ref import (FFN_BLOCK_M, ffn_block_tiles,
                                     ffn_tile_schedule, slot_ffn_ref)
from repro_torch.models import moe
from repro_torch.models.transformer import Model
from repro_torch.runtime.engine import SlotBufferEngine

TOL = 2e-2
CFG = get_smoke_config("olmoe-1b-7b")
M = CFG.moe


def _bf(a):
    return np.asarray(jnp.asarray(a, jnp.bfloat16))


def _inputs(seed, E, C, D, F, S, table):
    rng = np.random.default_rng(seed)
    x = _bf(rng.standard_normal((E, C, D)))
    wg = _bf(rng.standard_normal((S, D, F)) * D ** -0.5)
    wu = _bf(rng.standard_normal((S, D, F)) * D ** -0.5)
    wd = _bf(rng.standard_normal((S, F, D)) * F ** -0.5)
    return x, np.asarray(table, np.int32), wg, wu, wd


# (E, C, D, F, S, table, counts)
CASES = {
    "zero_count": (4, 8, 64, 32, 6, [5, 0, 2, 3], [3, 0, 8, 1]),
    "all_rows": (3, 8, 64, 32, 4, [2, 0, 1], [8, 8, 8]),
    "ragged": (3, 5, 96, 40, 4, [3, 1, 0], [2, 5, 4]),
    "duplicate_slots": (4, 8, 64, 32, 3, [1, 1, 2, 1], [7, 0, 2, 8]),
    "past_capacity": (2, 6, 64, 32, 2, [1, 0], [9, -1]),
}


@pytest.mark.parametrize("name", list(CASES))
def test_slot_ffn_counts_plain_matches_reference_kernel(name):
    E, C, D, F, S, table, counts = CASES[name]
    x, soe, wg, wu, wd = _inputs(11, E, C, D, F, S, table)
    want = np.asarray(jax_slot_gather.slot_ffn(
        *(jnp.asarray(a) for a in (x, soe, wg, wu, wd)), interpret=True))
    cnt = torch.tensor(counts, dtype=torch.int32)
    got = slot_gather.slot_ffn(*(to_tensor(a) for a in (x, soe, wg, wu, wd)),
                               counts=cnt).numpy()
    rows = np.clip(np.asarray(counts), 0, C)
    for e in range(E):
        np.testing.assert_allclose(got[e, :rows[e]], want[e, :rows[e]],
                                   rtol=TOL, atol=TOL)
        assert not got[e, rows[e]:].any(), "rows past the count must be 0"


def test_slot_ffn_full_counts_equal_no_counts_bitwise():
    E, C, D, F, S, table, _ = CASES["ragged"]
    args = [to_tensor(a) for a in _inputs(3, E, C, D, F, S, table)]
    full = torch.full((E,), C, dtype=torch.int32)
    assert torch.equal(slot_gather.slot_ffn(*args, counts=full),
                       slot_gather.slot_ffn(*args))


def test_slot_ffn_counts_ignore_nan_weights_of_an_uncounted_expert():
    E, C, D, F, S, table, counts = CASES["zero_count"]
    x, soe, wg, wu, wd = (to_tensor(a) for a in
                          _inputs(5, E, C, D, F, S, table))
    for w in (wg, wu, wd):
        w[0] = float("nan")          # slot 0: only expert 1 (count 0) reads it
    got = slot_gather.slot_ffn(x, soe, wg, wu, wd,
                               counts=torch.tensor(counts, dtype=torch.int32))
    assert torch.isfinite(got).all()


# --- the tile walk --------------------------------------------------------

@pytest.mark.parametrize("counts,C,want", [
    ([0, 0, 0], 300, []),
    ([1, 128, 129, 0, 300], 300,
     [(0, 0), (1, 0), (2, 0), (2, 128), (4, 0), (4, 128), (4, 256)]),
    ([0, 0, 1000, 0], 1000,
     [(2, m) for m in range(0, 1000, FFN_BLOCK_M)]),
    ([500, -3], 200, [(0, 0), (0, 128)]),
], ids=["all_zero", "not_multiples", "one_expert_all_rows", "clamped"])
def test_ffn_tile_schedule(counts, C, want):
    assert ffn_tile_schedule(counts, C) == want


@pytest.mark.parametrize("counts,C", [
    ([0, 0, 0, 0], 64), ([1, 128, 129, 0, 300, 5], 300),
    ([0, 0, 1000, 0], 1000), (None, 70)], ids=[
    "all_zero", "not_multiples", "one_expert_all_rows", "no_counts"])
@pytest.mark.parametrize("n_panels", [1, 3])
@pytest.mark.parametrize("grid", [1, 4, 132])
def test_ffn_block_tiles_cover_each_tile_once_in_order(counts, C, n_panels,
                                                       grid):
    E = 3 if counts is None else len(counts)
    rows = ffn_tile_schedule([C] * E if counts is None else counts, C)
    # the kernel's list: expert by expert, panel by panel, m-tile fastest
    want = [(e, p, m0) for e in range(E) for p in range(n_panels)
            for (e2, m0) in rows if e2 == e]
    per_block = [ffn_block_tiles(counts, E, C, n_panels, b, grid)
                 for b in range(grid)]
    for b, tiles in enumerate(per_block):
        assert tiles == want[b::grid]
    assert sum(len(t) for t in per_block) == len(want)


# --- the MoE layer ----------------------------------------------------------

def _moe_params(seed, d=CFG.d_model, E=M.num_experts, f=M.d_expert):
    rng = np.random.default_rng(seed)
    return {
        "router": (rng.standard_normal((d, E)) * d ** -0.5).astype(np.float32),
        "w_gate": _bf(rng.standard_normal((E, d, f)) * d ** -0.5),
        "w_up": _bf(rng.standard_normal((E, d, f)) * d ** -0.5),
        "w_down": _bf(rng.standard_normal((E, f, d)) * f ** -0.5),
    }


def test_dispatch_gather_counts_are_the_dispatch_bincount():
    rng = np.random.default_rng(2)
    ids = torch.as_tensor(rng.integers(0, 5, (9, 2)))
    x = torch.randn(9, 4)
    *_, counts = moe._dispatch_gather(x, ids, 5, 3)
    assert torch.equal(counts, torch.bincount(ids.reshape(-1), minlength=5))
    table = torch.tensor([0, -1, 2, 1, -1], dtype=torch.int32)
    got = moe.slot_ffn_row_counts(counts, table, 3)
    want = torch.where(table >= 0, counts.clamp(max=3), 0)
    assert got.dtype == torch.int32 and torch.equal(got, want.int())


def test_moe_slotbuf_kernel_path_never_reads_an_unused_nan_slot():
    """Routed experts that are not resident point at slot 0, which no
    resident expert uses and which holds NaN: the kernel path's output
    stays finite and agrees with the einsum path (port and reference)."""
    rng = np.random.default_rng(8)
    p = _moe_params(9)
    T, S = 10, 7
    x = _bf(rng.standard_normal((T, CFG.d_model)))
    table = -np.ones(M.num_experts, np.int32)
    resident = rng.permutation(M.num_experts)[:S - 1]
    table[resident] = 1 + rng.permutation(S - 1)
    slots = {k: np.full((S,) + p[k].shape[1:], np.nan, p[k].dtype)
             for k in ("w_gate", "w_up", "w_down")}
    for e in resident:
        for k in slots:
            slots[k][table[e]] = p[k][e]
    tp = {k: to_tensor(v) for k, v in p.items()}
    ts = {k: to_tensor(v) for k, v in slots.items()}
    got, r = moe.moe_slotbuf(tp, ts, to_tensor(table), to_tensor(x), M,
                             capacity=T * M.top_k, use_kernel=True)
    routed = set(r.expert_ids.reshape(-1).tolist())
    assert routed - set(resident.tolist()), "no routed expert is absent"
    assert torch.isfinite(got.float()).all()
    einsum, _ = moe.moe_slotbuf(tp, ts, to_tensor(table), to_tensor(x), M,
                                capacity=T * M.top_k, use_kernel=False)
    want, _ = jax_moe.moe_slotbuf(
        {k: jnp.asarray(v) for k, v in p.items()},
        {k: jnp.asarray(v) for k, v in slots.items()}, jnp.asarray(table),
        jnp.asarray(x), M, capacity=T * M.top_k, use_kernel=False)
    for other in (einsum.float().numpy(), np.asarray(want, np.float32)):
        np.testing.assert_allclose(got.float().numpy(), other, rtol=5e-2,
                                   atol=5e-2)


# --- the engine's stream waits ---------------------------------------------

def test_wait_slots_skips_the_clamped_slot_of_absent_experts(monkeypatch):
    model = Model(CFG)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    eng = SlotBufferEngine(CFG, params, model, n_slots_per_layer=4,
                           use_kernel=True, device="cpu")
    waited = []

    class Stream:
        def wait_event(self, ev):
            waited.append(ev)

    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: Stream())
    eng._slot_ready = {0: "copy into slot 0", 3: "copy into slot 3"}
    eng._wait_slots(np.array([-1, 3, -1, -1], np.int32))
    assert waited == ["copy into slot 3"]
    assert eng._slot_ready == {0: "copy into slot 0"}
