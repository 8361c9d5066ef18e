"""The work list and tile walk of `fused_moe_entry`'s kernel, on the CPU.

The route launch builds, on the device, the rows of every routed and
resident expert (ascending id, with its slot and its assignments t * k + j
in ascending order); the persistent gate/up and down passes then walk
(expert, column panel, 128-row tile) items over those per-expert row
counts, as `slot_ffn`'s GEMM does. The Python twins in `kernels/ref.py`
(`moe_entry_work_list`, `ffn_block_tiles`) are held here against a
brute-force enumeration over drawn routings and residency: every
routed-and-resident (expert, column panel) is computed exactly once in
each pass, with all of the expert's rows, and nothing is computed for an
unrouted or absent expert.
"""
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro_torch.kernels.ref import (FFN_BLOCK_M, ffn_block_tiles,
                                     moe_entry_work_list)


@st.composite
def routings(draw):
    E = draw(st.sampled_from([4, 8, 16, 64]))
    k = draw(st.integers(1, min(E, 8)))
    T = draw(st.sampled_from([1, 3, 4, 12, 64, 200]))
    seed = draw(st.integers(0, 2 ** 31 - 1))
    rng = np.random.default_rng(seed)
    ids = np.stack([rng.permutation(E)[:k] for _ in range(T)])
    S = draw(st.integers(1, E + 2))
    table = np.full(E, -1)
    resident = rng.permutation(E)[:draw(st.integers(0, min(S, E)))]
    table[resident] = rng.permutation(S)[:len(resident)]
    if draw(st.booleans()):                     # an entry past the buffer
        table[rng.integers(E)] = S + 1
    n_panels = draw(st.integers(1, 9))
    grid = draw(st.integers(1, 12))
    return ids, table, S, n_panels, grid


def _brute(ids, table, S):
    """{expert: (slot, assignments)} by enumeration."""
    out = {}
    for a, e in enumerate(ids.reshape(-1)):
        e = int(e)
        if 0 <= table[e] < S:
            out.setdefault(e, (int(table[e]), []))[1].append(a)
    return out


@settings(max_examples=150, deadline=None)
@given(routings())
def test_work_list_and_tile_walk_match_brute_force(case):
    ids, table, S, n_panels, grid = case
    T, E = ids.shape[0], len(table)
    work = moe_entry_work_list(torch.as_tensor(ids),
                               torch.as_tensor(table), S)
    want = _brute(ids, table, S)
    assert [e for e, _, _ in work] == sorted(want)          # ascending id
    for e, slot, rows in work:
        assert (slot, rows) == (want[e][0], sorted(want[e][1]))
        assert rows and rows == sorted(set(rows)) and len(rows) <= T
    counts = [0] * E
    for e, _, rows in work:
        counts[e] = len(rows)
    seen = []
    for b in range(grid):
        seen += ffn_block_tiles(counts, E, T, n_panels, b, grid)
    # every listed expert's panels once, each m-tile of its rows once
    assert len(seen) == len(set(seen))
    assert sorted(seen) == sorted(
        (e, p, m) for e, _, rows in work for p in range(n_panels)
        for m in range(0, len(rows), FFN_BLOCK_M))
    assert not {e for e, _, _ in seen} - set(want)


@pytest.mark.parametrize("table", [[-1, -1, -1, -1], [0, -1, 1, 9]])
def test_no_work_for_unrouted_or_absent_experts(table):
    ids = torch.tensor([[1, 3], [3, 1]])         # experts 0 and 2 unrouted
    assert moe_entry_work_list(ids, torch.tensor(table), 2) == []
    assert all(ffn_block_tiles([0] * 4, 4, 2, 5, b, 4) == []
               for b in range(4))
