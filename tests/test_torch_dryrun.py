"""The dry-run and roofline tools (`launch/hlo.py`, `launch/specs.py`,
`launch/roofline.py`, `launch/dryrun.py`) on the CPU, against the
reference's arithmetic.

- `CollectiveStats` (totals, `merged`) and the recorder's per-device
  operand-byte conventions, the reference's `launch/hlo.py:5-16`, on
  DTensor redistributes over a fake 2x2 group: an all-gather's operand is
  its local input (result / group size), a reduce-scatter's its input
  (result x group size), an all-reduce's its input; a pipeline permute
  recorded as a collective permute.
- `_n_blocks` over a grid of (T_q, S_kv, causal, window), and
  `model_flops`, `analytic_min_bytes` and `cell_skip_reason` on every
  assigned (arch, shape) cell, equal to the reference's.
- `lower_cost` of a matmul is 2mnk, as `FlopCounterMode` counts it.
- olmoe's smoke config over a fake 2x2 mesh, a train, a prefill and a
  decode cell (`dryrun.analyse`): each runs; the components sum to the
  full step's FLOPs within 1 %; the train step records the FSDP
  all-gathers and their reduce-scatters; the report has the reference's
  keys. A skipped cell reports the reference's reason.
"""
import json

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import Partial, Replicate, Shard
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import registry as jreg
from repro.launch import roofline as jrl
from repro_torch.configs import registry as reg
from repro_torch.distributed import sharding as shd
from repro_torch.launch import dryrun, hlo
from repro_torch.launch import roofline as rl
from repro_torch.launch.hlo import CollectiveStats


@pytest.fixture(scope="module")
def mesh22():
    with dryrun.fake_world(4):
        yield init_device_mesh("cpu", (2, 2),
                               mesh_dim_names=("data", "model"))


def test_collective_stats_totals_and_merge():
    a = CollectiveStats({"all-reduce": 10, "all-gather": 4},
                        {"all-reduce": 1, "all-gather": 2})
    b = CollectiveStats({"all-reduce": 5, "reduce-scatter": 8},
                        {"all-reduce": 1, "reduce-scatter": 1})
    m = a.merged(b)
    assert m.bytes_by_kind == {"all-reduce": 15, "all-gather": 4,
                               "reduce-scatter": 8}
    assert m.count_by_kind == {"all-reduce": 2, "all-gather": 2,
                               "reduce-scatter": 1}
    assert (m.total_bytes, m.total_count) == (27, 5)
    assert a.total_bytes == 14 and a.total_count == 3


def test_recorder_operand_bytes(mesh22):
    with FakeTensorMode():
        x = shd.distribute(torch.empty(8, 6), ("data", "model"), mesh22)
        with hlo.record() as rec:
            x.redistribute(mesh22, [Replicate(), Shard(1)])    # all-gather
            p = x.redistribute(mesh22, [Shard(0), Replicate()])
            q = type(p).from_local(p.to_local(), mesh22,
                                   [Shard(0), Partial()])
            q.redistribute(mesh22, [Shard(0), Replicate()])    # all-reduce
            q.redistribute(mesh22, [Shard(0), Shard(1)])   # reduce-scatter
    local = 4 * 3 * 4                       # an (8/2, 6/2) f32 shard
    got = [(e.kind, e.nbytes, e.group_size) for e in rec.events]
    assert got == [("all-gather", local, 2), ("all-gather", local, 2),
                   ("all-reduce", 2 * local, 2),
                   ("reduce-scatter", 2 * local, 2)]
    stats = hlo.collective_stats(rec)
    assert stats.count_by_kind == {"all-gather": 2, "all-reduce": 1,
                                   "reduce-scatter": 1}
    assert hlo.loop_aware_collective_stats(rec) == stats
    with hlo.as_kind("collective-permute"):
        assert hlo._LABEL.kind == "collective-permute"
    assert hlo._LABEL.kind is None


def test_n_blocks_matches_reference():
    for tq in (1, 7, 512, 513, 2048, 4096):
        for skv in (1, 100, 1024, 1025, 4096, 8192):
            for causal in (True, False):
                for window in (0, 256, 1024, 4096):
                    assert rl._n_blocks(tq, skv, causal, window) == \
                        jrl._n_blocks(tq, skv, causal, window), \
                        (tq, skv, causal, window)


def test_cell_arithmetic_matches_reference():
    assert reg.all_cells() == jreg.all_cells()
    for arch, shape in reg.all_cells():
        cfg, jcfg = reg.get_config(arch), jreg.get_config(arch)
        cell, jcell = reg.SHAPES[shape], jreg.SHAPES[shape]
        assert (cell.seq_len, cell.global_batch, cell.kind) == \
            (jcell.seq_len, jcell.global_batch, jcell.kind)
        assert reg.cell_skip_reason(cfg, shape) == \
            jreg.cell_skip_reason(jcfg, shape)
        assert rl.model_flops(cfg, cell) == jrl.model_flops(jcfg, jcell)
        for chips in (256, 512):
            assert rl.analytic_min_bytes(cfg, cell, chips) == \
                jrl.analytic_min_bytes(jcfg, jcell, chips)


def test_lower_cost_of_a_matmul_is_2mnk():
    m, n, k = 24, 40, 56
    a, b = torch.randn(m, k), torch.randn(k, n)
    f, nbytes, coll = rl.lower_cost(torch.matmul, a, b)
    assert f == 2 * m * n * k
    with FlopCounterMode(display=False) as fc:
        torch.matmul(a, b)
    assert f == fc.get_total_flops()
    assert nbytes == 4 * (m * k + k * n + m * n)
    assert coll.total_count == 0


CELLS = [reg.ShapeCell("t", 32, 4, "train"),
         reg.ShapeCell("p", 32, 4, "prefill"),
         reg.ShapeCell("d", 32, 4, "decode")]


@pytest.mark.parametrize("cell", CELLS, ids=lambda c: c.kind)
def test_smoke_cells_on_a_fake_2x2_mesh(mesh22, cell):
    cfg = reg.get_smoke_config("olmoe-1b-7b")
    with FakeTensorMode():
        rep = dryrun.analyse(cfg, cell, mesh22)
    roof = rep["roofline"]
    comp = sum(c["count"] * c["flops"] for c in roof["components"])
    assert rep["raw_flops_per_device"] > 0
    assert comp == pytest.approx(rep["raw_flops_per_device"], rel=0.01)
    assert rep["peak_memory_bytes"] >= rep["argument_bytes"] > 0
    counts = rep["raw_collective_counts"]
    assert counts.get("all-reduce", 0) > 0          # partial sums over model
    if cell.kind == "train":
        assert counts["all-gather"] > 0 and counts["reduce-scatter"] > 0
    assert set(roof) >= {"compute_term_s", "memory_term_s",
                         "memory_term_min_s", "collective_term_s",
                         "dominant", "useful_flops_ratio",
                         "roofline_fraction", "components"}
    json.dumps(rep)


def test_skipped_cell_reports_the_reason():
    rep = dryrun.run_cell("yi-9b", "long_500k", multi_pod=False)
    assert rep["status"] == "skip"
    assert rep["reason"] == jreg.cell_skip_reason(
        jreg.get_config("yi-9b"), "long_500k")
