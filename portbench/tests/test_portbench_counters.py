"""The readers of the program's measured waits and host times
(`SlotPathStats.copy_wait_s`, `copy_wait_demand_s`, `step_host_s`,
`pull_s`, `launch_s`, `residency_s`) on hand-made counters, and on the
counters of a program that has none of them."""
import pytest

import run
import smoke
from pbcore.measure import RunView
from pbcore.timed import Recording
from repro_torch.runtime.engine import SlotPathStats

NAMES = ("copy_wait_share.decode", "demand_wait_share.decode",
         "residency_share.decode", "launch_share.decode",
         "host_ctl_share.decode")
READ = {n: run.load_module(run.HERE / "metrics" / f"{n}.py").read
        for n in NAMES}
CONF = run.load_json(run.ROOT / "portbench/configs/olmoe-1b-7b.slots16.json")
# `SlotPathStats`'s fields before the program measured waits and host times
OLD = ("swap_calls", "swap_experts", "swap_bytes", "copy_s", "evictions",
       "prefetched", "prefetch_hits", "late_hits", "demand_misses",
       "host_syncs", "dispatches", "steps", "spec_layers", "replays",
       "link_failures", "retries", "degraded_steps", "host_hits",
       "host_misses", "disk_stall_s")


def view(opened: dict, last: dict, seconds: float = 30.0) -> RunView:
    rec = Recording(open_t=1.0, close_t=1.0 + seconds, stats_open=opened,
                    stats_last=last)
    return RunView(CONF, rec, seconds, 1.0)


def test_each_share_is_its_counters_delta_over_the_window():
    opened = dict(SlotPathStats().snapshot(), copy_s=1.0, copy_wait_s=0.5,
                  copy_wait_demand_s=0.25, step_host_s=2.0, pull_s=1.0,
                  launch_s=0.2, residency_s=0.3)
    last = dict(opened, copy_s=19.0, copy_wait_s=15.5,
                copy_wait_demand_s=6.25, step_host_s=29.0, pull_s=16.0,
                launch_s=3.2, residency_s=4.8)
    v = view(opened, last)
    assert READ["copy_wait_share.decode"](v) == pytest.approx(50.0)
    assert READ["demand_wait_share.decode"](v) == pytest.approx(20.0)
    assert READ["residency_share.decode"](v) == pytest.approx(15.0)
    assert READ["launch_share.decode"](v) == pytest.approx(10.0)
    # (27 - 15 - 3 - 4.5) s of 30
    assert READ["host_ctl_share.decode"](v) == pytest.approx(15.0)


def test_the_program_has_every_counter_the_readers_read():
    fields = set(SlotPathStats().snapshot())
    for k in ("copy_wait_s", "copy_wait_demand_s", "step_host_s", "pull_s",
              "launch_s", "residency_s"):
        assert k in fields and isinstance(SlotPathStats().snapshot()[k],
                                          float)
    assert set(OLD) <= fields


def test_a_program_without_the_counters_gives_none():
    opened = {k: 0.0 for k in OLD}
    last = dict(opened, swap_bytes=4e9, replays=10.0, copy_s=12.0)
    v = view(opened, last)
    for name in NAMES:
        assert READ[name](v) is None, name
    # and a window that never opened has no counters at all
    assert all(READ[n](view({}, {})) is None for n in NAMES)


def test_the_cell_loads_all_five():
    man = smoke.manifest()
    cell = run.Cell(man, "olmoe.decode")
    per_layer = {m["name"]: m for m in cell.per_layer}
    for name in NAMES:
        assert name in cell.readers
        m = per_layer[name]
        assert (m["source"], m["unit"], m["better"]) == (
            "program_counter", "%", "lower")
        assert m["workloads"] == ["olmoe.decode"]
