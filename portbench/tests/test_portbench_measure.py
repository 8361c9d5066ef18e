"""The metric readers on hand-made timestamps, counters and traces."""
import json

import numpy as np
import pytest

import run
from pbcore import devtrace
from pbcore.measure import RunView
from pbcore.timed import Chunk, DecodeStep, Recording

READ = {n: run.load_module(run.HERE / "metrics" / f"{n}.py").read
        for n in ("output_tok_s", "itl_p95_ms", "setup_s",
                  "occupancy.decode", "replays_per_step",
                  "host_syncs_per_step.decode", "swap_gb_per_token.decode",
                  "mfu.decode")}
CONF = run.load_json(run.ROOT / "portbench/configs/olmoe-1b-7b.slots16.json")


def recording(stall_s: float = 0.0) -> Recording:
    """Two requests decoding together every 0.5 s from t = 10, the window
    (10, 20]; with `stall_s`, one step waits that long."""
    rec = Recording(open_t=10.0, close_t=20.0,
                    stats_open={"swap_bytes": 0, "replays": 0,
                                "host_syncs": 0},
                    stats_last={"swap_bytes": 4e9, "replays": 10,
                                "host_syncs": 20})
    t, times = 10.0, []
    while t < 21:
        times.append(t)
        t += 0.5 + (stall_s if abs(t - 14.0) < 1e-9 else 0.0)
    rec.token_times = {0: list(times), 1: [9.0] + list(times)}
    for a, b in zip(times, times[1:]):
        rec.decode.append(DecodeStep(a, b, [(0, 100), (1, 200)]))
    rec.chunks = [Chunk(9.8, 10.2, 0, 32), Chunk(15.0, 15.4, 32, 20),
                  Chunk(19.9, 20.3, 52, 32)]
    return rec


def test_rates_and_the_tail_on_hand_made_times():
    view = RunView(CONF, recording(), 10.0, 42.0)
    # tokens at 10.5 .. 20.0: 20 a request; 10.0 is the window's edge
    assert view.output_tokens == 40
    assert READ["output_tok_s"](view) == pytest.approx(4.0)
    gaps = [0.5] * 40
    assert READ["itl_p95_ms"](view) == pytest.approx(
        np.percentile(gaps, 95) * 1e3)
    assert READ["setup_s"](view) == 42.0
    assert READ["occupancy.decode"](view) == 2.0
    assert READ["replays_per_step"](view) == pytest.approx(10 / 20)
    assert READ["host_syncs_per_step.decode"](view) == pytest.approx(1.0)
    assert READ["swap_gb_per_token.decode"](view) == pytest.approx(4 / 40)


def test_a_stall_moves_the_rate_and_the_tail():
    calm = RunView(CONF, recording(), 10.0, 1.0)
    stalled = RunView(CONF, recording(stall_s=3.0), 10.0, 1.0)
    assert READ["output_tok_s"](stalled) < READ["output_tok_s"](calm)
    assert READ["output_tok_s"](stalled) == pytest.approx(28 / 10)
    # each request waits 3.5 s once: 2 of 28 gaps
    assert READ["itl_p95_ms"](stalled) == pytest.approx(
        np.percentile([0.5] * 26 + [3.5] * 2, 95) * 1e3)
    assert READ["itl_p95_ms"](calm) == pytest.approx(500.0)


def test_mfu_counts_every_token_of_the_window():
    view = RunView(CONF, recording(), 10.0, 1.0)
    flops = view.window_flops
    from pbcore import model as pbmodel
    per = pbmodel.active_flops_per_token(CONF)
    attn = pbmodel.attention_flops(CONF, 1)
    ctx = [100, 200] * 20 + list(range(1, 53))
    assert flops == pytest.approx(per * len(ctx) + attn * sum(ctx))
    assert 0 < READ["mfu.decode"](view) < 1
    # 2 x (16 layers x 4 x 2048^2 + top-8 experts + router) + the head
    assert per == pytest.approx(2 * (16 * (4 * 2048 * 2048
                                           + 8 * 3 * 2048 * 1024
                                           + 2048 * 64)
                                     + 2048 * 50304), rel=1e-9)


def trace_file(tmp_path):
    """A window of 100 us between the marks at t = 1000 and 1100 (host
    times 5.0 s and 5.0 s + 200 us: the trace's clock runs at half the
    host's rate here): two kernels and an HtoD copy that half overlaps the
    first."""
    ev = [
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaDeviceSynchronize",
         "ts": 1000, "dur": 1},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaDeviceSynchronize",
         "ts": 1100, "dur": 1},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 1006, "dur": 1, "args": {"correlation": 7}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaStreamSynchronize",
         "ts": 1060, "dur": 30},
        {"ph": "X", "cat": "kernel", "name": "k_a", "ts": 1010, "dur": 20,
         "args": {"correlation": 7}},
        {"ph": "X", "cat": "kernel", "name": "k_b", "ts": 1080, "dur": 40,
         "args": {"correlation": 8}},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD (Pinned -> "
         "Device)", "ts": 1020, "dur": 30},
    ]
    p = tmp_path / "trace.json"
    p.write_text(json.dumps({"traceEvents": ev}))
    return str(p)


def test_the_trace_reader(tmp_path):
    us = 1e-6
    f = devtrace.analyse(trace_file(tmp_path), (5.0, 5.0 + 200 * us),
                         host=[(5.0, 5.0 + 180 * us, "decode step")])
    assert f.window_s == pytest.approx(100 * us)
    # kernels 1010-1030 and 1080-1100 (clipped); copy 1020-1050
    assert f.kernel_s == pytest.approx(40 * us)
    assert f.busy_s == pytest.approx(60 * us)
    assert f.stall_s == pytest.approx(20 * us)
    ops = dict(f.device_ops)
    assert ops["k_b"] == pytest.approx(20 * us)
    assert dict(f.launches) == {"k_a": 1, "k_b": 1,
                                "Memcpy HtoD (Pinned -> Device)": 1}
    gaps = dict(f.idle_gaps)
    # 1000-1010 in the decode step; 1050-1080 too, named by its middle,
    # which a sync holds
    assert gaps["decode step: python"] == pytest.approx(10 * us)
    assert gaps["decode step: cudaStreamSynchronize"] == pytest.approx(
        30 * us)
    view = RunView(CONF, recording(), 100 * us, 1.0, trace=f)
    idle = run.load_module(run.HERE / "metrics" / "idle_share.decode.py")
    stall = run.load_module(run.HERE / "metrics" / "stall_share.decode.py")
    assert idle.read(view) == pytest.approx(60.0)
    assert stall.read(view) == pytest.approx(20.0)


def test_interval_arithmetic():
    u = devtrace.union([(0, 2), (1, 3), (5, 6)])
    assert u == [(0, 3), (5, 6)]
    assert devtrace.minus([(0, 10)], u) == [(3, 5), (6, 10)]
    assert devtrace.length(u) == 4
