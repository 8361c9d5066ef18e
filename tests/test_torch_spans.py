"""The engine's and the server's host spans and measured counters
(`runtime.instrument`): the new `SlotPathStats` times, the span log's tree
and its two exports, per-token timestamps and the per-gap ITL, and the
serve CLI's `--spans`. Served on the olmoe smoke config through the
decode superkernel's plain versions on the CPU, where no copy is
asynchronous (`copy_wait_s` stays 0; the card test measures it)."""
import json
import time

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.launch import serve as serve_cli
from repro_torch.models.transformer import Model
from repro_torch.runtime.engine import SlotBufferEngine
from repro_torch.runtime.instrument import SpanLog, Tracer
from repro_torch.runtime.request import Request
from repro_torch.runtime.serving import EngineServingConfig, ServingEngine

CFG = get_smoke_config("olmoe-1b-7b")
TIMES = ("copy_wait_s", "copy_wait_demand_s", "step_host_s", "pull_s",
         "launch_s", "residency_s")
MEASURED = set(TIMES) | {"copy_s"}


@pytest.fixture(scope="module")
def params():
    return Model(CFG).init(torch.Generator().manual_seed(0), device="cpu")


def _serve(params, log=None):
    """Four greedy requests, two rows at a time, 32-token chunks (two of
    the prompts take two chunks), 3 of 8 experts a layer on the device."""
    eng = SlotBufferEngine(CFG, params, Model(CFG), n_slots_per_layer=3,
                           max_seq=64, use_superkernel=True, device="cpu")
    eng.tracer.log = log
    srv = ServingEngine(eng, EngineServingConfig(max_batch=2,
                                                 admission_cap=False))
    rng = np.random.default_rng(3)
    reqs = [Request(prompt=rng.integers(0, CFG.vocab_size, n,
                                        dtype=np.int32),
                    max_new_tokens=m, request_id=i)
            for i, (n, m) in enumerate([(40, 7), (9, 9), (50, 5), (20, 8)])]
    rep = srv.serve(reqs)
    return eng, srv, reqs, rep


@pytest.fixture(scope="module")
def served(params):
    log = SpanLog()
    eng, srv, reqs, rep = _serve(params, log)
    return eng, srv, reqs, rep, log


def test_new_counters_are_numbers_and_the_parts_fit_the_step(served):
    eng, *_ = served
    snap = eng.stats.snapshot()
    for k in TIMES:
        assert isinstance(snap[k], float), k
    assert snap["copy_wait_s"] == snap["copy_wait_demand_s"] == 0.0
    for k in ("step_host_s", "pull_s", "launch_s", "residency_s"):
        assert snap[k] > 0.0, k
    assert snap["step_host_s"] >= (snap["pull_s"] + snap["launch_s"]
                                   + snap["residency_s"])
    assert eng.stats.replays > 0 and eng.stats.evictions > 0


def test_the_log_changes_no_token_and_no_count(params, served):
    eng_on, _, reqs_on, _, log = served
    eng_off, _, reqs_off, _ = _serve(params)
    assert eng_off.tracer.log is None
    assert [r.output for r in reqs_on] == [r.output for r in reqs_off]
    on, off = eng_on.stats.snapshot(), eng_off.stats.snapshot()
    assert {k: v for k, v in on.items() if k not in MEASURED} == \
        {k: v for k, v in off.items() if k not in MEASURED}
    assert len(log.records) > 100 and log.dropped == 0


def test_leaf_spans_never_overlap_and_cover_each_decode_step(served):
    *_, log = served
    leaves = log.leaf_spans()
    assert all(a < b for a, b, _ in leaves)
    assert all(b1 <= a2 for (_, b1, _), (a2, _, _) in zip(leaves,
                                                         leaves[1:]))
    labels = {n for _, _, n in leaves}
    assert {"decode_step/residency", "decode_step/launch",
            "decode_step/pull", "decode_step/segment",
            "prefill_chunk/launch", "serve.sample"} <= labels
    steps = [r for r in log.records if r[0] == "decode_step"]
    assert steps
    for _, t0, t1, _, _ in steps:
        a, b = t0 * 1e-9, t1 * 1e-9
        inside = sum(min(b, y) - max(a, x) for x, y, _ in leaves
                     if x < b and y > a)
        assert inside == pytest.approx(b - a, rel=1e-9, abs=1e-9)


def test_every_span_lies_in_its_parent_and_decode_names_its_rows(served):
    _, srv, reqs, _, log = served
    recs = log.records
    for name, t0, t1, parent, _ in recs:
        assert t1 is not None and t0 <= t1
        if parent >= 0:
            assert recs[parent][1] <= t0 and t1 <= recs[parent][2], name
    kinds = {r[4].get("kind") for r in recs if r[0] == "residency"}
    assert {"demand", "speculative", "prefetch", "retier", "protect",
            "wait"} <= kinds
    times = {r.request_id: r.token_times_s for r in reqs}
    decodes = [i for i, r in enumerate(recs) if r[0] == "serve.decode"]
    assert decodes
    for i in decodes:
        rows = recs[i][4]["requests"]
        assert rows and len(set(rows)) == len(rows)
        assert [r[0] for r in recs if r[3] == i] == ["decode_step"]
        nxt = next(r for r in recs[i + 1:] if r[3] == recs[i][3])
        assert nxt[0] == "serve.sample" and nxt[4]["requests"] == rows
        # each row was served a token by this step: its time lies between
        # the step's start and the end of its sampling
        lo, hi = recs[i][1] * 1e-9 - srv._t0, nxt[2] * 1e-9 - srv._t0
        for rid in rows:
            assert any(lo <= t <= hi for t in times[rid]), rid
    for r in recs:
        if r[0] == "segment":
            assert {"seg", "replay", "sync"} <= set(r[4])
        if r[0] == "residency" and r[4]["kind"] in ("demand", "prefetch",
                                                    "speculative"):
            assert r[4]["bytes"] == r[4]["experts"] * CFG.expert_bytes()


def test_chrome_events_sit_on_the_wall_clock():
    log = SpanLog()
    tr = Tracer(type("Stats", (), {})())
    tr.log = log
    time.sleep(0.01)
    wall0 = time.time_ns()
    with tr.span("outer", request=7):
        time.sleep(0.02)
        with tr.span("inner"):
            time.sleep(0.01)
    wall1 = time.time_ns()
    base = wall0 - 5_000_000_000
    outer, inner = log.chrome_events(base)
    assert outer["name"] == "outer" and outer["ph"] == "X"
    assert outer["ts"] == pytest.approx((wall0 - base) / 1e3, abs=1e3)
    assert outer["ts"] + outer["dur"] == pytest.approx((wall1 - base) / 1e3,
                                                       abs=1e3)
    assert outer["dur"] == pytest.approx(3e4, abs=1e4)
    assert outer["args"]["request"] == 7
    assert inner["args"]["parent"] == outer["args"]["span"] == 0
    assert outer["ts"] <= inner["ts"] and (inner["ts"] + inner["dur"]
                                           <= outer["ts"] + outer["dur"])


def test_without_a_log_nothing_is_recorded(params):
    log = SpanLog()
    eng, srv, _, _ = _serve(params, log)
    n = len(log.records)
    assert n > 0
    eng.tracer.log = None
    step_s = eng.stats.step_host_s
    srv.serve([Request(prompt=np.arange(12, dtype=np.int32),
                       max_new_tokens=4, request_id=99)])
    assert len(log.records) == n and log.dropped == 0
    assert eng.stats.step_host_s > step_s      # the counters still count


def test_a_full_log_counts_what_it_drops(params):
    log = SpanLog(capacity=40)
    _serve(params, log)
    assert len(log.records) == 40 and log.dropped > 0
    leaves = log.leaf_spans()
    assert all(b1 <= a2 for (_, b1, _), (a2, _, _) in zip(leaves,
                                                         leaves[1:]))


def test_token_times_and_the_gap_distribution(served):
    _, _, reqs, rep, _ = served
    for r in reqs:
        ts = r.token_times_s
        assert len(ts) == len(r.output) == r.max_new_tokens
        assert ts[0] == r.first_token_s and ts[-1] <= r.finish_s
        assert all(a <= b for a, b in zip(ts, ts[1:]))
    gaps = [b - a for r in reqs
            for a, b in zip(r.token_times_s, r.token_times_s[1:])]
    itl = rep.itl()
    assert itl["p50"] == pytest.approx(np.percentile(gaps, 50))
    assert itl["p95"] == pytest.approx(np.percentile(gaps, 95))
    assert itl["p99"] == pytest.approx(np.percentile(gaps, 99))
    assert itl["mean"] == pytest.approx(np.mean(gaps))
    assert not any(k.startswith("itl") for k in rep.summary())


def test_serve_cli_writes_the_spans(tmp_path, capsys):
    path = tmp_path / "spans.json"
    res = serve_cli.main(["--arch", "olmoe-1b-7b", "--backend", "engine",
                          "--requests", "2", "--max-new", "4",
                          "--device", "cpu", "--spans", str(path)])
    out = capsys.readouterr().out
    assert "itl (every gap): p50=" in out and "spans:" in out
    trace = json.loads(path.read_text())
    events = trace["traceEvents"]
    assert trace["baseTimeNanoseconds"] > 0
    names = {e["name"] for e in events}
    assert {"serve.decode", "decode_step", "launch", "pull",
            "residency"} <= names
    assert all(e["ph"] == "X" and e["ts"] >= 0 for e in events)
    assert res["engine"].tracer.log is not None
