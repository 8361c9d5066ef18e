"""The port's serving CLI (`launch/serve.py`) on the CPU, in process.

`main([..., "--device", "cpu"])` on both backends with 2-3 requests: each
returns, prints the reference's lines, and emits a `ServingReport` whose
keys equal the other backend's and the reference's (the twin of the
reference's `test_serving_report_key_parity_across_backends`). The sim
backend's policy rows equal `simulate_serving` called directly on the
traces, forest and settings the CLI used. The options that reach the
fault, tier and routing layers run too, and the default device is CUDA.
"""
import dataclasses

import pytest
import torch

from repro.core.metrics import ServingReport as JaxServingReport
from repro_torch.core.metrics import ServingReport
from repro_torch.launch import serve
from repro_torch.simulator.serving import simulate_serving

BASE = ["--device", "cpu", "--arch", "olmoe-1b-7b", "--requests", "3",
        "--max-new", "4", "--platform", "h100"]
KEYS = set(JaxServingReport().summary())


@pytest.fixture(scope="module")
def runs():
    return {b: serve.main(BASE + ["--backend", b])
            for b in ("engine", "sim")}


def test_report_keys_equal_across_backends_and_the_reference(runs):
    assert set(ServingReport().summary()) == KEYS
    eng = runs["engine"]["report"].summary()
    assert set(eng) == KEYS
    for rep in runs["sim"]["reports"].values():
        assert set(rep.summary()) == KEYS
    assert eng["n_requests"] == 3 and eng["n_shed"] == 0


def test_engine_backend_serves_every_request_on_the_cpu(runs):
    res = runs["engine"]
    sb, rep = res["engine"], res["report"]
    assert sb.device.type == "cpu" and not sb.use_kernel
    assert sb.prefetch_enabled and not sb.use_superkernel
    assert all(m.n_tokens >= 2 for m in rep.requests)
    assert sb.stats.steps > 0


def test_sim_rows_equal_simulate_serving_on_the_clis_traces(runs):
    res = runs["sim"]
    assert list(res["reports"]) == ["baseline", "pregate_s2", "promoe_s2",
                                    "expertflow"]
    assert res["forest"].trained and res["mse"] >= 0.0
    for pol in res["policies"]:
        direct = simulate_serving(res["workload"], res["sim"], res["hw"],
                                  pol, forest=res["forest"], cfg=res["cfg"])
        got = res["reports"][pol.name]
        assert direct.summary() == got.summary()
        assert [dataclasses.asdict(m) for m in direct.requests] == \
            [dataclasses.asdict(m) for m in got.requests]
    assert res["hw"].name == "h100"
    wl = res["workload"]
    assert len(wl.requests) == 3 and wl.num_moe_layers == 2


def test_cli_prints_the_reference_lines(capsys):
    serve.main(BASE + ["--backend", "sim", "--requests", "2",
                       "--route-bias", "1.0", "--fault-plan", "flaky",
                       "--host-budget-mb", "1", "--verify", "promote"])
    out = capsys.readouterr().out
    for head in ("capacity plan (olmoe-1b-7b on h100):",
                 "collected 2 request traces", "forest trained on",
                 "host tier: budget_frac=", "platform=h100",
                 "expertflow_rb1", "health: link_failures=",
                 "tier: host_hits=", "integrity: corrupt_detected="):
        assert head in out, head


def test_engine_backend_through_the_disk_tier(tmp_path, capsys):
    res = serve.main(BASE + ["--backend", "engine", "--requests", "2",
                             "--expert-store-dir", str(tmp_path / "shards"),
                             "--host-budget-mb", "2", "--verify", "promote",
                             "--fault-plan", "flaky", "--prefill-chunk",
                             "0"])
    out = capsys.readouterr().out
    assert "exported expert shards to" in out
    assert "tier: host_hits=" in out and "health: link_failures=" in out
    assert "prefill_chunk=mono" in out
    s = res["report"].summary()
    assert set(s) == KEYS and s["n_host_misses"] > 0
    assert res["engine"].tiers is not None


def test_arguments_are_checked_and_cuda_is_the_default(monkeypatch):
    with pytest.raises(SystemExit):
        serve.main(["--requests", "0"])
    with pytest.raises(SystemExit):
        serve.main(["--max-new", "1"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--arch", "olmoe-1b-7b", "--requests", "1",
                    "--max-new", "2"])
