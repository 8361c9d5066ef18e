"""The manifest, and everything it names found by name under portbench/;
a new cell added from files alone."""
import json
import re
import shutil

import pytest

import run
import smoke

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def test_every_cell_finds_its_files():
    man = smoke.manifest()
    assert [w["name"] for w in man["workloads"]] == ["olmoe.decode"]
    for w in man["workloads"]:
        c = run.Cell(man, w["name"])
        assert c.conf["name"] == w["config"]
        assert c.mix["max_batch"] == 8
        assert c.limits["check"]["min_tokens"] >= 1
        assert {"worst_logit_gap", "mean_logit_gap"} & set(c.limits["check"])
        assert set(c.readers) == {m["name"]
                                  for m in c.end_to_end + c.per_layer}


def test_manifest_keeps_the_contract():
    man = smoke.manifest()
    assert set(man) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    e2e = {m["name"]: m for m in man["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in man[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in man["end_to_end"] + man["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert (smoke.ROOT / "portbench" / "metrics"
                / f"{m['name']}.py").exists()
    for m in man["end_to_end"]:
        assert 0 < m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in man["per_layer"]:
        assert m["moves"] in e2e
    for w in man["workloads"]:
        assert len(w["why"]) <= 200 and w["chips"] == 1
        c = run.Cell(man, w["name"])
        reported = {m["name"] for m in c.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2
        assert c.per_layer
        assert all(m["moves"] in reported for m in c.per_layer)
    for c in man["configs"]:
        assert c["file"].startswith("portbench/")
        assert (smoke.ROOT / c["file"]).exists()


def test_a_cell_added_from_files_alone(tmp_path):
    """A configuration, a mix, a per-layer metric and a cell: new files and
    new manifest entries only; the harness finds and runs them."""
    shutil.copytree(smoke.ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    pb = tmp_path / "portbench"
    (pb / "configs" / "dummy.json").write_text(
        json.dumps(dict(smoke.OLMOE, name="dummy")))
    (pb / "traffic" / "dummy_mix.json").write_text(
        json.dumps(smoke.DECODE_MIX))
    (pb / "metrics" / "dummy_rows.py").write_text(
        "def read(run):\n    return float(len(run.decode))\n")
    (pb / "limits" / "dummy.cell.json").write_text(
        json.dumps({"check": {"worst_logit_gap": 1.0, "min_tokens": 1}}))
    man = smoke.manifest()
    man["configs"].append({"name": "dummy", "source": "https://example.org",
                           "file": "portbench/configs/dummy.json",
                           "reduced": [], "why": "a test"})
    man["workloads"].append({"name": "dummy.cell", "config": "dummy",
                             "traffic": "dummy_mix", "chips": 1,
                             "why": "a test"})
    man["per_layer"].append({"name": "dummy_rows", "unit": "steps",
                             "better": "higher", "source": "host_clock",
                             "layer": "serving scheduler",
                             "moves": "itl_p95_ms",
                             "workloads": ["dummy.cell"]})
    c = run.Cell(man, "dummy.cell", root=tmp_path)
    assert "dummy_rows" in c.readers
    result, _ = smoke.run_smoke(trace=True, c=c)
    assert result["metrics"]["dummy_rows"]["value"] >= 1
    assert result["correct"]


def test_an_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        run.Cell(smoke.manifest(), "no.such.cell")
