"""The check that decides `correct` fails what it must: the harness driven
at smoke size on the CPU (its look for a GPU skipped) with the timed path
broken underneath, and the float8 control in the program's place."""
import subprocess
import sys

import pytest

import run
import smoke
from pbcore import judge
from repro_torch.runtime import serving
from repro_torch.runtime.engine import SlotBufferEngine

MODELS = ["olmoe", "deepseek"]


@pytest.mark.parametrize("model", MODELS)
def test_a_step_that_keeps_its_state_fails(model, monkeypatch):
    step = SlotBufferEngine.decode_step

    def stale(self, tok, state):
        logits, _ = step(self, tok, state)
        return logits, state                  # the state never advances

    monkeypatch.setattr(SlotBufferEngine, "decode_step", stale)
    result, _ = smoke.run_smoke(model)
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("model", MODELS)
def test_a_token_altered_where_it_is_produced_fails(model, monkeypatch):
    sample_rows = serving.sample_rows
    calls = []

    def altered(logits, *a):
        out = sample_rows(logits, *a)
        calls.append(1)
        if 2 <= len(calls) <= 6:              # five steps' tokens
            out = logits.float().argmin(-1).to(out.dtype)
        return out

    monkeypatch.setattr(serving, "sample_rows", altered)
    result, _ = smoke.run_smoke(model)
    assert calls and not result["correct"], result["checks"]


@pytest.mark.parametrize("model", MODELS)
def test_the_float8_control_reads_far_above_the_program(model):
    """The reference through float8 put in the program's place, on the
    tokens a smoke run served, reads at least three times what the
    program does (the cell's limits are set between the two readings at
    the cell's own size, on the card: `calibrate.py` and
    `test_portbench_card.py`)."""
    cell = smoke.cell(model)
    for seed in (2 ** 36 + 17, 2 ** 36 + 18):
        _, served = smoke.run_smoke(seed=seed, c=cell)
        prog = judge.numbers(judge.served_gaps(cell.conf, seed, served,
                                               "cpu"))
        ctl = judge.numbers(judge.control_gaps(cell.conf, seed, served,
                                               "cpu"))
        assert ctl["mean_logit_gap"] >= 3 * prog["mean_logit_gap"], \
            (prog, ctl)


def test_no_result_without_a_gpu(tmp_path):
    out = subprocess.run(
        [sys.executable, str(run.HERE / "run.py"), "--workload",
         "olmoe.decode", "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=run.ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""
