"""On the card: one short run of each cell at its own size through the
timed path, correct against the reference, and the float8 control on the
same tokens past the cell's limit. Skips without a CUDA device.

    python -m pytest -q -m cuda portbench/tests/test_portbench_card.py
"""
import pytest

import run
from pbcore import judge


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    run.set_cache_dirs()
    return torch.cuda.get_device_name(0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["olmoe.decode"])
def test_a_short_run_and_its_control(card, name):
    cell = run.Cell(run.load_json(run.ROOT / "BENCHMARK.json"), name)
    seed = 2 ** 31 + 4242
    result, served = run.run_cell(cell, seed, 20.0, False)
    assert result["correct"], result["checks"]
    assert result["device"]["kind"] == card
    ctl = judge.verdict(judge.control_gaps(cell.conf, seed, served, "cuda"),
                        cell.limits["check"])
    assert not ctl.correct, ctl.checks()
