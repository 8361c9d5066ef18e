"""The port stands alone: no module of it (nor the card's smoke script)
imports JAX or the reference package, and its entry points run on CUDA
unless the caller asks for the CPU."""
import ast
from pathlib import Path

import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.models.transformer import Model
from repro_torch.runtime.engine import SlotBufferEngine
from repro_torch.runtime.serving import ServingEngine

ROOT = Path(__file__).resolve().parents[1]
CFG = get_smoke_config("olmoe-1b-7b")


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro", "flax", "optax")


FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = [n for n in _imports(path) if _forbidden(n)]
    assert not bad, f"{path.name} imports {bad}"


def test_entry_points_need_cuda_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = Model(CFG)
    with pytest.raises(RuntimeError, match="CUDA"):
        model.init()
    params = model.init(device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        SlotBufferEngine(CFG, params, model, n_slots_per_layer=2)
    eng = SlotBufferEngine(CFG, params, model, n_slots_per_layer=2,
                           device="cpu")
    assert eng.device.type == "cpu" and eng.buffer["w_gate"].device.type == "cpu"
    ServingEngine(eng)
