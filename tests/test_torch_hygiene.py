"""The port stands alone: no module of it (nor the card's smoke script)
imports JAX or the reference package, nor any third-party package but
torch and numpy (the card's machine has no other: no `ml_dtypes`, no
`safetensors`), and its entry points run on CUDA unless the caller asks
for the CPU."""
import ast
import sys
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


ALLOWED = {"repro_torch", "torch", "numpy"}


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_imports_only_torch_numpy_and_the_standard_library(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    relative = [n.module for n in ast.walk(tree)
                if isinstance(n, ast.ImportFrom) and n.level]
    assert not relative, f"{path.name} has relative imports {relative}"
    bad = sorted({n.split(".")[0] for n in _imports(path)}
                 - ALLOWED - set(sys.stdlib_module_names))
    assert not bad, f"{path.name} imports third-party packages {bad}"


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


REF_MODULES = sorted(p.relative_to(ROOT / "src" / "repro")
                     for p in (ROOT / "src" / "repro").rglob("*.py"))
# reference functions the port does not carry, by module: the HLO-text
# parsers, which have no input without HLO (the port records collectives
# as they run); `launch/hlo.py` names each of them
NOT_PORTED = {Path("launch/hlo.py"): ("_shape_bytes", "_group_size",
                                      "_collective_of_line",
                                      "_split_computations", "_trip_count")}


@pytest.mark.parametrize("rel", REF_MODULES, ids=str)
def test_every_reference_module_has_a_counterpart(rel):
    """The port does all that the JAX package does: each of its modules
    has one of the same path under `src/repro_torch/`."""
    port = ROOT / "src" / "repro_torch" / rel
    assert port.is_file(), f"no counterpart of src/repro/{rel}"
    text = port.read_text()
    for name in NOT_PORTED.get(rel, ()):
        assert name in text, f"{port} does not name {name}, not ported"
