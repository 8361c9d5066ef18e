"""The harness's CPU tests: `python -m pytest portbench/tests` from the
repository's root. Tests that need a GPU carry the `cuda` marker."""
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
for p in (HERE.parent.parent / "src", HERE.parent):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

import torch  # noqa: E402

# the smoke runs are timed windows: keep parallel test workers from
# starving each other of cores
torch.set_num_threads(2)
