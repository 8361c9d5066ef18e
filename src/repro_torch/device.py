"""Device selection for the port's entry points."""
from __future__ import annotations

from typing import Union

import torch


def resolve_device(device: Union[str, torch.device] = "cuda") -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for the
    CPU. Asking for CUDA on a machine without it raises instead of quietly
    running on the CPU. "meta" (shapes and dtypes, no data) serves the dry
    run's abstract params."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {dev}")
    return dev
