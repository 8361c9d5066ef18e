"""Production mesh construction.

FUNCTIONS, not module-level constants: importing this module never touches
a device or a process group (the dry run starts its fake group first).
Both build a named `DeviceMesh` over the default process group, which the
caller has started (`torch.distributed.init_process_group`, or `torchrun`).
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh


def _device_type() -> str:
    if dist.get_backend() == "nccl":
        return "cuda"
    return "cpu"


def make_production_mesh(*, multi_pod: bool = False):
    """16x16 single pod (256 ranks) or 2x16x16 multi-pod (512 ranks)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = 512 if multi_pod else 256
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != need:
        raise RuntimeError(
            f"the {'x'.join(map(str, shape))} mesh needs a process group of "
            f"{need} ranks; this one has {world} (start them with torchrun, "
            f"or a fake group of {need} for the dry run)")
    return init_device_mesh(_device_type(), shape, mesh_dim_names=axes)


def make_host_mesh(model_parallel: int = 1):
    """Every rank of the running group (CPU tests, one card): a
    (n // mp, mp) mesh with axes ("data", "model")."""
    n = dist.get_world_size()
    mp = min(model_parallel, n)
    return init_device_mesh(_device_type(), (n // mp, mp),
                            mesh_dim_names=("data", "model"))


def init_local_group(device: str = "cuda") -> None:
    """A one-rank process group in this process (an in-memory store, no
    port): NCCL on the card, gloo on the CPU. For `make_host_mesh` on one
    card or host; a no-op when a group is up already."""
    if dist.is_initialized():
        return
    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                            world_size=1)
