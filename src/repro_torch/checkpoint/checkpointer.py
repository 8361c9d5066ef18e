"""Checkpoint save/restore with an asynchronous writer and retention.

Format (the reference's): one directory per step holding
  - manifest.json   the leaves' keys ("layers/0/attn/wq"), array names,
                    shapes and dtypes in leaf order, the step and extras
  - arrays.npz      the leaves as numpy arrays (bf16 / f8 as raw integer
                    views, `checkpoint.serde`)
Leaves are in the reference's order (dict keys sorted, then list index),
so a nested dict/list tree either package writes, the other reads back
leaf for leaf and bitwise.

Writes go through a temporary directory and an atomic rename; `Checkpointer`
keeps the last `keep` checkpoints and writes on a background thread, after
copying the tree to the host, so the train loop does not wait for the disk.
"""
from __future__ import annotations

import json
import os
import pathlib
import shutil
import tempfile
import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch.distributed.tensor import distribute_tensor

from repro_torch.distributed import sharding as shd
from repro_torch.checkpoint.serde import decode_raw, dtype_name, encode_raw
from repro_torch.tree import leaves_with_paths, tree_map, tree_unflatten


def _host(x) -> Any:
    """A leaf as a host array or CPU tensor of its own (a copy); a DTensor
    whole (gathered from its shards)."""
    if shd.is_dtensor(x):
        x = x.full_tensor()
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True)
    return np.array(x)


def save_checkpoint(path: str, tree: Any, step: int = 0,
                    extra: Optional[Dict] = None) -> str:
    """Write `tree` to `path` (a directory). Returns the final path."""
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = pathlib.Path(tempfile.mkdtemp(dir=path.parent,
                                        prefix=".tmp_ckpt_"))
    arrays = {}
    manifest: Dict[str, Any] = {"step": step, "leaves": [],
                                "extra": extra or {}}
    for i, (key, leaf) in enumerate(leaves_with_paths(tree)):
        leaf = _host(leaf)
        name = f"a{i}"
        arrays[name] = encode_raw(leaf)
        manifest["leaves"].append({"key": key, "name": name,
                                   "shape": list(leaf.shape),
                                   "dtype": dtype_name(leaf)})
    np.savez(tmp / "arrays.npz", **arrays)
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    if path.exists():
        shutil.rmtree(path)
    os.replace(tmp, path)
    return str(path)


def load_checkpoint(path: str, like: Any) -> Tuple[Any, int]:
    """Restore into the structure of `like` (leaf for leaf, shapes must
    match); each leaf takes `like`'s leaf's dtype and device (a DTensor's
    mesh and placements: each rank keeps its shards)."""
    path = pathlib.Path(path)
    manifest = json.loads((path / "manifest.json").read_text())
    with np.load(path / "arrays.npz") as z:
        arrs = [decode_raw(z[rec["name"]], rec["dtype"]).clone()
                for rec in manifest["leaves"]]
    like_leaves = [x for _, x in leaves_with_paths(like)]
    if len(arrs) != len(like_leaves):
        raise ValueError(
            f"checkpoint has {len(arrs)} leaves, target has "
            f"{len(like_leaves)} — structure mismatch")
    out = []
    for arr, ref in zip(arrs, like_leaves):
        if tuple(arr.shape) != tuple(ref.shape):
            raise ValueError(f"shape mismatch {tuple(arr.shape)} vs "
                             f"{tuple(ref.shape)}")
        if shd.is_dtensor(ref):
            out.append(distribute_tensor(
                arr.to(device=ref.device, dtype=ref.dtype), ref.device_mesh,
                ref.placements, src_data_rank=None))
        elif isinstance(ref, torch.Tensor):
            out.append(arr.to(device=ref.device, dtype=ref.dtype))
        else:
            out.append(arr.numpy().astype(np.asarray(ref).dtype))
    return tree_unflatten(like, out), int(manifest["step"])


def _steps(root: pathlib.Path):
    return sorted(int(p.name.split("_")[-1]) for p in root.iterdir()
                  if p.is_dir() and p.name.startswith("step_"))


def latest_step(root: str) -> Optional[int]:
    root_p = pathlib.Path(root)
    if not root_p.exists():
        return None
    steps = _steps(root_p)
    return steps[-1] if steps else None


class Checkpointer:
    """Asynchronous checkpoint manager with retention: `maybe_save` writes
    every `every` steps, keeping the last `keep`."""

    def __init__(self, root: str, keep: int = 3, every: int = 50):
        self.root = pathlib.Path(root)
        self.keep = keep
        self.every = every
        self._thread: Optional[threading.Thread] = None

    def maybe_save(self, step: int, tree: Any, blocking: bool = False) -> bool:
        if step % self.every != 0:
            return False
        self.wait()
        # on the host BEFORE the writer thread takes it: the caller may
        # go on and replace or modify its tensors
        host_tree = tree_map(_host, tree)

        def work():
            save_checkpoint(str(self.root / f"step_{step}"), host_tree, step)
            self._gc()

        if blocking:
            work()
        else:
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()
        return True

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def restore_latest(self, like: Any):
        step = latest_step(str(self.root))
        if step is None:
            return None, None
        return load_checkpoint(str(self.root / f"step_{step}"), like)

    def _gc(self) -> None:
        for s in _steps(self.root)[:-self.keep]:
            shutil.rmtree(self.root / f"step_{s}", ignore_errors=True)
