"""Exotic-dtype raw-view serialization of the expert shard format.

numpy has no bfloat16 or float8 type, and a shard file holds raw bytes:
bf16 and f8 tensors are stored as raw integer views of identical item
width and viewed back on load. The manifest records the ORIGINAL dtype by
its plain name (``"bfloat16"``, ``"float32"``, ``"float8_e4m3fn"``: the
name numpy gives a dtype, never ``str(torch.dtype)``), so shards round-trip
bitwise and read the same whichever package wrote them.
"""
from __future__ import annotations

from typing import Union

import numpy as np
import torch

# dtype name -> (true torch dtype, raw storage dtype of identical item width)
EXOTIC = {"bfloat16": (torch.bfloat16, np.uint16),
          "float8_e4m3fn": (torch.float8_e4m3fn, np.uint8)}
# numpy's unsigned raw dtypes -> the torch integer type of the same width
# that `torch.from_numpy` takes
_TORCH_RAW = {np.dtype(np.uint16): np.int16, np.dtype(np.uint8): np.uint8}

Array = Union[np.ndarray, torch.Tensor]


def dtype_name(x: Array) -> str:
    """The manifest name of an array's dtype: numpy's name for it."""
    if isinstance(x, torch.Tensor):
        return str(x.dtype).removeprefix("torch.")
    return str(x.dtype)


def encode_raw(x: Array) -> np.ndarray:
    """A host array or CPU tensor as a C-contiguous numpy array of its raw
    storage dtype (zero-copy where it already is contiguous). Dtypes numpy
    holds natively pass through as they are."""
    name = dtype_name(x)
    if isinstance(x, torch.Tensor):
        x = x.detach().contiguous()
        if name in EXOTIC:
            raw = np.dtype(EXOTIC[name][1])
            ints = torch.int16 if raw.itemsize == 2 else torch.uint8
            return x.view(ints).numpy().view(raw)
        return x.numpy()
    x = np.ascontiguousarray(x)
    if name in EXOTIC:
        return x.view(EXOTIC[name][1])
    return x


def decode_raw(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    """Undo `encode_raw` given the manifest-recorded dtype name: a tensor
    sharing `arr`'s memory, of the true dtype."""
    if dtype_name in EXOTIC:
        as_int = _TORCH_RAW[arr.dtype]
        return torch.from_numpy(arr.view(as_int)).view(EXOTIC[dtype_name][0])
    return torch.from_numpy(arr)


def storage_dtype(dtype_name: str) -> np.dtype:
    """The on-disk dtype for arrays whose true dtype is `dtype_name`."""
    if dtype_name in EXOTIC:
        return np.dtype(EXOTIC[dtype_name][1])
    return np.dtype(dtype_name)


def torch_dtype(dtype_name: str) -> torch.dtype:
    """The torch dtype a manifest name stands for."""
    if dtype_name in EXOTIC:
        return EXOTIC[dtype_name][0]
    return getattr(torch, dtype_name)
