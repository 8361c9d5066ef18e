"""Ingest real checkpoints (safetensors) into the expert shard format.

`core.expert_tiers.export_expert_shards` accepts any
``{moe_layer_index: (w_gate, w_up, w_down)}`` mapping — this module
supplies that mapping *lazily* from HuggingFace-style safetensors files,
so a checkpoint larger than host RAM streams through one MoE layer at a
time: scan every file's key table up front (cheap — safetensors headers
are tiny), then materialize a single layer's expert stack only when the
exporter asks for it. The shard writer handles atomicity, per-record
CRC-32 stamping and exotic dtypes (`checkpoint.serde` raw views), so
ingested weights round-trip bitwise, and the shard directory is the
reference package's for the same files, byte for byte.

The files are read without the `safetensors` package, from the format's
public layout: an 8-byte little-endian header length, a JSON header
mapping each tensor name to its ``dtype``, ``shape`` and ``data_offsets``
(relative to the end of the header), then the raw bytes, read through
``np.memmap``.

Name matching covers the common MoE naming families —

    model.layers.3.mlp.experts.7.gate_proj.weight        (qwen/deepseek)
    model.layers.3.block_sparse_moe.experts.7.w1.weight  (mixtral)

— via one regex; pass ``pattern`` for anything else (it must expose
``layer``/``expert``/``proj`` groups). HF linear weights are stored
``(out_features, in_features)``; the slot-buffer convention is
``w_gate``/``w_up`` as ``(d_model, d_ff)`` and ``w_down`` as
``(d_ff, d_model)``, so ingestion transposes by default.
"""
from __future__ import annotations

import json
import os
import re
from collections.abc import Mapping
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.checkpoint.serde import decode_raw, storage_dtype
from repro_torch.core.expert_tiers import TENSOR_NAMES, export_expert_shards

DEFAULT_PATTERN = re.compile(
    r"(?:^|\.)layers?\.(?P<layer>\d+)\."
    r"(?:mlp|block_sparse_moe|feed_forward|moe)\.experts\."
    r"(?P<expert>\d+)\.(?P<proj>gate_proj|up_proj|down_proj|w1|w3|w2)"
    r"\.weight$")

# projection name -> slot in the (w_gate, w_up, w_down) record
PROJ_SLOT = {"gate_proj": 0, "w1": 0,
             "up_proj": 1, "w3": 1,
             "down_proj": 2, "w2": 2}

# safetensors dtype codes -> the manifest's dtype names
DTYPES = {"F32": "float32", "F16": "float16", "BF16": "bfloat16",
          "F8_E4M3": "float8_e4m3fn"}


def parse_expert_key(name: str,
                     pattern: Optional[re.Pattern] = None,
                     ) -> Optional[Tuple[int, int, int]]:
    """Parse one checkpoint tensor name into ``(layer, expert, slot)``
    (slot indexes `TENSOR_NAMES`), or None for a non-expert tensor."""
    m = (pattern or DEFAULT_PATTERN).search(name)
    if m is None:
        return None
    return (int(m.group("layer")), int(m.group("expert")),
            PROJ_SLOT[m.group("proj")])


class SafetensorsFile:
    """One safetensors file: its header parsed and checked at open, its
    tensors read on request through one read-only memory map."""

    def __init__(self, path: str):
        self.path = str(path)
        size = os.path.getsize(self.path)
        with open(self.path, "rb") as f:
            head = f.read(8)
            if len(head) < 8:
                raise ValueError(f"{self.path}: {size} bytes, too short for "
                                 "a safetensors header length")
            n = int.from_bytes(head, "little")
            if 8 + n > size:
                raise ValueError(f"{self.path}: header of {n} bytes runs "
                                 f"past the end of a {size}-byte file "
                                 "(truncated)")
            try:
                header = json.loads(f.read(n))
            except (json.JSONDecodeError, UnicodeDecodeError) as e:
                raise ValueError(f"{self.path}: corrupt header: {e}") from e
        self._start = 8 + n
        header.pop("__metadata__", None)
        spans = []
        for name, t in header.items():
            if t["dtype"] not in DTYPES:
                raise ValueError(f"{self.path}: tensor {name!r} has dtype "
                                 f"{t['dtype']}, not one of {sorted(DTYPES)}")
            begin, end = (int(v) for v in t["data_offsets"])
            want = (int(np.prod(t["shape"], dtype=np.int64))
                    * storage_dtype(DTYPES[t["dtype"]]).itemsize)
            if not 0 <= begin <= end or end - begin != want:
                raise ValueError(f"{self.path}: tensor {name!r} spans "
                                 f"[{begin}, {end}) but its shape and dtype "
                                 f"need {want} bytes")
            if self._start + end > size:
                raise ValueError(f"{self.path}: tensor {name!r} ends past "
                                 "the end of the file (truncated)")
            spans.append((begin, end, name))
        spans.sort()
        for (_, e0, a), (b1, _, b) in zip(spans, spans[1:]):
            if b1 < e0:
                raise ValueError(f"{self.path}: tensors {a!r} and {b!r} "
                                 "overlap")
        self._header: Dict[str, Dict[str, Any]] = header
        self._mm: Optional[np.memmap] = None

    def keys(self) -> List[str]:
        return list(self._header)

    def get_tensor(self, name: str) -> torch.Tensor:
        """A fresh host tensor of one entry, in its true dtype."""
        t = self._header[name]
        if self._mm is None:
            self._mm = np.memmap(self.path, dtype=np.uint8, mode="r")
        begin, end = (int(v) for v in t["data_offsets"])
        dname = DTYPES[t["dtype"]]
        raw = np.array(self._mm[self._start + begin:self._start + end])
        return decode_raw(raw.view(storage_dtype(dname)),
                          dname).reshape(t["shape"])


class _LazyExpertLayers(Mapping):
    """Read-only mapping ``{dense_moe_layer: (w_gate, w_up, w_down)}``
    that materializes one layer's expert stack per access — the exporter
    walks layers in order, so peak memory is a single MoE layer."""

    def __init__(self, handles: Dict[str, SafetensorsFile],
                 index: Dict[Tuple[int, int, int], Tuple[str, str]],
                 layer_ids: List[int], num_experts: int, transpose: bool):
        self._handles = handles
        self._index = index
        self._layer_ids = layer_ids          # checkpoint layer id per dense
        self._E = num_experts
        self._transpose = transpose

    def __len__(self) -> int:
        return len(self._layer_ids)

    def __iter__(self) -> Iterator[int]:
        return iter(range(len(self._layer_ids)))

    def __getitem__(self, dense: int) -> Tuple[torch.Tensor, ...]:
        ckpt_layer = self._layer_ids[dense]
        out = []
        for slot in range(len(TENSOR_NAMES)):
            ws = []
            for e in range(self._E):
                fname, tname = self._index[(ckpt_layer, e, slot)]
                w = self._handles[fname].get_tensor(tname)
                if self._transpose:
                    w = w.transpose(-1, -2).contiguous()
                ws.append(w)
            out.append(torch.stack(ws))
        return tuple(out)


def scan_safetensors(paths: Sequence[str],
                     pattern: Optional[re.Pattern] = None):
    """Open + index a set of safetensors files. Returns
    ``(handles, index, layer_ids, num_experts)`` where `index` maps
    ``(ckpt_layer, expert, slot) -> (path, tensor_name)`` and
    `layer_ids` is the sorted checkpoint layer ids (densified by
    position into shard layer indices)."""
    handles: Dict[str, SafetensorsFile] = {}
    index: Dict[Tuple[int, int, int], Tuple[str, str]] = {}
    for p in paths:
        f = SafetensorsFile(p)
        handles[p] = f
        for name in f.keys():
            parsed = parse_expert_key(name, pattern)
            if parsed is None:
                continue
            if parsed in index:
                raise ValueError(
                    f"duplicate expert tensor for {parsed}: "
                    f"{index[parsed][1]!r} and {name!r}")
            index[parsed] = (p, name)
    if not index:
        raise ValueError("no expert tensors matched the naming pattern in "
                         f"{list(paths)}")
    layer_ids = sorted({k[0] for k in index})
    experts = sorted({k[1] for k in index})
    if experts != list(range(len(experts))):
        raise ValueError(f"expert ids are not dense 0..E-1: {experts}")
    n_slots = len(TENSOR_NAMES)
    for li in layer_ids:
        for e in experts:
            for slot in range(n_slots):
                if (li, e, slot) not in index:
                    raise ValueError(
                        f"checkpoint layer {li} expert {e} is missing its "
                        f"{TENSOR_NAMES[slot]} projection")
    return handles, index, layer_ids, len(experts)


def ingest_safetensors(paths: Union[str, Sequence[str]], out_dir: str, *,
                       pattern: Optional[re.Pattern] = None,
                       transpose: bool = True) -> str:
    """Stream a safetensors checkpoint's MoE experts into an expert shard
    directory (atomic, CRC-stamped — see `export_expert_shards`). Layer
    ids are densified by sort order into shard layer indices 0..L-1.
    Returns the shard directory path."""
    if isinstance(paths, (str, bytes)):
        paths = [paths]
    handles, index, layer_ids, n_experts = scan_safetensors(paths, pattern)
    layers = _LazyExpertLayers(handles, index, layer_ids, n_experts,
                               transpose)
    return export_expert_shards(layers, out_dir)
