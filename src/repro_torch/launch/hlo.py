"""Collective traffic of a run, for the roofline.

The reference parses the collectives out of compiled HLO text. PyTorch has
no HLO: the port records the collectives as they run instead. `record()`
is a dispatch mode over the functional collectives
(`torch.ops._c10d_functional`), which every collective of the port goes
through: DTensor's redistributes (the FSDP all-gathers and their
reduce-scatters, the all-reduces of partial sums) and the pipeline's
permute. Inside a fake-tensor mode on a fake process group (the dry run)
nothing moves and the shapes are still the per-device ones.

The kinds and the per-device operand-byte conventions are the
reference's:

  all-reduce          operand == result
  all-to-all          operand == result
  collective-permute  operand == result
  all-gather          operand == result / group_size
  reduce-scatter      operand == result * group_size

and each collective is recorded from its operand (the local input) alone.
A collective permute is an all-to-all with one peer
(`funcol.permute_tensor`); the caller names it (`as_kind`).

`collective_stats` and `loop_aware_collective_stats` are both kept, and
are equal by construction: the port's layer loop is Python, so every
collective is recorded each time it runs and no loop needs its trip count.
The reference's HLO-text helpers (`_shape_bytes`, `_group_size`,
`_collective_of_line`, `_split_computations`, `_trip_count`) have no input
here and are not ported.
"""
from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils._python_dispatch import TorchDispatchMode

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

# functional collective op -> kind (coalesced variants take lists)
_KIND = {
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}

_LABEL = threading.local()


@dataclass
class CollectiveStats:
    bytes_by_kind: Dict[str, int] = field(default_factory=dict)
    count_by_kind: Dict[str, int] = field(default_factory=dict)

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_kind.values())

    @property
    def total_count(self) -> int:
        return sum(self.count_by_kind.values())

    def merged(self, other: "CollectiveStats") -> "CollectiveStats":
        out = CollectiveStats(dict(self.bytes_by_kind),
                              dict(self.count_by_kind))
        for k in other.bytes_by_kind:
            out.bytes_by_kind[k] = out.bytes_by_kind.get(k, 0) + \
                other.bytes_by_kind[k]
            out.count_by_kind[k] = out.count_by_kind.get(k, 0) + \
                other.count_by_kind.get(k, 0)
        return out


def _nbytes(t) -> int:
    if isinstance(t, (list, tuple)):
        return sum(_nbytes(x) for x in t)
    return t.numel() * t.element_size()


@dataclass
class CollectiveEvent:
    kind: str
    nbytes: int          # per-device operand bytes
    group_size: int


class CollectiveRecorder(TorchDispatchMode):
    """Records every functional collective run inside it (see the module
    docstring); `events` in order."""

    def __init__(self):
        super().__init__()
        self.events: List[CollectiveEvent] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if not all_plain(types):
            # a DTensor op: let the subclass run it with this mode still
            # active, so the collectives of its implicit redistributes
            # (sharding propagation, backward) are recorded too
            return NotImplemented
        self.note(func, args)
        return func(*args, **kwargs)

    def note(self, func, args) -> None:
        """Record func if it is a functional collective."""
        if func.namespace == "_c10d_functional":
            kind = _KIND.get(func._opname)
            if kind is not None:
                if kind == "all-to-all" and getattr(_LABEL, "kind", None):
                    kind = _LABEL.kind
                self.events.append(CollectiveEvent(
                    kind, _nbytes(args[0]), _group_size(args[-1])))


def all_plain(types) -> bool:
    """Whether every tensor type of an op holds its own data (plain or
    fake tensors; not a DTensor)."""
    return all(t is torch.Tensor or issubclass(t, FakeTensor) for t in types)


def _group_size(group_name) -> int:
    try:
        from torch.distributed.distributed_c10d import \
            _resolve_process_group
        return _resolve_process_group(group_name).size()
    except Exception:  # noqa: BLE001 — a size is only informative
        return 0


@contextlib.contextmanager
def record():
    """with record() as rec: ...; then collective_stats(rec)."""
    rec = CollectiveRecorder()
    with rec:
        yield rec


@contextlib.contextmanager
def as_kind(kind: str):
    """Record the all-to-alls run inside as `kind` (a collective permute
    is one all-to-all with a single peer)."""
    assert kind in COLLECTIVES
    prev = getattr(_LABEL, "kind", None)
    _LABEL.kind = kind
    try:
        yield
    finally:
        _LABEL.kind = prev


def collective_stats(rec: CollectiveRecorder) -> CollectiveStats:
    """Per-device operand bytes and counts of every recorded collective."""
    stats = CollectiveStats()
    for ev in rec.events:
        stats.bytes_by_kind[ev.kind] = stats.bytes_by_kind.get(ev.kind, 0) \
            + ev.nbytes
        stats.count_by_kind[ev.kind] = stats.count_by_kind.get(ev.kind, 0) \
            + 1
    return stats


def loop_aware_collective_stats(rec: CollectiveRecorder) -> CollectiveStats:
    """The same as `collective_stats`: every collective of a loop body was
    recorded each time it ran."""
    return collective_stats(rec)


def events_of(rec: CollectiveRecorder,
              kind: Optional[str] = None) -> List[Tuple[int, int]]:
    """(operand bytes, group size) of the recorded events of one kind."""
    return [(e.nbytes, e.group_size) for e in rec.events
            if kind is None or e.kind == kind]
