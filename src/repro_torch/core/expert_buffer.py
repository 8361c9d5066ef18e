"""Device-resident expert slot buffer and its host-side expert store.

A bounded number of *slots* hold expert FFN weights in device memory; an
indirection table maps (layer, expert) -> slot. The host-side controller
(`TwoLevelLRU` + prefetcher) owns the replacement policy. `swap_in` writes
one expert into one slot (the pre-fused path's per-expert swap);
`swap_in_many` writes experts into slots with asynchronous host -> device copies straight
from `HostExpertStore`'s pinned per-layer tensors, on a copy stream of the
caller's, ordered after every reader already enqueued on the compute stream.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig

_NAMES = ("w_gate", "w_up", "w_down")


def make_buffer(cfg: ModelConfig, n_slots: int, dtype=torch.bfloat16,
                device="cpu") -> Dict[str, torch.Tensor]:
    m = cfg.moe
    assert m is not None, "slot buffer only applies to MoE configs"
    d, f = cfg.d_model, m.d_expert
    return {
        "w_gate": torch.zeros((n_slots, d, f), dtype=dtype, device=device),
        "w_up": torch.zeros((n_slots, d, f), dtype=dtype, device=device),
        "w_down": torch.zeros((n_slots, f, d), dtype=dtype, device=device),
    }


class HostExpertStore:
    """Every MoE layer's expert weights in host memory, one contiguous
    (E, ...) tensor per projection per layer — page-locked when `pin`, so
    copies from it can run asynchronously. An expert's weights are a
    contiguous slice of its layer's tensors: swap-ins copy from there
    directly, with no staging buffer that a later gather could overwrite
    while a copy is still in flight."""

    def __init__(self, pin: bool = False):
        self.pin = pin
        self._layers: Dict[int, Tuple[torch.Tensor, ...]] = {}

    def add_layer(self, layer: int, w_gate: torch.Tensor, w_up: torch.Tensor,
                  w_down: torch.Tensor) -> None:
        ws = []
        for w in (w_gate, w_up, w_down):
            host = torch.empty(w.shape, dtype=w.dtype, pin_memory=self.pin)
            host.copy_(w)
            ws.append(host)
        self._layers[layer] = tuple(ws)

    def layer(self, layer: int) -> Tuple[torch.Tensor, ...]:
        """(w_gate, w_up, w_down) host tensors of one layer, (E, ...)."""
        return self._layers[layer]

    def expert(self, layer: int, e: int) -> Tuple[torch.Tensor, ...]:
        """One expert's (w_gate, w_up, w_down): views into the layer."""
        return tuple(w[e] for w in self._layers[layer])

    @property
    def nbytes(self) -> int:
        return sum(w.numel() * w.element_size()
                   for ws in self._layers.values() for w in ws)


def swap_in(slots: Dict[str, torch.Tensor], slot_idx: int,
            w_gate: torch.Tensor, w_up: torch.Tensor,
            w_down: torch.Tensor) -> None:
    """Write one expert's weights into slot `slot_idx`, in place, on the
    current stream (after every reader already enqueued there). From a
    pinned host tensor the copy is asynchronous to the host."""
    for name, w in zip(_NAMES, (w_gate, w_up, w_down)):
        slots[name][slot_idx].copy_(w, non_blocking=True)


SwapTiming = Union[float, Tuple[torch.cuda.Event, torch.cuda.Event]]


def swap_in_many(slots: Dict[str, torch.Tensor], slot_idx: Sequence[int],
                 store: HostExpertStore, keys: Sequence[Tuple[int, int]],
                 copy_stream: Optional[torch.cuda.Stream] = None
                 ) -> SwapTiming:
    """Write the weights of (layer, expert) `keys` into `slot_idx`.

    On a CUDA buffer the copies are enqueued on `copy_stream`, after that
    stream waits for everything already enqueued on the current (compute)
    stream — so no FFN dispatched earlier can read a slot while it is being
    overwritten. The caller must make the compute stream wait on the
    returned end event before it reads these slots. Returns the (start, end)
    timing events of the copies. On a CPU buffer the copies run
    synchronously and the seconds they took are returned."""
    assert len(slot_idx) == len(keys) and len(keys) > 0
    dev = slots["w_gate"].device
    if dev.type == "cpu":
        t0 = time.perf_counter()
        _copy(slots, slot_idx, store, keys, non_blocking=False)
        return time.perf_counter() - t0
    compute = torch.cuda.current_stream(dev)
    readers_done = torch.cuda.Event()
    readers_done.record(compute)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with torch.cuda.stream(copy_stream):
        copy_stream.wait_event(readers_done)
        start.record(copy_stream)
        _copy(slots, slot_idx, store, keys, non_blocking=True)
        end.record(copy_stream)
    return start, end


def _copy(slots, slot_idx, store, keys, *, non_blocking: bool) -> None:
    for s, (layer, e) in zip(slot_idx, keys):
        for name, src in zip(_NAMES, store.expert(layer, e)):
            slots[name][s].copy_(src, non_blocking=non_blocking)


class SlotTable:
    """Host-side mirror: (layer, expert) <-> slot assignments."""

    def __init__(self, num_layers: int, num_experts: int, n_slots: int):
        self.L, self.E, self.n_slots = num_layers, num_experts, n_slots
        self.slot_of = -np.ones((num_layers, num_experts), np.int32)
        self.key_of_slot: List[Optional[Tuple[int, int]]] = [None] * n_slots
        self.free: List[int] = list(range(n_slots))

    def assign(self, layer: int, expert: int) -> int:
        """Grab a free slot for (layer, expert). Caller must have evicted."""
        if not self.free:
            raise RuntimeError("no free slots; evict first")
        s = self.free.pop()
        assert self.key_of_slot[s] is None
        self.key_of_slot[s] = (layer, expert)
        self.slot_of[layer, expert] = s
        return s

    def release(self, layer: int, expert: int) -> int:
        s = int(self.slot_of[layer, expert])
        assert s >= 0, "releasing non-resident expert"
        self.slot_of[layer, expert] = -1
        self.key_of_slot[s] = None
        self.free.append(s)
        return s

    def layer_slot_map(self, layer: int) -> np.ndarray:
        """(E,) int32 slot ids for one layer (-1 = not resident)."""
        return self.slot_of[layer].copy()
