"""Tiered expert store: disk -> host -> device expert streaming.

The paper's premise is that the expert set no longer fits device memory;
at DeepSeek/Qwen scale it does not fit *host* RAM either. This module adds
the third tier beneath the slot buffer:

- **On-disk expert shards** — one binary file per MoE layer holding
  back-to-back per-expert records ``w_gate | w_up | w_down`` (raw bytes,
  bf16 and f8 stored as raw integer views, see `checkpoint.serde`), plus a
  ``manifest.json`` describing shapes, dtypes and a CRC-32 per record. The
  format is the reference package's, byte for byte.
  `export_expert_shards` writes a directory atomically (temp dir +
  ``os.replace``); `ExpertShardReader` memory-maps each layer file,
  validating sizes up front so a truncated or corrupt shard raises
  `ShardError` instead of serving garbage weights.

- **`HostTierModel`** — the byte-budgeted host staging tier. Pure
  bookkeeping (numpy only): an LRU of host-resident experts with refcount
  pins (an expert assigned to a device slot can never be dropped from
  host), a disk->host promotion queue on its own `TransferLink`
  (bandwidth/latency hooks, so `FaultPlan`'s disk scope composes), and a
  long-horizon popularity-driven disk prefetcher: the disk horizon
  ``S_disk`` is derived from the `StepSizeController`'s layer-time
  estimate and the disk bandwidth — independently of, and clamped above,
  the device horizon S. Its decisions are the reference's, call for call.

- **`TieredExpertStore`** — the model plus the bytes. It keeps the
  `core.expert_buffer.HostExpertStore` contract towards ``swap_in_many``:
  ``expert(layer, e)`` returns views into page-locked host memory, so the
  host->device copies stay asynchronous. The bytes live in a fixed pool of
  host records allocated once (`attach`), in power-of-two blocks so the
  caching host allocator's rounding wastes nothing. A promotion reads its
  record from the shard straight into a free pool record, split into
  chunks on I/O threads; without verification the read runs in the
  background and ``expert`` waits for it, with verification the CRC is
  taken over the pool record before it may land. A record is reused only
  after the last host->device copy from it has completed (`note_copies`).
  Residency must be guaranteed first via ``demand_host`` (blocking,
  records a stall just like a device miss) or the speculative
  ``request_host`` path.

Degradation policy mirrors the device link (`core.faults`): a *demand*
promotion always delivers unless the injected disk fault defeats every
retry — in which case the caller drops the expert's tokens and degrades,
exactly like an exhausted device demand. A dead disk link therefore
degrades, never deadlocks. Demand promotions may transiently overflow the
byte budget when every resident expert is pinned (correctness over
budget); speculative promotions are dropped instead. An injected disk
fault or corruption is a bookkeeping decision drawn from the plan; a real
I/O error or a `ShardError` raises.
"""
from __future__ import annotations

import functools
import json
import os
import pathlib
import shutil
import tempfile
import threading
import time
import zlib
from collections import OrderedDict
from concurrent.futures import Future, ThreadPoolExecutor
from typing import (Any, Callable, Dict, Iterable, List, Mapping, Optional,
                    Tuple)

import numpy as np
import torch

from repro_torch.checkpoint.serde import (decode_raw, dtype_name, encode_raw,
                                          storage_dtype, torch_dtype)
from repro_torch.core.integrity import IntegrityGuard
from repro_torch.core.prefetcher import Prefetcher, TransferLink

Key = Tuple[int, int]                       # (moe_layer_index, expert_id)

SHARD_MANIFEST = "manifest.json"
SHARD_VERSION = 1
TENSOR_NAMES = ("w_gate", "w_up", "w_down")
# host pool blocks: a power of two, so the caching host allocator's
# rounding adds nothing; records sit in them at page-aligned strides
POOL_BLOCK = 1 << 30
PAGE = 4096
# a record's disk read and checksum run on the I/O threads in chunks
READ_CHUNK = 2 << 20
IO_THREADS = 8
# spare pool records a demand batch reads ahead of its promotions
READ_AHEAD = 64


class ShardError(ValueError):
    """An expert shard directory is missing, truncated, or corrupt."""


# ------------------------------------------------------------- CRC-32
def _gf2_times(mat: Tuple[int, ...], vec: int) -> int:
    s, i = 0, 0
    while vec:
        if vec & 1:
            s ^= mat[i]
        vec >>= 1
        i += 1
    return s


def _gf2_compose(a: Tuple[int, ...], b: Tuple[int, ...]) -> Tuple[int, ...]:
    """The operator `a` after `b`."""
    return tuple(_gf2_times(a, v) for v in b)


@functools.lru_cache(maxsize=None)
def _zeros_operator(nbytes: int) -> Tuple[int, ...]:
    """The GF(2) operator that feeds `nbytes` zero bytes through a CRC-32
    register (zlib's ``crc32_combine``, by repeated squaring)."""
    op = tuple([0xEDB88320] + [1 << n for n in range(31)])   # one zero bit
    for _ in range(3):
        op = _gf2_compose(op, op)                            # one byte
    out = tuple(1 << n for n in range(32))                   # identity
    while nbytes:
        if nbytes & 1:
            out = _gf2_compose(op, out)
        nbytes >>= 1
        if nbytes:
            op = _gf2_compose(op, op)
    return out


def crc32_combine(crc1: int, crc2: int, len2: int) -> int:
    """CRC-32 of ``A + B`` from ``crc32(A)``, ``crc32(B)`` and ``len(B)``."""
    return _gf2_times(_zeros_operator(len2), crc1) ^ crc2


def chunked_crc32(crcs: Iterable[Tuple[int, int]]) -> int:
    """CRC-32 of consecutive chunks from their (crc, length) pairs."""
    out = 0
    for crc, n in crcs:
        out = crc32_combine(out, crc, n)
    return out


# ---------------------------------------------------------------- writer
def _layer_map(params: Any) -> Mapping[int, Tuple[Any, Any, Any]]:
    """Accept a `HostExpertStore` or a {layer: (wg, wu, wd)} mapping."""
    layers = getattr(params, "_layers", params)
    if not isinstance(layers, Mapping) or not layers:
        raise ValueError(
            "export_expert_shards wants a HostExpertStore or a non-empty "
            "{moe_layer_index: (w_gate, w_up, w_down)} mapping")
    return layers


def _crc_record(raws: List[np.ndarray], e: int) -> int:
    crc = 0
    for raw in raws:
        crc = zlib.crc32(raw[e].reshape(-1).view(np.uint8), crc)
    return crc


def _write_layer(path: pathlib.Path, raws: List[np.ndarray],
                 drop_cache: bool) -> None:
    """Write a layer's records in order; with `drop_cache`, fsync the file
    and drop it from the page cache."""
    with open(path, "wb") as f:
        for e in range(raws[0].shape[0]):
            for raw in raws:
                f.write(raw[e].reshape(-1).view(np.uint8))
        if drop_cache:
            f.flush()
            os.fsync(f.fileno())
            os.posix_fadvise(f.fileno(), 0, 0, os.POSIX_FADV_DONTNEED)


def export_expert_shards(params: Any, out_dir: str, *,
                         drop_cache: bool = False) -> str:
    """Write per-layer expert shard files + manifest to `out_dir`: the
    reference's format, byte for byte. `params` maps each MoE layer to its
    (w_gate, w_up, w_down) stacks, numpy arrays or CPU tensors; a lazy
    mapping keeps at most two layers in memory: a layer is written in
    order by one thread and checksummed by the I/O threads while the next
    layer is materialized.

    Atomic: everything lands in a temp directory first, then one
    ``os.replace``. `drop_cache` fsyncs each layer file and drops it from
    the page cache, so later reads come from the disk. Returns the final
    directory path."""
    layers = _layer_map(params)
    out = pathlib.Path(out_dir)
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = pathlib.Path(tempfile.mkdtemp(dir=out.parent,
                                        prefix=".tmp_shards_"))
    manifest: Dict[str, Any] = {"version": SHARD_VERSION, "layers": []}
    pending = None                       # (write, crcs, manifest entry)
    with ThreadPoolExecutor(IO_THREADS) as crc_pool, \
            ThreadPoolExecutor(1) as writer:
        for layer in sorted(layers):
            ws = layers[layer]
            if len(ws) != len(TENSOR_NAMES):
                raise ValueError(f"layer {layer}: expected {TENSOR_NAMES}")
            names = [dtype_name(w) for w in ws]
            raws = [encode_raw(w) for w in ws]
            del ws
            n_experts = raws[0].shape[0]
            if any(r.shape[0] != n_experts for r in raws):
                raise ValueError(f"layer {layer}: mismatched expert counts")
            tensors = [{"name": name, "shape": list(raw.shape[1:]),
                        "dtype": dn, "nbytes": int(raw[0].nbytes)}
                       for name, dn, raw in zip(TENSOR_NAMES, names, raws)]
            fname = f"layer_{int(layer):05d}.bin"
            entry = {"layer": int(layer), "file": fname,
                     "num_experts": int(n_experts),
                     "record_nbytes": sum(t["nbytes"] for t in tensors),
                     "crc32": None, "tensors": tensors}
            if pending is not None:
                _finish_layer(manifest, *pending)
            pending = (writer.submit(_write_layer, tmp / fname, raws,
                                     drop_cache),
                       [crc_pool.submit(_crc_record, raws, e)
                        for e in range(n_experts)], entry)
            del raws
        if pending is not None:
            _finish_layer(manifest, *pending)
    (tmp / SHARD_MANIFEST).write_text(json.dumps(manifest))
    if out.exists():
        shutil.rmtree(out)
    os.replace(tmp, out)
    return str(out)


def _finish_layer(manifest: Dict[str, Any], write: Future,
                  crcs: List[Future], entry: Dict[str, Any]) -> None:
    write.result()
    entry["crc32"] = [c.result() for c in crcs]
    manifest["layers"].append(entry)


# ---------------------------------------------------------------- reader
class ExpertShardReader:
    """Memory-mapped reader over an exported shard directory.

    Validates the manifest against the actual file sizes up front
    (`ShardError` on any mismatch) so a truncated download can never be
    served as weights. `read_expert` and `read_layer` return fresh host
    tensors, never mmap-backed views; `read_into` reads a record's bytes
    into a caller's buffer (the tier's pool) with positional reads, safe
    from several threads at once."""

    def __init__(self, store_dir: str):
        self.path = pathlib.Path(store_dir)
        man = self.path / SHARD_MANIFEST
        if not man.is_file():
            raise ShardError(f"no {SHARD_MANIFEST} in {store_dir!r} — "
                             "not an expert shard directory")
        try:
            manifest = json.loads(man.read_text())
        except (json.JSONDecodeError, UnicodeDecodeError) as e:
            raise ShardError(f"corrupt shard manifest {man}: {e}") from e
        if manifest.get("version") != SHARD_VERSION:
            raise ShardError(f"shard version {manifest.get('version')!r} "
                             f"unsupported (want {SHARD_VERSION})")
        self._layers: Dict[int, Dict[str, Any]] = {}
        self._mmaps: Dict[int, np.memmap] = {}
        self._fds: Dict[int, int] = {}
        self._fd_lock = threading.Lock()
        for rec in manifest.get("layers", []):
            f = self.path / rec["file"]
            if not f.is_file():
                raise ShardError(f"shard file missing: {f}")
            off = 0
            for t in rec["tensors"]:
                want = (int(np.prod(t["shape"], dtype=np.int64))
                        * storage_dtype(t["dtype"]).itemsize)
                if want != t["nbytes"]:
                    raise ShardError(
                        f"{f}: tensor {t['name']} claims {t['nbytes']}B "
                        f"but shape/dtype imply {want}B")
                off += want
            if off != rec["record_nbytes"]:
                raise ShardError(f"{f}: record size {rec['record_nbytes']} "
                                 f"!= sum of tensors {off}")
            expect = rec["record_nbytes"] * rec["num_experts"]
            actual = f.stat().st_size
            if actual != expect:
                raise ShardError(f"{f} is {actual} bytes, expected {expect} "
                                 "— truncated or corrupt shard")
            crcs = rec.get("crc32")
            if crcs is not None and len(crcs) != rec["num_experts"]:
                raise ShardError(
                    f"{f}: manifest lists {len(crcs)} checksums for "
                    f"{rec['num_experts']} experts")
            self._layers[int(rec["layer"])] = rec

    def layers(self) -> List[int]:
        return sorted(self._layers)

    def num_experts(self, layer: int) -> int:
        return int(self._layers[layer]["num_experts"])

    def record_nbytes(self, layer: int) -> int:
        return int(self._layers[layer]["record_nbytes"])

    def tensors(self, layer: int) -> List[Dict[str, Any]]:
        """The manifest's tensor entries of one layer's records."""
        return self._layers[layer]["tensors"]

    def has_checksums(self) -> bool:
        """True when every layer record carries per-expert CRC-32s
        (pre-integrity manifests load fine, with verification off)."""
        return all(rec.get("crc32") is not None
                   for rec in self._layers.values())

    def record_crc(self, layer: int, expert: int) -> Optional[int]:
        crcs = self._layers[layer].get("crc32")
        return None if crcs is None else int(crcs[expert])

    def _mmap(self, layer: int) -> np.memmap:
        if layer not in self._mmaps:
            rec = self._layers[layer]
            self._mmaps[layer] = np.memmap(self.path / rec["file"],
                                           dtype=np.uint8, mode="r")
        return self._mmaps[layer]

    def _record(self, layer: int, expert: int) -> Dict[str, Any]:
        rec = self._layers.get(layer)
        if rec is None:
            raise ShardError(f"layer {layer} not present in shard store "
                             f"(have {self.layers()})")
        if not 0 <= expert < rec["num_experts"]:
            raise ShardError(f"expert {expert} out of range "
                             f"[0, {rec['num_experts']}) for layer {layer}")
        return rec

    def _record_span(self, layer: int, expert: int) -> Tuple[np.memmap, int]:
        """Bounds-checked (mmap, record_offset) for one expert record.

        The whole-file size is validated at construction, but the mmap is
        lazy: a file truncated *after* the reader opened maps short. Check
        the record's byte span against the actual mapping at every
        materialization so a mid-record truncation raises `ShardError`
        instead of serving a short read."""
        rec = self._record(layer, expert)
        mm = self._mmap(layer)
        off = expert * rec["record_nbytes"]
        end = off + rec["record_nbytes"]
        if end > mm.size:
            raise ShardError(
                f"{self.path / rec['file']}: record {expert} spans bytes "
                f"[{off}, {end}) but only {mm.size} are mapped — shard "
                "truncated after open")
        return mm, off

    def read_record_bytes(self, layer: int, expert: int) -> np.ndarray:
        """One expert's raw record as a fresh uint8 copy."""
        mm, off = self._record_span(layer, expert)
        n = self._layers[layer]["record_nbytes"]
        return np.array(mm[off:off + n], dtype=np.uint8)

    def views(self, layer: int, buf) -> Tuple[torch.Tensor, ...]:
        """Typed (w_gate, w_up, w_down) tensors sharing the memory of a raw
        record `buf` (a uint8 tensor or array, at least `record_nbytes`
        long)."""
        off, out = 0, []
        for t in self._layers[layer]["tensors"]:
            part = buf[off:off + t["nbytes"]]
            if isinstance(part, torch.Tensor):
                w = part.view(torch_dtype(t["dtype"]))
            else:
                w = decode_raw(part.view(storage_dtype(t["dtype"])),
                               t["dtype"])
            out.append(w.view(t["shape"]))
            off += t["nbytes"]
        return tuple(out)

    def decode_record(self, layer: int,
                      raw: np.ndarray) -> Tuple[torch.Tensor, ...]:
        """Decode a raw uint8 record (from `read_record_bytes`) into the
        per-tensor host tensors `read_expert` would return."""
        rec = self._layers[layer]
        buf = np.ascontiguousarray(raw, dtype=np.uint8)
        if buf.size != rec["record_nbytes"]:
            raise ShardError(f"record buffer is {buf.size}B, expected "
                             f"{rec['record_nbytes']}B")
        return tuple(w.clone() for w in self.views(layer, buf))

    def read_expert(self, layer: int, expert: int) -> Tuple[torch.Tensor, ...]:
        return self.decode_record(layer, self.read_record_bytes(layer,
                                                                expert))

    def read_layer(self, layer: int) -> Tuple[torch.Tensor, ...]:
        """Every expert of one layer as fresh (E, ...) host tensors, the
        records read on the I/O threads."""
        rec = self._record(layer, 0)
        n, size = rec["num_experts"], rec["record_nbytes"]
        recs = np.empty((n, size), np.uint8)
        with ThreadPoolExecutor(IO_THREADS) as ex:
            list(ex.map(lambda e: self.read_into(layer, e, recs[e]),
                        range(n)))
        off, out = 0, []
        for t in rec["tensors"]:
            raw = np.ascontiguousarray(recs[:, off:off + t["nbytes"]])
            raw = raw.view(storage_dtype(t["dtype"]))
            out.append(decode_raw(raw, t["dtype"]).view(n, *t["shape"]))
            off += t["nbytes"]
        return tuple(out)

    def _fd(self, layer: int) -> int:
        with self._fd_lock:
            if layer not in self._fds:
                rec = self._layers[layer]
                self._fds[layer] = os.open(self.path / rec["file"],
                                           os.O_RDONLY)
            return self._fds[layer]

    def read_into(self, layer: int, expert: int, out: np.ndarray,
                  start: int = 0) -> None:
        """Read bytes [start, start + out.size) of one expert's record into
        `out` (a contiguous uint8 array). A short read (the file was
        truncated after it was opened) raises `ShardError`."""
        rec = self._record(layer, expert)
        if start < 0 or start + out.size > rec["record_nbytes"]:
            raise ShardError(f"bytes [{start}, {start + out.size}) lie "
                             f"outside a {rec['record_nbytes']}B record")
        fd = self._fd(layer)
        pos = expert * rec["record_nbytes"] + start
        view, done = memoryview(out).cast("B"), 0
        while done < out.size:
            got = os.preadv(fd, [view[done:]], pos + done)
            if got <= 0:
                raise ShardError(
                    f"{self.path / rec['file']}: record {expert} ends "
                    f"after {start + done} of its {rec['record_nbytes']} "
                    "bytes — shard truncated after open")
            done += got

    def close(self) -> None:
        with self._fd_lock:
            for fd in self._fds.values():
                os.close(fd)
            self._fds.clear()
        self._mmaps.clear()


# ------------------------------------------------------------ tier model
class HostTierModel:
    """Byte-budgeted host staging tier + disk->host promotion accounting.

    Bookkeeping only — `TieredExpertStore` composes it with a shard
    reader that moves the actual bytes on the same events
    (`on_insert`/`on_evict`); a simulator can drive it bare. Times are in
    the owning backend's link clock (the engine's: one unit per MoE
    layer).

    Pin semantics: ``pin(key)`` is a refcount taken when an expert is
    assigned to a device slot (and released on slot eviction). Pinned
    entries are never LRU victims; a demand promotion into a fully-pinned
    tier transiently overflows the budget rather than failing."""

    def __init__(self, num_layers: int, num_experts: int,
                 expert_nbytes: float, host_budget_bytes: float, *,
                 disk_bandwidth: float = 2e9,
                 controller: Optional[Any] = None,
                 disk_horizon_max: int = 64,
                 prefetch: bool = True):
        self.L = int(num_layers)
        self.E = int(num_experts)
        self.expert_nbytes = float(expert_nbytes)
        self.host_budget_bytes = float(host_budget_bytes)
        self.disk_bandwidth = float(disk_bandwidth)
        self.controller = controller
        self.disk_horizon_max = int(disk_horizon_max)
        self.prefetch_enabled = bool(prefetch)
        self.link = TransferLink(bandwidth=self.disk_bandwidth)
        self.pf = Prefetcher(self.link, self.expert_nbytes,
                             cancel_on_forget=True)
        self.retry_max = 0
        self.retry_backoff_s = 0.0
        # host residency: insertion-ordered (oldest first = LRU victim)
        self._resident: "OrderedDict[Key, None]" = OrderedDict()
        self._pins: Dict[Key, int] = {}
        self.host_bytes = 0.0
        # popularity EWMA per (layer, expert): fed by actual routing
        # (note_access / demand) and by predictor output (note_predicted),
        # decayed once per auto_prefetch tick so stale mass fades
        self.popularity = np.zeros((self.L, self.E), np.float64)
        self.pop_decay = 0.98
        self._mean_demand = 1.0          # EWMA distinct experts per layer
        self._n_layer_obs = 0
        # bytes-moved callbacks: TieredExpertStore loads/drops real copies
        self.on_insert: Optional[Callable[[Key], None]] = None
        self.on_evict: Optional[Callable[[Key], None]] = None
        # health counters (mirrored into ServingReport by both backends)
        self.host_hits = 0
        self.host_misses = 0
        self.disk_stall_s = 0.0
        self.promotions = 0
        self.evictions = 0
        self.disk_late_hits = 0          # demanded while already in-flight
        self.n_demand_failures = 0       # promotions defeated by disk faults
        self.dropped_arrivals = 0        # speculative landings with no room
        # integrity: verify/quarantine/re-fetch state (off by default —
        # zero-cost, pre-feature behavior). The verify hooks are backend
        # specific: the real store checksums real bytes, the simulator
        # draws the same outcomes from the fault injector.
        self.guard = IntegrityGuard()
        self.verify_fn: Optional[Callable[[Key], bool]] = None
        self.scrub_fn: Optional[Callable[[Key], bool]] = None
        self._scrub_cursor = 0
        self._scrub_miss_mark = 0

    # ------------------------------------------------------------ faults
    def set_faults(self, injector: Any, retry_max: int = 3,
                   retry_backoff_s: float = 0.0) -> None:
        """Attach the disk scope of a `FaultInjector` (via `disk_view`) to
        the promotion link + retry policy."""
        view = injector.disk_view() if hasattr(injector, "disk_view") \
            else injector
        view.attach_link(self.link)
        self.pf.injector = view
        self.retry_max = int(retry_max)
        self.retry_backoff_s = float(retry_backoff_s)

    # --------------------------------------------------------- integrity
    def configure_integrity(self, mode: str, *, scrub_budget: int = 2,
                            refetch_max: int = 3,
                            verify_fn: Optional[Callable[[Key], bool]] = None,
                            scrub_fn: Optional[Callable[[Key], bool]] = None,
                            ) -> None:
        """Enable promotion verification (and, in ``scrub`` mode, the
        budgeted background scrubber). `verify_fn(key)` checks a freshly
        promoted copy, `scrub_fn(key)` re-checks a host-resident one;
        both return True when the copy is clean."""
        self.guard = IntegrityGuard(mode, scrub_budget=scrub_budget,
                                    refetch_max=refetch_max)
        if verify_fn is not None:
            self.verify_fn = verify_fn
        if scrub_fn is not None:
            self.scrub_fn = scrub_fn

    def _verify(self, key: Key) -> bool:
        return True if self.verify_fn is None else bool(self.verify_fn(key))

    def _verified_delivery(self, key: Key, t_done: float) -> Optional[float]:
        """Verify a completed demand promotion; on corruption, discard
        the copy and re-fetch from disk (bounded by the guard's
        ``refetch_max``). Returns the delivery time of the first clean
        copy, or None once the key is permanently quarantined — the
        caller degrades exactly like an exhausted faulted demand."""
        g = self.guard
        t = t_done
        while not self._verify(key):
            n = g.record_corrupt(key)
            self.pf.forget(key, count_unused=False)
            if n > g.refetch_max:
                g.quarantine(key)
                return None
            t2 = self.pf.demand(key, t, max_retries=self.retry_max,
                                backoff_s=self.retry_backoff_s)
            if t2 is None:               # disk faults ate the re-fetch too
                g.quarantine(key)
                return None
            t = t2
        g.record_clean(key)
        return t

    def scrub_tick(self, now: float) -> int:
        """Budgeted background re-verification of host-resident copies.

        Paced off the controller's stall signal: a tick is skipped
        whenever the tier serviced demand misses (or the shared
        `StepSizeController` has stalls pending) since the last one —
        scrubbing is idle-time work and must never add pressure to a
        pipeline that is already behind. Visits unpinned residents
        round-robin, ``scrub_budget`` verifications per tick, pinning
        each copy only for the duration of its check (pins never leak).
        A corrupt copy is evicted and transparently re-promoted from
        disk; the re-promotion re-verifies on arrival like any other."""
        g = self.guard
        if not g.scrub_enabled or self.scrub_fn is None:
            return 0
        busy = self.host_misses > self._scrub_miss_mark
        self._scrub_miss_mark = self.host_misses
        c = self.controller
        if busy or (c is not None and getattr(c, "stall_counter", 0) > 0):
            return 0
        victims = [k for k in self._resident if self._pins.get(k, 0) == 0]
        if not victims:
            return 0
        self._scrub_cursor %= len(victims)
        scrubbed = 0
        for i in range(min(g.scrub_budget, len(victims))):
            key = victims[(self._scrub_cursor + i) % len(victims)]
            self.pin(key)
            try:
                ok = bool(self.scrub_fn(key))
            finally:
                self.unpin(key)
            g.n_scrubbed += 1
            scrubbed += 1
            if not ok:
                n = g.record_corrupt(key)
                self._evict_one(key)     # drop the rotten copy
                if n > g.refetch_max:
                    g.quarantine(key)
                else:
                    self.pf.prefetch(key, now)   # self-heal: re-promote
        self._scrub_cursor = (self._scrub_cursor + scrubbed) \
            % max(1, len(victims))
        return scrubbed

    # --------------------------------------------------------- residency
    def host_resident(self, key: Key) -> bool:
        return key in self._resident

    def free_bytes(self) -> float:
        return max(0.0, self.host_budget_bytes - self.host_bytes)

    def pin(self, key: Key) -> None:
        self._pins[key] = self._pins.get(key, 0) + 1

    def unpin(self, key: Key) -> None:
        n = self._pins.get(key, 0)
        if n <= 1:
            self._pins.pop(key, None)
        else:
            self._pins[key] = n - 1

    def pinned(self, key: Key) -> bool:
        return self._pins.get(key, 0) > 0

    def _evict_one(self, victim: Key) -> None:
        del self._resident[victim]
        self.host_bytes -= self.expert_nbytes
        self.evictions += 1
        self.pf.forget(victim, count_unused=False)
        if self.on_evict is not None:
            self.on_evict(victim)

    def _land(self, key: Key, demand: bool) -> bool:
        """Book a completed promotion as host-resident, evicting LRU
        unpinned entries to stay inside the budget. Returns False (and
        drops the arrival) only for speculative landings into a
        fully-pinned tier."""
        if key in self._resident:
            self._resident.move_to_end(key)
            return True
        while self.host_bytes + self.expert_nbytes > self.host_budget_bytes:
            victim = next((k for k in self._resident
                           if self._pins.get(k, 0) == 0), None)
            if victim is None:
                if demand:
                    break            # correctness over budget (all pinned)
                self.dropped_arrivals += 1
                self.pf.forget(key, count_unused=False)
                return False
            self._evict_one(victim)
        self._resident[key] = None
        self.host_bytes += self.expert_nbytes
        self.promotions += 1
        if self.on_insert is not None:
            self.on_insert(key)
        return True

    # ----------------------------------------------------------- demand
    def demand(self, key: Key, now: float) -> Optional[Tuple[float, bool]]:
        """Blocking host-residency guarantee for a demanded expert.

        Returns ``(exposed_stall, was_hit)``, or None when injected disk
        faults defeat every retry — the caller degrades (drops the
        expert's tokens) exactly like an exhausted device demand. A host
        miss records a controller stall just like a device miss."""
        # settle promotions that already completed by `now` first: a
        # speculative promotion issued one layer ago must count as the hit
        # it is, not as an in-flight miss
        self.advance(now)
        if self.guard.is_quarantined(key):
            # the disk record itself is bad: no promotion is attempted,
            # no hit is counted — the caller degrades (dead sentinel)
            self.guard.n_quarantine_denials += 1
            return None
        self.note_use(key)
        if key in self._resident:
            self.host_hits += 1
            self._resident.move_to_end(key)
            return 0.0, True
        self.host_misses += 1
        if self.controller is not None:
            self.controller.record_stall()
        if key in self.pf.issued:
            self.disk_late_hits += 1
        t_done = self.pf.demand(key, now, max_retries=self.retry_max,
                                backoff_s=self.retry_backoff_s)
        if t_done is None:
            self.n_demand_failures += 1
            return None
        if self.guard.enabled:
            t_done = self._verified_delivery(key, t_done)
            if t_done is None:
                self.n_demand_failures += 1
                return None
        self._land(key, demand=True)
        stall = max(0.0, t_done - now)
        self.disk_stall_s += stall
        return stall, False

    def request(self, key: Key, now: float) -> bool:
        """Queue a speculative disk->host promotion (device prefetch
        window hitting a host-absent key). Never blocks; refused when the
        tier plus in-flight work already covers the budget. Deliberately
        NOT subject to the popularity floor: these requests carry the
        device predictor's forward-looking signal, and a newly-hot expert
        has no popularity history yet — exactly the case the prefetch
        window exists for."""
        if not self.prefetch_enabled:
            return False
        if self.guard.is_quarantined(key):
            return False
        if key in self._resident or key in self.pf.issued:
            return False
        if self._issue_slots() < 1:
            return False
        self.pf.prefetch(key, now)
        return True

    def advance(self, now: float) -> List[Key]:
        """Land completed promotions up to `now`; returns keys that
        became host-resident. With integrity enabled every speculative
        arrival is verified first: a corrupt copy is discarded and
        re-requested (bounded), a copy that keeps arriving corrupt is
        quarantined — corruption never lands."""
        landed = []
        g = self.guard
        for key in self.pf.advance(now):
            if g.enabled:
                if g.is_quarantined(key):
                    self.pf.forget(key, count_unused=False)
                    continue
                if not self._verify(key):
                    n = g.record_corrupt(key)
                    self.pf.forget(key, count_unused=False)
                    if n > g.refetch_max:
                        g.quarantine(key)
                    else:
                        self.pf.prefetch(key, now)   # self-heal re-fetch
                    continue
                g.record_clean(key)
            if self._land(key, demand=False):
                landed.append(key)
        return landed

    # ------------------------------------------------------- popularity
    def note_use(self, key: Key) -> None:
        li, e = key
        if 0 <= li < self.L and 0 <= e < self.E:
            self.popularity[li, e] += 1.0

    def note_access(self, key: Key) -> None:
        """An expert was actually routed to, whichever tier served it:
        popularity bump + host-LRU touch."""
        if key in self._resident:
            self._resident.move_to_end(key)
        self.note_use(key)

    def note_predicted(self, keys: Iterable[Key]) -> None:
        """Fold predictor output (forest/pregate top-k) into popularity at
        half the weight of an observed use."""
        for li, e in keys:
            if 0 <= li < self.L and 0 <= e < self.E:
                self.popularity[li, e] += 0.5

    def note_layer_demand(self, n: int) -> None:
        """EWMA of distinct experts demanded per layer visit — the n_e
        term of the horizon formula, and the per-layer prefetch quota."""
        if self._n_layer_obs == 0:
            self._mean_demand = float(n)
        else:
            self._mean_demand = 0.8 * self._mean_demand + 0.2 * float(n)
        self._n_layer_obs += 1

    # -------------------------------------------------------- prefetcher
    def disk_horizon(self) -> int:
        """S_disk = n_e * E_bytes / (C_disk * T_layer) — the §3.3 horizon
        with the *disk* link's bandwidth — clamped above the device
        horizon S and below `disk_horizon_max`."""
        c = self.controller
        s_dev = int(getattr(c, "s", 1)) if c is not None else 1
        layer_t = getattr(c, "layer_time_est", 0.0) if c is not None else 0.0
        if layer_t <= 0.0:
            layer_t = 1e-3
        ne = max(self._mean_demand, 1.0)
        s = ne * self.expert_nbytes / max(self.disk_bandwidth * layer_t,
                                          1e-12)
        return int(np.clip(np.ceil(s), s_dev + 1, self.disk_horizon_max))

    def _stage_floor(self) -> float:
        """Thrash guard for speculative promotions: when every landing
        must evict (tier projected full counting in-flight work), a
        candidate must be at least as popular as the coldest unpinned
        resident — a weak prediction never displaces a known-hot entry
        just because the link had issue slots free."""
        full = (self.host_bytes
                + (len(self.pf.issued) + 1) * self.expert_nbytes
                > self.host_budget_bytes)
        if not full:
            return -np.inf
        unpinned = [k for k in self._resident
                    if self._pins.get(k, 0) == 0]
        if not unpinned:
            return -np.inf
        return min(self.popularity[k] for k in unpinned)

    def _issue_slots(self) -> int:
        """How many promotions may be outstanding: the evictable capacity
        (budget minus pinned residents) less what is already in flight.
        Issuing over a *full* tier is deliberate — landings evict LRU
        unpinned entries, which is what streaming means."""
        pinned = sum(1 for k in self._resident if self._pins.get(k, 0) > 0)
        cap = int(self.host_budget_bytes / self.expert_nbytes) - pinned
        return max(0, cap - len(self.pf.issued))

    def auto_prefetch(self, now: float, current_layer: int) -> int:
        """Issue popularity-ranked disk->host promotions for the next
        `disk_horizon()` layers. Returns the number issued."""
        if not self.prefetch_enabled or self.L == 0:
            return 0
        # settle what already completed so the issue-slot accounting sees
        # the real in-flight set, not promotions that landed layers ago
        self.advance(now)
        self.popularity *= self.pop_decay
        slots = self._issue_slots()
        if slots < 1:
            return 0
        pop_floor = self._stage_floor()
        quota = max(1, int(np.ceil(self._mean_demand)))
        # staging deeper than the evictable capacity can HOLD only makes
        # wave d+1's landings evict wave d's not-yet-used stagings: clamp
        # the horizon to the number of whole per-layer quotas that fit
        pinned = sum(1 for k in self._resident if self._pins.get(k, 0) > 0)
        evictable = int(self.host_budget_bytes / self.expert_nbytes) - pinned
        s_disk = min(self.disk_horizon(), max(1, evictable // quota))
        issued = 0
        for d in range(1, s_disk + 1):
            li = (current_layer + d) % self.L
            order = np.argsort(-self.popularity[li], kind="stable")
            n_li = 0
            for e in order:
                if issued >= slots or n_li >= quota:
                    break
                if self.popularity[li, e] <= 0.0:
                    break          # nothing known-popular left here
                if self.popularity[li, e] < pop_floor:
                    break          # colder than every eviction victim
                key = (li, int(e))
                if key in self._resident or key in self.pf.issued:
                    continue
                if self.guard.is_quarantined(key):
                    continue             # permanently dead on disk
                self.pf.prefetch(key, now)
                issued += 1
                n_li += 1
            if issued >= slots:
                break
        return issued

    # ----------------------------------------------------------- stats
    @property
    def n_disk_failures(self) -> int:
        return self.pf.n_failed + self.link.n_failed

    @property
    def n_disk_retries(self) -> int:
        return self.pf.n_retries

    def snapshot(self) -> Dict[str, float]:
        out = dict(host_hits=self.host_hits,
                   host_misses=self.host_misses,
                   disk_stall_s=self.disk_stall_s,
                   promotions=self.promotions,
                   evictions=self.evictions,
                   disk_prefetches=self.pf.n_prefetches,
                   disk_late_hits=self.disk_late_hits,
                   n_disk_failures=self.n_disk_failures,
                   n_disk_retries=self.n_disk_retries,
                   n_demand_failures=self.n_demand_failures,
                   dropped_arrivals=self.dropped_arrivals,
                   host_bytes=self.host_bytes)
        out.update(self.guard.counters())
        return out


# ------------------------------------------------------------ full store
class TieredExpertStore:
    """Disk-backed expert store: `HostTierModel`'s decisions, with the bytes
    in a fixed pool of host records.

    Towards ``swap_in_many`` it keeps the `HostExpertStore` contract:
    ``expert(layer, e)`` returns (w_gate, w_up, w_down) views into the
    pool, and may only be called for host-resident experts — residency is
    the engine's job via ``demand_host``/``request_host``, exactly as
    device-slot residency is guaranteed by ``ensure_resident`` before each
    FFN dispatch. ``gather``/``gather_many`` stack copies, as the
    reference's do.

    The pool holds ``capacity`` records: the budget in records, or the
    pins plus one demand landing past them when the pins outnumber the
    budget (`HostTierModel._land` overflows only when every resident is
    pinned, and the engine pins at most one key per device slot), plus one
    verified copy staged before it lands, plus ``READ_AHEAD`` records a
    demand batch reads ahead of its promotions (`read_ahead`). Running out
    of records is a broken invariant and raises; the pool never grows."""

    def __init__(self, store_dir: str, *,
                 host_budget_bytes: Optional[float] = None,
                 disk_bandwidth: float = 2e9,
                 controller: Optional[Any] = None,
                 disk_horizon_max: int = 64,
                 prefetch: bool = True,
                 verify: str = "off",
                 scrub_budget: int = 2,
                 refetch_max: int = 3):
        self.reader = ExpertShardReader(store_dir)
        layer_ids = self.reader.layers()
        if not layer_ids:
            raise ShardError(f"empty shard store at {store_dir!r}")
        if layer_ids != list(range(len(layer_ids))):
            raise ShardError("MoE layer ids in shard store must be dense "
                             f"0..L-1, got {layer_ids}")
        recs = {self.reader.record_nbytes(li) for li in layer_ids}
        counts = {self.reader.num_experts(li) for li in layer_ids}
        specs = {json.dumps(self.reader.tensors(li)) for li in layer_ids}
        if len(recs) != 1 or len(counts) != 1 or len(specs) != 1:
            raise ShardError("heterogeneous per-layer expert shapes are "
                             "not supported by the host tier")
        self.expert_nbytes = float(recs.pop())
        num_experts = counts.pop()
        self.total_expert_bytes = \
            self.expert_nbytes * num_experts * len(layer_ids)
        if host_budget_bytes is None:
            host_budget_bytes = self.total_expert_bytes
        self.model = HostTierModel(
            len(layer_ids), num_experts, self.expert_nbytes,
            host_budget_bytes, disk_bandwidth=disk_bandwidth,
            controller=controller, disk_horizon_max=disk_horizon_max,
            prefetch=prefetch)
        self.model.on_insert = self._load
        self.model.on_evict = self._drop
        # key -> pool record holding its bytes (host-resident), and the
        # verified copy of a promotion not landed yet
        self._host: Dict[Key, int] = {}
        self._staged: Dict[Key, int] = {}
        # records read ahead of a demand batch's promotions, with their
        # reads (each chunk's CRC when verifying)
        self._ahead: Dict[Key, Tuple[int, List[Future]]] = {}
        # the chaos source (the injector's disk view) that flips bytes
        # before the CRC check, so detection exercises the REAL check
        self._chaos: Optional[Any] = None
        if verify != "off" and not self.reader.has_checksums():
            verify = "off"               # pre-integrity manifest
        self.verify = verify
        if verify != "off":
            self.model.configure_integrity(
                verify, scrub_budget=scrub_budget, refetch_max=refetch_max,
                verify_fn=self._verify_promotion, scrub_fn=self._scrub_host)
        # the host pool (allocated by `attach`, or at first use)
        self.max_pins = 0
        self.pin_memory = False
        self._blocks: List[torch.Tensor] = []
        self._records: List[torch.Tensor] = []
        self._free: List[int] = []
        self._views: Dict[int, Tuple[torch.Tensor, ...]] = {}
        self._reads: Dict[int, List[Future]] = {}    # record -> its reads
        self._copy_end: Dict[int, Any] = {}   # record -> last copy's event
        self._pool: Optional[ThreadPoolExecutor] = None
        self._lock = threading.Lock()
        # bytes read from the shards; summed seconds of the I/O threads'
        # reads and CRCs; host seconds spent waiting for reads
        self.bytes_read = 0
        self.read_s = 0.0
        self.crc_s = 0.0
        self.read_wait_s = 0.0

    # ------------------------------------------------------------ pool
    @property
    def budget_records(self) -> int:
        return int(self.model.host_budget_bytes // self.expert_nbytes)

    @property
    def capacity(self) -> int:
        """Pool records (see the class docstring)."""
        return max(self.budget_records, self.max_pins + 1) + 1 + READ_AHEAD

    @property
    def nbytes(self) -> int:
        """Host bytes the pool holds."""
        return sum(b.numel() for b in self._blocks)

    def attach(self, n_pins: int, pin_memory: bool = False) -> None:
        """Size and allocate the pool for an engine that pins at most
        `n_pins` experts (its device slots), page-locked when
        `pin_memory`. Called once, before the first promotion."""
        if self._records:
            raise RuntimeError("the host pool is already allocated")
        self.max_pins = max(self.max_pins, int(n_pins))
        self.pin_memory = bool(pin_memory)
        self._allocate()

    def _allocate(self) -> None:
        rec = int(self.expert_nbytes)
        stride = -(-rec // PAGE) * PAGE
        per_block = max(1, POOL_BLOCK // stride)
        cap = self.capacity
        for b0 in range(0, cap, per_block):
            n = min(per_block, cap - b0)
            block = torch.empty(n * stride, dtype=torch.uint8,
                                pin_memory=self.pin_memory)
            self._blocks.append(block)
            self._records.extend(block[j * stride:j * stride + rec]
                                 for j in range(n))
        self._free = list(range(cap))[::-1]

    def _acquire(self) -> int:
        if not self._records:
            self._allocate()
        if not self._free:
            raise RuntimeError(
                f"host pool exhausted: all {self.capacity} records in use "
                f"({len(self._host)} resident, {len(self._staged)} staged, "
                f"{len(self._ahead)} read ahead, {self.max_pins} pins "
                "allowed) — a tier invariant broke")
        i = self._free.pop()
        ev = self._copy_end.pop(i, None)
        if ev is not None:
            ev.synchronize()     # a copy from this record may still be queued
        return i

    def _release(self, i: int) -> None:
        self._settle(i, cancel=True)
        self._free.append(i)

    def note_copies(self, keys: Iterable[Key], end_event: Any) -> None:
        """Host->device copies from `keys`' records were enqueued and end at
        `end_event`: none of those records is overwritten before it."""
        for key in keys:
            i = self._host.get(key)
            if i is not None:
                self._copy_end[i] = end_event

    # ------------------------------------------------------------ reads
    def _executor(self) -> ThreadPoolExecutor:
        if self._pool is None:
            self._pool = ThreadPoolExecutor(IO_THREADS,
                                            thread_name_prefix="shard-io")
        return self._pool

    def _read_chunk(self, key: Key, out: np.ndarray, start: int,
                    crc: bool) -> Optional[int]:
        t0 = time.perf_counter()
        self.reader.read_into(key[0], key[1], out, start)
        t1 = time.perf_counter()
        c = zlib.crc32(out) if crc else None
        t2 = time.perf_counter()
        with self._lock:
            self.bytes_read += out.size
            self.read_s += t1 - t0
            self.crc_s += t2 - t1
        return c

    def _crc_chunk(self, out: np.ndarray) -> int:
        t0 = time.perf_counter()
        c = zlib.crc32(out)
        with self._lock:
            self.crc_s += time.perf_counter() - t0
        return c

    def _chunks(self) -> List[Tuple[int, int]]:
        rec = int(self.expert_nbytes)
        return [(lo, min(rec, lo + READ_CHUNK))
                for lo in range(0, rec, READ_CHUNK)]

    def _read(self, key: Key, i: int, crc: bool = False) -> List[Future]:
        """Start reading `key`'s record into pool record `i`, a chunk per
        I/O task (each also checksums its chunk when `crc`)."""
        buf = self._records[i].numpy()
        ex = self._executor()
        return [ex.submit(self._read_chunk, key, buf[lo:hi], lo, crc)
                for lo, hi in self._chunks()]

    def _checksum(self, i: int) -> int:
        buf = self._records[i].numpy()
        ex = self._executor()
        futs = [ex.submit(self._crc_chunk, buf[lo:hi])
                for lo, hi in self._chunks()]
        return chunked_crc32((f.result(), hi - lo)
                             for f, (lo, hi) in zip(futs, self._chunks()))

    def _settle(self, i: int, cancel: bool = False) -> None:
        """Wait for record `i`'s reads (cancelling those not started when
        `cancel`: the record is being dropped). A failed read raises."""
        futs = self._reads.pop(i, None)
        if not futs:
            return
        t0 = time.perf_counter()
        if cancel:
            for f in futs:
                f.cancel()
        for f in futs:
            if not f.cancelled():
                f.result()
        self.read_wait_s += time.perf_counter() - t0

    def read_ahead(self, keys: Iterable[Key]) -> None:
        """Start reading the records of the host-absent `keys` (a demand
        batch about to be promoted, up to ``READ_AHEAD`` of them) into
        spare pool records, so that each promotion then waits for its own
        read only, and a verified one for its own checksum. Decides
        nothing: a record no promotion takes is released at the next
        batch."""
        self._drop_ahead()
        crc = self.verify != "off"
        for key in keys:
            if len(self._ahead) >= READ_AHEAD:
                break
            if key in self._host or key in self._ahead \
                    or self.guard.is_quarantined(key):
                continue
            i = self._acquire()
            self._ahead[key] = (i, self._read(key, i, crc=crc))

    def _drop_ahead(self) -> None:
        for i, futs in self._ahead.values():
            self._reads[i] = futs
            self._release(i)
        self._ahead.clear()

    # tier events -> actual bytes
    def _load(self, key: Key) -> None:
        if key in self._host:
            return
        i = self._staged.pop(key, None)
        if i is None and key in self._ahead:
            i, self._reads[i] = self._ahead.pop(key)
        if i is None:
            i = self._acquire()
            self._reads[i] = self._read(key, i)
        self._host[key] = i

    def _drop(self, key: Key) -> None:
        for held in (self._host, self._staged):
            i = held.pop(key, None)
            if i is not None:
                self._release(i)

    # ------------------------------------------------------- integrity
    @staticmethod
    def _flip_byte(raw: np.ndarray, key: Key, attempt: int = 0) -> int:
        """Deterministic single-byte corruption (chaos injection): any
        flip defeats CRC-32, so the position only needs to be stable.
        Returns the position."""
        li, e = key
        pos = (li * 1315423911 + e * 2654435761 + attempt * 97) % raw.size
        raw[pos] ^= 0x01
        return pos

    def _verify_promotion(self, key: Key) -> bool:
        """Read + checksum a freshly promoted record into a pool record.
        The chaos source may flip real bytes first (on-media rot per key,
        in-transit rot per attempt); the CRC catches every flip. A clean
        record is staged so landing never re-reads the disk; a corrupt one
        is released without landing."""
        li, e = key
        want = self.reader.record_crc(li, e)
        if want is None:
            return True
        # a staged copy still here belongs to an arrival the tier dropped
        for k in list(self._staged):
            self._release(self._staged.pop(k))
        if key in self._ahead:
            i, futs = self._ahead.pop(key)
        else:
            i = self._acquire()
            futs = self._read(key, i, crc=True)
        chunks = self._chunks()
        crcs = [f.result() for f in futs]
        ch = self._chaos
        if ch is not None:
            raw = self._records[i].numpy()
            flips = []
            if getattr(ch, "disk_record_corrupt", lambda k: False)(key):
                flips.append(self._flip_byte(raw, key))
            if getattr(ch, "promotion_corrupt", lambda k: False)(key):
                flips.append(self._flip_byte(raw, key, attempt=1))
            for c in {pos // READ_CHUNK for pos in flips}:
                lo, hi = chunks[c]
                crcs[c] = self._crc_chunk(raw[lo:hi])
        crc = chunked_crc32((c, hi - lo) for c, (lo, hi) in zip(crcs, chunks))
        if crc != want:
            self._release(i)
            return False
        self._staged[key] = i
        return True

    def _scrub_host(self, key: Key) -> bool:
        """Re-checksum a host-resident copy in place (background scrub).
        The chaos source models in-RAM rot by flipping a real byte of the
        resident w_gate, which the CRC then detects."""
        li, e = key
        want = self.reader.record_crc(li, e)
        i = self._host.get(key)
        if want is None or i is None:
            return True
        self._settle(i)
        ch = self._chaos
        if ch is not None and \
                getattr(ch, "host_copy_corrupt", lambda k: False)(key):
            ev = self._copy_end.pop(i, None)
            if ev is not None:
                ev.synchronize()   # no queued copy may read the rot
            gate = self.reader.tensors(li)[0]["nbytes"]
            self._flip_byte(self._records[i].numpy()[:gate], key)
        return self._checksum(i) == want

    # ------------------------------------------------- tier delegation
    def host_resident(self, key: Key) -> bool:
        return self.model.host_resident(key)

    def demand_host(self, key: Key, now: float):
        return self.model.demand(key, now)

    def request_host(self, key: Key, now: float) -> bool:
        return self.model.request(key, now)

    def advance(self, now: float) -> List[Key]:
        landed = self.model.advance(now)
        # staged copies whose arrival was dropped (tier fully pinned)
        # were forgotten by the model; release the records too
        for k in list(self._staged):
            self._release(self._staged.pop(k))
        return landed

    def auto_prefetch(self, now: float, current_layer: int) -> int:
        return self.model.auto_prefetch(now, current_layer)

    def scrub_tick(self, now: float) -> int:
        return self.model.scrub_tick(now)

    @property
    def guard(self) -> IntegrityGuard:
        return self.model.guard

    def note_predicted(self, keys: Iterable[Key]) -> None:
        self.model.note_predicted(keys)

    def note_access(self, key: Key) -> None:
        self.model.note_access(key)

    def note_layer_demand(self, n: int) -> None:
        self.model.note_layer_demand(n)

    def pin(self, key: Key) -> None:
        self.model.pin(key)

    def unpin(self, key: Key) -> None:
        self.model.unpin(key)

    def set_faults(self, injector: Any, retry_max: int = 3,
                   retry_backoff_s: float = 0.0) -> None:
        self.model.set_faults(injector, retry_max=retry_max,
                              retry_backoff_s=retry_backoff_s)
        # the corrupt scope flips real bytes inside the verify hooks
        self._chaos = injector.disk_view() \
            if hasattr(injector, "disk_view") else injector

    def snapshot(self) -> Dict[str, float]:
        return self.model.snapshot()

    def io_stats(self) -> Dict[str, float]:
        """Bytes read from the shards, the I/O threads' summed read and
        CRC seconds, and the host's seconds waiting on reads."""
        return dict(bytes_read=self.bytes_read, read_s=self.read_s,
                    crc_s=self.crc_s, read_wait_s=self.read_wait_s)

    def close(self) -> None:
        """Finish every read, stop the I/O threads, close the shard files
        and free the pool."""
        self._drop_ahead()
        for i in list(self._reads):
            self._settle(i)
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None
        self.reader.close()
        for ev in self._copy_end.values():
            ev.synchronize()
        self._copy_end.clear()
        self._views.clear()
        self._records.clear()
        self._blocks.clear()
        self._free.clear()
        self._host.clear()
        self._staged.clear()

    # ------------------------------------- HostExpertStore contract
    def _resident_record(self, key: Key) -> int:
        i = self._host.get(key)
        if i is None:
            raise RuntimeError(
                f"expert {key} is not staged in the host tier — "
                "demand_host/request_host must guarantee residency before "
                "gather (this is a scheduling bug, not a data error)")
        self._settle(i)
        return i

    def expert(self, layer: int, e: int) -> Tuple[torch.Tensor, ...]:
        """One host-resident expert's (w_gate, w_up, w_down): views into
        its pool record (page-locked when the pool is)."""
        i = self._resident_record((layer, int(e)))
        if i not in self._views:
            self._views[i] = self.reader.views(0, self._records[i])
        return self._views[i]

    def gather(self, layer: int, experts) -> Tuple[torch.Tensor, ...]:
        ws = [self.expert(layer, int(e)) for e in experts]
        return tuple(torch.stack([w[t] for w in ws]) for t in range(3))

    def gather_many(self, keys: List[Key]) -> Tuple[torch.Tensor, ...]:
        assert keys, "gather_many needs at least one key"
        ws = [self.expert(li, int(e)) for li, e in keys]
        return tuple(torch.stack([w[t] for w in ws]) for t in range(3))
