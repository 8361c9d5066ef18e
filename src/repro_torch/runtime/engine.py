"""Slot-buffer MoE runtime: prefill and batched KV-cached decode with the
experts streamed through a bounded device slot buffer; and `Engine`, the
whole-model engine that collects routing traces for the predictor and the
simulators.

`SlotBufferEngine` keeps every MoE layer's experts in a host store (pinned
on CUDA) and a bounded number of them in the device slot buffer; the
host-side `TwoLevelLRU` + `SlotTable` decide residency. Per MoE layer the
engine runs attention + routing on the device, pulls one small (S+1, E)
mask block to the host at a *sync* layer (the layer's actual needed set and
the pre-gated next-S prediction), swaps missing experts in, fans
speculative swap-ins across layers l+1..l+S, and dispatches the FFN through
the slot buffer. The next S layers run speculatively against the predicted
residency; the next sync verifies them and replays from the first wrong
layer. `StepSizeController` closes the stall/overfetch loop on S.

On CUDA, swap-ins are asynchronous copies on a copy stream of their own:
the copy stream first waits for every FFN already dispatched (they may read
the slots being overwritten), and each FFN waits for the copies into the
slots it reads. Copy times come from CUDA events on the copy stream and
reach the controller's bandwidth estimate once they have completed, read
at the next host sync.

Outputs are bitwise equal to the fully-resident oracle
(`reference_prefill` / `reference_decode_step`), which runs the same
functions over the full expert weights with the identity slot table,
whenever residency is guaranteed (or replayed) before each FFN.

Prompts are ingested whole (`prefill`) or in fixed-width chunks
(`start_prefill` / `prefill_chunk` / `finish_prefill_into`, the serving
loop's default admission): each chunk runs the same per-MoE-layer sync
sequence as a whole prompt, with the chunk's padding rows masked out of
routing demand and the pre-gate.

With a `core.faults.FaultPlan` the engine injects link faults in its host
bookkeeping, as the reference does: each swap-in's outcome is drawn from
the plan before any copy is issued (a failed demand is retried, then left
non-resident, its tokens dropping through the dead slot, and routing
degrades to the residency bias at a floor); the step watchdog collapses
the horizon to 0 while tripped. A real CUDA error is never caught.

Dense (non-MoE) layers, such as DeepSeek-V2's first, take one plain
dispatch each on every path: they route nothing and have no slot map, and
the MoE layer index `li` counts MoE layers only.

`use_superkernel=True` decodes through *segments* instead: one function
call per MoE layer, which also runs the dense layers before it (attention
through `fused_decode_attention` or `fused_mla_decode_attention`, routing
and the expert FFN through `fused_moe_entry`, the needed / pre-gate mask
block, and the logits folded into the last segment, or into one call of
the trailing dense layers after it). Routing happens
inside the call, so every segment runs against the residency it finds;
sync segments pull the accumulated masks, verify, and replay from the
first segment that needed an expert it did not find, with that demand made
resident first.
"""
from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.cache import TwoLevelLRU
from repro_torch.core.cache_aware import residency_logit_bias
from repro_torch.core.expert_buffer import (HostExpertStore, SlotTable,
                                            make_buffer, swap_in,
                                            swap_in_many)
from repro_torch.core.faults import FaultInjector, FaultPlan, StepWatchdog
from repro_torch.core.prefetcher import Prefetcher, TransferLink
from repro_torch.core.step_size import StepSizeController
from repro_torch.core.trace import TraceLog
from repro_torch.device import resolve_device
from repro_torch.models import moe as moe_mod
from repro_torch.models.layers import rms_norm
from repro_torch.models.transformer import (LayerSpec, Model, _norm,
                                            init_layer_cache, layer_decode,
                                            layer_forward, layer_prefill,
                                            layer_prefill_chunk,
                                            split_ffn_params)
from repro_torch.runtime.instrument import Dispatcher, Tracer
from repro_torch.runtime.sampler import sample
from repro_torch.simulator.events import RoutingTrace, StepTrace

_EXPERT_KEYS = ("w_gate", "w_up", "w_down")
# default initial link bandwidth of the virtual-time transfer model and of
# the default controller's estimate (measured copy times replace the latter)
LINK_BANDWIDTH = 64e9


def _needed_mask(ids: torch.Tensor, E: int,
                 active: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(E,) bool union of the expert ids in `ids` (T, k). Rows whose
    `active` entry is False write to a sentinel entry that is sliced off.
    `index_fill_` takes True as a kernel argument: `m[ids] = True` would
    copy it to the device and synchronise the stream."""
    if active is not None:
        ids = torch.where(active[:, None], ids, torch.full_like(ids, E))
    m = torch.zeros(E + 1, dtype=torch.bool, device=ids.device)
    return m.index_fill_(0, ids.reshape(-1).long(), True)[:E]


def _route_ffn_entry(p, cfg: ModelConfig, x: torch.Tensor,
                     active: Optional[torch.Tensor] = None,
                     rbias: Optional[torch.Tensor] = None):
    """FFN entry of a MoE layer: ffn-norm the attention output, flatten,
    route on the device and build the (E,) needed mask (the union over
    `active` rows only, when given). `rbias`: the layer's (E,) residency
    logit bias (§3.4), or None for the unbiased router. Returns (flat,
    RouterOutput, needed)."""
    h2 = rms_norm(x, p["ffn_norm"], cfg.norm_eps)
    flat = h2.reshape(-1, x.shape[-1])
    r = moe_mod.route(p["moe"]["router"], flat, cfg.moe.top_k,
                      cfg.moe.router_norm_topk, logit_bias=rbias)
    return flat, r, _needed_mask(r.expert_ids, cfg.moe.num_experts, active)


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)


def build_host_store(model: Model, params) -> HostExpertStore:
    """Host copies of every MoE layer's experts (unpinned): the store
    `SlotBufferEngine` builds for itself, exposed so that callers can
    `export_expert_shards` it or hand it to a tiered setup."""
    store = HostExpertStore()
    moe_layers = [i for i, s in enumerate(model.specs) if s.is_moe]
    for li, i in enumerate(moe_layers):
        mp = params["layers"][i]["moe"]
        store.add_layer(li, *(mp[k] for k in _EXPERT_KEYS))
    return store


def _require_moe(cfg: ModelConfig, name: str) -> None:
    """The engines serve MoE models only: experts are what they move."""
    if cfg.moe is None:
        raise ValueError(f"{name} serves MoE models only; {cfg.name} has no "
                         "experts (run it through models.Model)")


class Engine:
    """Whole-model engine with routing-trace collection: every weight stays
    resident, each MoE layer runs the plain grouped MoE (`moe_grouped`),
    and `generate` records each MoE layer's router assignments, its mean
    hidden state and, per (step, layer), a `TraceLog` sample. Its traces
    feed the forest predictor (`core.predictor`) and the simulators
    (`simulator.events`, `simulator.serving`). Prefill uses the grouped
    MoE's default capacity, so tokens past an expert's capacity drop, as
    in the reference. Params come from `Model.init` on `generator`
    (default: seeded 0 on the engine's device)."""

    def __init__(self, cfg: ModelConfig,
                 generator: Optional[torch.Generator] = None,
                 max_seq: int = 512, device="cuda"):
        _require_moe(cfg, "Engine")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.model = Model(cfg)
        self.max_seq = max_seq
        if generator is None:
            generator = torch.Generator(self.device)
            generator.manual_seed(0)
        self.params = self.model.init(generator, device=self.device)
        self.specs: List[LayerSpec] = list(self.model.specs)
        self.moe_layer_ids = [i for i, s in enumerate(self.specs) if s.is_moe]

    def routers(self) -> List[np.ndarray]:
        """Every MoE layer's router (d, E), fp32 numpy, for pre-gating."""
        return [self.params["layers"][i]["moe"]["router"].float().cpu()
                .numpy() for i in self.moe_layer_ids]

    @torch.no_grad()
    def _prefill_collect(self, tokens: torch.Tensor):
        cfg, model, params = self.cfg, self.model, self.params
        B, T = tokens.shape
        x = model.embed(params, tokens)
        positions = torch.arange(T, device=self.device)[None, :].expand(B, T)
        routers, hiddens, caches = [], [], []
        for i, spec in enumerate(self.specs):
            sink: list = []
            x, c = layer_prefill(params["layers"][i], cfg, spec, x,
                                 positions, self.max_seq, router_sink=sink)
            caches.append(c)
            if spec.is_moe:
                routers.append((sink[0].expert_ids, sink[0].probs))
                hiddens.append(x.float().mean(dim=(0, 1)))
        return model.logits(params, x[:, -1]), caches, routers, hiddens

    @torch.no_grad()
    def _decode_collect(self, token: torch.Tensor, caches,
                        cache_len: torch.Tensor):
        cfg, model, params = self.cfg, self.model, self.params
        x = model.embed(params, token[:, None])
        routers, hiddens, new_caches = [], [], []
        for i, spec in enumerate(self.specs):
            sink: list = []
            x, c = layer_decode_collect(params["layers"][i], cfg, spec, x,
                                        caches[i], cache_len, sink)
            new_caches.append(c)
            if spec.is_moe:
                routers.append((sink[0].expert_ids, sink[0].probs))
                hiddens.append(x.float().mean(dim=(0, 1)))
        return model.logits(params, x[:, 0]), new_caches, routers, hiddens

    def generate(self, tokens, n_steps: int, temperature: float = 0.0,
                 collect: bool = True, fixed_s_for_log: int = 2,
                 generator: Optional[torch.Generator] = None
                 ) -> Tuple[np.ndarray, RoutingTrace, TraceLog]:
        """tokens: (B, T). Returns (generated (B, n_steps), trace, log).
        Sampled rows draw from `generator` (default: seeded 17 on the
        engine's device)."""
        cfg, m = self.cfg, self.cfg.moe
        tokens_np = np.asarray(tokens, np.int32)
        tokens_t = torch.as_tensor(tokens_np.astype(np.int64),
                                   device=self.device)
        B, T = tokens_np.shape
        if generator is None and temperature > 0.0:
            generator = torch.Generator(self.device)
            generator.manual_seed(17)
        logits, caches, routers, hiddens = self._prefill_collect(tokens_t)

        trace = RoutingTrace(model=cfg.name,
                             num_moe_layers=len(self.moe_layer_ids),
                             num_experts=m.num_experts, top_k=m.top_k,
                             routers=self.routers())
        log = TraceLog()
        token_list = tokens_np.reshape(-1)
        embeds = self.model.embed(self.params, tokens_t).float().cpu() \
            .numpy().reshape(B * T, -1)

        def record_step(step_idx, routers_out, hiddens_out, embeddings=None):
            assigns = [r[0].cpu().numpy().astype(np.int32)
                       for r in routers_out]
            probs = [r[1].cpu().numpy() for r in routers_out]
            hp = torch.stack(hiddens_out).cpu().numpy()
            trace.steps.append(StepTrace(step_idx, token_list, assigns, hp,
                                         embeddings))
            if collect:
                for li, a in enumerate(assigns):
                    actual = sorted({int(e) for e in a.reshape(-1)})
                    # the LAST 64 ids: the window slides with decoding
                    log.add(token_ids=tuple(int(t)
                                            for t in token_list[-64:]),
                            layer_idx=li,
                            predicted_experts=(),
                            actual_experts=tuple(actual),
                            step_size=fixed_s_for_log,
                            request_id=step_idx,
                            pregate_probs=tuple(
                                float(p) for p in probs[li].mean(0)[:64]))

        record_step(0, routers, hiddens, embeds)
        out = []
        cache_len = torch.tensor(T, device=self.device)
        tok = sample(logits, generator, temperature)
        out.append(tok.cpu().numpy().astype(np.int32))
        # decoded tokens extend the recorded context: each step's entries
        # see the ids the model actually conditioned on
        token_list = np.concatenate([token_list, out[-1].reshape(-1)])
        for step in range(1, n_steps):
            logits, caches, routers, hiddens = self._decode_collect(
                tok, caches, cache_len)
            cache_len = cache_len + 1
            record_step(step, routers, hiddens)
            tok = sample(logits, generator, temperature)
            out.append(tok.cpu().numpy().astype(np.int32))
            token_list = np.concatenate([token_list, out[-1].reshape(-1)])
        return np.stack(out, axis=1), trace, log


def layer_decode_collect(p, cfg: ModelConfig, spec: LayerSpec, x, cache,
                         cache_len, sink: list):
    """`layer_decode` that also appends a MoE layer's router output to
    `sink`; its grouped MoE runs at capacity B * top_k (no token drops)."""
    if not spec.is_moe:
        return layer_decode(p, cfg, spec, x, cache, cache_len)
    B = x.shape[0]
    x, new_cache = _attn_only_decode(p, cfg, spec, x, cache, cache_len)
    flat = rms_norm(x, p["ffn_norm"], cfg.norm_eps).reshape(B, -1)
    out, r = moe_mod.moe_grouped(p["moe"], flat, cfg.moe,
                                 capacity=B * cfg.moe.top_k)
    sink.append(r)
    return x + out.reshape(B, 1, -1), new_cache


def _attn_only_decode(p, cfg: ModelConfig, spec: LayerSpec, x, cache,
                      cache_len):
    """The attention half of `layer_decode` (the FFN stripped)."""
    stripped, spec_no_ffn = split_ffn_params(p, spec)
    return layer_decode(stripped, cfg, spec_no_ffn, x, cache, cache_len)


@dataclass
class SlotPathStats:
    """Per-engine counters."""
    swap_calls: int = 0        # batched swap-in dispatches
    swap_experts: int = 0      # experts actually transferred
    swap_bytes: int = 0        # bytes of expert weights transferred
    copy_s: float = 0.0        # measured transfer time of completed swaps
    evictions: int = 0         # experts evicted from the slot buffer
    prefetched: int = 0        # experts transferred ahead of demand
    prefetch_hits: int = 0     # prefetched experts later demanded
    late_hits: int = 0         # prefetch hits the link model says arrived late
    demand_misses: int = 0     # experts swapped in on demand at layer entry
    host_syncs: int = 0        # blocking device->host pulls
    dispatches: int = 0        # engine-issued per-layer function calls
    steps: int = 0             # prefill / decode_step invocations
    spec_layers: int = 0       # MoE layers executed speculatively (no sync)
    replays: int = 0           # speculative windows rolled back on mispredict
    link_failures: int = 0     # injected transfer failures observed
    retries: int = 0           # demand swap-in retry attempts
    degraded_steps: int = 0    # decode steps in degraded mode (resident-only
                               # routing engaged or watchdog tripped)
    host_hits: int = 0         # demanded experts already staged in host tier
    host_misses: int = 0       # demanded experts promoted disk->host first
    disk_stall_s: float = 0.0  # exposed disk-link stall (link-clock units)
    # measured (`runtime.instrument`): device seconds the compute stream
    # waited on expert copies, and the part whose newest awaited copy was
    # a demand copy; host seconds in engine entries (`decode_step`,
    # `prefill_chunk`, ...) and, within them, in `_pull`, in dispatches
    # and in residency work
    copy_wait_s: float = 0.0
    copy_wait_demand_s: float = 0.0
    step_host_s: float = 0.0
    pull_s: float = 0.0
    launch_s: float = 0.0
    residency_s: float = 0.0

    def snapshot(self) -> Dict[str, float]:
        return dataclasses.asdict(self)

    def reset(self) -> None:
        for f in dataclasses.fields(self):
            setattr(self, f.name, type(getattr(self, f.name))())


# chunked prefill: prompt-chunk width (the reference's default)
DEFAULT_PREFILL_CHUNK = 32


@dataclass
class PrefillCursor:
    """Resumable chunked prefill of ONE prompt (`start_prefill`).

    Each `prefill_chunk` call ingests the next `chunk`-wide padded slice of
    `tokens` into the single-row `caches`, which belong to this cursor
    alone and are written in place (KV at absolute positions
    `offset..offset+t`). When the cursor is done, `logits` holds the
    prompt's last-token logits (1, V). `skipped` is the serving
    scheduler's aging count."""
    tokens: np.ndarray           # (T,) int64 prompt
    chunk: int                   # chunk width C
    caches: List[Any]            # per-layer batch-1 caches, filled so far
    offset: int = 0              # tokens already ingested
    logits: Optional[torch.Tensor] = None   # set when done
    skipped: int = 0             # consecutive iterations passed over

    @property
    def done(self) -> bool:
        return self.offset >= len(self.tokens)

    @property
    def remaining(self) -> int:
        return len(self.tokens) - self.offset


@dataclass
class DecodeState:
    """KV caches + position for incremental slot-path decode.

    - single-stream (`prefill`): `cache_len` is a () tensor and `pos` an
      int — every batch row decodes in lockstep at one position;
    - batched serving (`alloc_decode_state` + `prefill_into`): `cache_len`
      is (B,), `pos` its (B,) host mirror and `active` a (B,) host mask of
      occupied rows. Inactive rows still flow through compute but are
      masked out of routing demand, sampling and the max_seq guard.
    Cache tensors are never written in place, so a state stays valid after
    a step is taken from it."""
    caches: List[Any]            # one cache dict per absolute layer
    cache_len: torch.Tensor      # () or (B,) int64: tokens already cached
    pos: Any = 0                 # host mirror of cache_len
    active: Optional[np.ndarray] = None   # (B,) bool; None = single-stream

    @property
    def batched(self) -> bool:
        return self.active is not None


class SlotBufferEngine:
    """MoE forward through the bounded expert slot buffer (see the module
    docstring). `use_kernel=True` runs every MoE FFN of prefill and of the
    unfused decode through the slot-indirect `slot_ffn` kernel; otherwise
    through bf16 per-slot einsums. `use_superkernel=True` decodes through
    the segment-fused path (`fused_decode_attention` + `fused_moe_entry`).
    `route_bias` > 0 turns on §3.4 cache-aware routing of decode
    (`set_route_bias`). `faults` (a `core.faults.FaultPlan`) injects
    transfer failures drawn from the plan, with bounded retries
    (`retry_max`, backoff `retry_backoff_s` doubling), resident-only
    degraded routing (the residency bias at no less than
    `degraded_route_bias` until `degraded_recover_streak` clean demand
    transfers in a row) and a `StepWatchdog` that collapses the
    speculative horizon to 0 while tripped. `store` (a
    `core.expert_tiers.TieredExpertStore`) serves the experts from disk
    shards through its byte-budgeted host tier instead of a pre-staged
    host store; the params' MoE layers then need no experts, and the
    oracles read the shards. `prefetch=False` turns speculation off (the
    no-prefetch baseline: horizon 0, no pre-gate); `link_bandwidth` sets
    the virtual link's rate; a caller's `controller` is used as given.
    `fused=False` keeps the pre-fused `forward` (`_forward_legacy`), the
    benchmark's baseline: eager per-layer compute, host routing and one
    swap-in per missing expert; it has no prefetch, no tiered store and no
    incremental or chunked decode. `device` defaults to CUDA;
    without CUDA the engine raises unless the caller passes
    ``device="cpu"``."""

    def __init__(self, cfg: ModelConfig, params, model: Model,
                 n_slots_per_layer: int, *, use_kernel: bool = False,
                 prefetch: bool = True,
                 link_bandwidth: float = LINK_BANDWIDTH, max_seq: int = 256,
                 step_size: Optional[int] = None,
                 controller: Optional[StepSizeController] = None,
                 pregate_margin: int = 2, use_superkernel: bool = False,
                 route_bias: float = 0.0, route_bias_adaptive: bool = False,
                 faults: Optional[FaultPlan] = None, retry_max: int = 3,
                 retry_backoff_s: float = 1e-3,
                 degraded_route_bias: float = 4.0,
                 degraded_recover_streak: int = 8,
                 watchdog: Optional[StepWatchdog] = None,
                 store: Optional[Any] = None, fused: bool = True,
                 device="cuda"):
        _require_moe(cfg, "SlotBufferEngine")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.model = model
        self.max_seq = max_seq
        self.specs: List[LayerSpec] = list(model.specs)
        self.moe_layer_ids = [i for i, s in enumerate(self.specs) if s.is_moe]
        L, E = len(self.moe_layer_ids), cfg.moe.num_experts
        self.n_slots = n_slots_per_layer * L
        self.table = SlotTable(L, E, self.n_slots)
        self.cache = TwoLevelLRU(self.n_slots)
        self.buffer = make_buffer(cfg, self.n_slots, model.dtype, self.device)
        self.use_kernel = use_kernel
        self.stats = SlotPathStats()
        self.tracer = Tracer(self.stats)
        self._dispatch = Dispatcher(self.tracer)
        self.use_superkernel = use_superkernel
        # speculation belongs to the fused runtime: the pre-fused forward
        # (`fused=False`) swaps in on demand only, as the reference's does
        self.fused = fused
        self.prefetch_enabled = prefetch and fused
        self._sk_segs: Optional[Tuple[List[List[int]], List[int]]] = None
        # experts live in the host store (pinned on CUDA), or in a
        # caller's TieredExpertStore (core.expert_tiers) whose host
        # residency the demand/prefetch paths guarantee first: its params
        # need not carry the experts. Everything else moves to the device
        # once.
        self.tiers = store if hasattr(store, "demand_host") else None
        if store is None:
            self.store = HostExpertStore(pin=self.device.type == "cuda")
        else:
            self.store = store
            if self.tiers is not None:
                assert fused, "tiered expert store requires the fused path"
                tm = self.tiers.model
                assert (tm.L, tm.E) == (L, E), (
                    f"shard store shape ({tm.L},{tm.E}) != model ({L},{E})")
                self.tiers.attach(self.n_slots,
                                  pin_memory=self.device.type == "cuda")
        self._p: List[Dict[str, Any]] = []
        for i, lp in enumerate(params["layers"]):
            lp = dict(lp)
            if self.specs[i].is_moe:
                moe = lp["moe"]
                if store is None:
                    self.store.add_layer(self.moe_layer_ids.index(i),
                                         *(moe[k] for k in _EXPERT_KEYS))
                lp["moe"] = {k: v for k, v in moe.items()
                             if k not in _EXPERT_KEYS}
            self._p.append(_to_device(lp, self.device))
        self.params = {k: params[k].to(self.device)
                       for k in ("embed", "final_norm", "lm_head")
                       if k in params}
        # transfer accounting through the paper's link/prefetcher model
        # (virtual time: one unit per MoE layer dispatch)
        self.link = TransferLink(bandwidth=link_bandwidth)
        self._expert_nbytes = float(cfg.expert_bytes())
        self.prefetcher = Prefetcher(self.link, self._expert_nbytes,
                                     cancel_on_forget=True)
        self._clock = 0.0
        self._prefetch_pending: set = set()
        # speculative-window bookkeeping: layers whose FFN has dispatched but
        # whose routing is not yet verified, and prefetched keys evicted
        # mid-window (key -> link-model readiness at eviction)
        self._window_layers: set = set()
        self._evicted_spec: Dict[Tuple[int, int], bool] = {}
        self._ident_map = torch.arange(E, dtype=torch.int32,
                                       device=self.device)
        self._zero_bias = torch.zeros(E, dtype=torch.float32,
                                      device=self.device)
        # adaptive prefetch horizon: `step_size` pins S; otherwise the
        # controller's stall/overfetch feedback moves it. Only the default
        # controller is seeded with the link's rate and clamped to depth
        self.fixed_s = step_size
        if controller is None:
            controller = StepSizeController()
            controller.bandwidth_est = link_bandwidth
            controller.cfg = dataclasses.replace(
                controller.cfg, s_max=min(controller.cfg.s_max, max(1, L - 1)))
        self.controller = controller
        self.pregate_margin = pregate_margin
        self._router_stack = torch.stack(
            [self._p[i]["moe"]["router"] for i in self.moe_layer_ids])
        # §3.4 cache-aware routing: a bounded residency perturbation of the
        # decode routers (`set_route_bias`); 0 leaves every router call as
        # it is without the feature
        self.route_bias = 0.0
        self.route_bias_adaptive = False
        if route_bias:
            self.set_route_bias(route_bias, adaptive=route_bias_adaptive)
        # graceful degradation under link faults (core.faults): failures
        # drawn from the plan in host bookkeeping, bounded retries, degraded
        # resident-only routing (the residency bias at a floor, so a dead
        # link never deadlocks a step) and a step watchdog. None, or a
        # disabled plan, leaves every call as it is without the feature.
        self.faults: Optional[FaultInjector] = None
        if faults is not None and faults.enabled:
            self.faults = FaultInjector(faults)
            # brownout, jitter and stalls shape the virtual link's timing,
            # so late prefetches feed the controller as a slow link would
            self.faults.attach_link(self.link)
            if watchdog is None:
                watchdog = StepWatchdog()
        self.watchdog = watchdog
        self.retry_max = int(retry_max)
        self.retry_backoff_s = float(retry_backoff_s)
        self.degraded_route_bias = float(degraded_route_bias)
        self.degraded_recover_streak = int(degraded_recover_streak)
        self._degraded = False
        self._fault_ok_streak = 0
        # tiered store: share the adaptive controller (its layer-time /
        # stall signals size the disk horizon S_disk) and the fault plan's
        # disk scope (independent draws from the device link's)
        if self.tiers is not None:
            if self.tiers.model.controller is None:
                self.tiers.model.controller = self.controller
            if self.faults is not None:
                self.tiers.set_faults(self.faults, retry_max=self.retry_max)
        # asynchronous swap-ins (CUDA): the copy stream, the copy-end event
        # each slot's FFN readers must wait on with its copy's (issue
        # number, demand?), and timing events not read yet: the copies'
        # and the compute stream's waits on them
        self._copy_stream = (torch.cuda.Stream(self.device)
                             if self.device.type == "cuda" else None)
        self._slot_ready: Dict[int, Any] = {}
        self._slot_kind: Dict[int, Tuple[int, bool]] = {}
        self._copies_issued = 0
        self._copy_timers: List[Tuple[Any, Any, float]] = []
        self._wait_timers: List[Tuple[Any, Any, bool]] = []
        self._resident: Dict[int, Dict[str, torch.Tensor]] = {}

    # -- per-layer functions -------------------------------------------------
    def _embed(self, tokens: torch.Tensor):
        B, T = tokens.shape
        x = self.model.embed(self.params, tokens)
        positions = torch.arange(T, device=self.device)[None, :].expand(B, T)
        return x, positions

    def _embed_decode(self, tok: torch.Tensor) -> torch.Tensor:
        return self.model.embed(self.params, tok[:, None])

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        return self.model.logits(self.params, x[:, -1])

    def _pre(self, p, spec, x, positions, next_router):
        """Attention + norm + on-device routing (+ next-layer pre-gate):
        returns (x, flat, r, (2, E) needed/predicted masks)."""
        stripped, spec_nf = split_ffn_params(p, spec)
        x = layer_forward(stripped, self.cfg, spec_nf, x, positions)
        flat, r, needed = _route_ffn_entry(p, self.cfg, x)
        pred = torch.zeros_like(needed)
        if next_router is not None:
            rn = moe_mod.route(next_router, flat, self.cfg.moe.top_k,
                               self.cfg.moe.router_norm_topk)
            pred = _needed_mask(rn.expert_ids, self.cfg.moe.num_experts)
        return x, flat, r, torch.stack([needed, pred])

    def _pre_prefill(self, p, spec, x, positions):
        """Prefill half of a MoE layer before its FFN: attention + KV-cache
        population + norm + on-device routing."""
        stripped, spec_nf = split_ffn_params(p, spec)
        x, cache = layer_prefill(stripped, self.cfg, spec_nf, x, positions,
                                 self.max_seq)
        flat, r, needed = _route_ffn_entry(p, self.cfg, x)
        return x, flat, r, needed, cache

    def _embed_chunk(self, tokens: torch.Tensor, offset: int, n_valid: int):
        """Embed one padded (1, C) prompt chunk starting at `offset`.
        Returns (x, positions (1, C) absolute, active (C,) real-row mask)."""
        C = tokens.shape[1]
        x = self.model.embed(self.params, tokens)
        ar = torch.arange(C, device=self.device)
        return x, (offset + ar)[None, :], ar < n_valid

    def _pre_prefill_chunk(self, p, spec, x, positions, cache, offset: int,
                           n_valid: int, active: torch.Tensor):
        """Chunk half of a MoE layer before its FFN: chunk attention
        resuming at `offset` (K/V written into the cursor's cache) + norm +
        on-device routing, with padding rows out of the needed mask."""
        stripped, spec_nf = split_ffn_params(p, spec)
        x, cache = layer_prefill_chunk(stripped, self.cfg, spec_nf, x,
                                       positions, cache, offset, n_valid)
        flat, r, needed = _route_ffn_entry(p, self.cfg, x, active)
        return x, flat, r, needed, cache

    def _logits_at(self, x: torch.Tensor, idx: int) -> torch.Tensor:
        """Logits of row `idx` (a final chunk's last real row)."""
        return self.model.logits(self.params, x[:, idx])

    def _pre_decode(self, p, spec, x, cache, clen, active=None, rbias=None):
        """Decode half before the FFN: O(1) attention against the KV cache
        + cache update + norm + on-device routing (needed mask over
        `active` rows when batched; `rbias` the layer's residency bias, or
        None)."""
        stripped, spec_nf = split_ffn_params(p, spec)
        x, new_cache = layer_decode(stripped, self.cfg, spec_nf, x, cache,
                                    clen)
        flat, r, needed = _route_ffn_entry(p, self.cfg, x, active, rbias)
        return x, flat, r, needed, new_cache

    def _pregate(self, flat, needed, routers, active=None, rbias=None):
        """(n + 1, E) bool: row 0 the layer's needed set, rows 1.. the
        top-(k + margin) predictions of the next n routers on `flat`
        (each with its row of the (n, E) residency bias `rbias`, so the
        prediction agrees with the biased routing its layer will run; None
        for the unbiased routers)."""
        E = self.cfg.moe.num_experts
        k_pred = min(E, self.cfg.moe.top_k + self.pregate_margin)
        rows = [needed]
        for j in range(routers.shape[0]):
            rn = moe_mod.route(routers[j], flat, k_pred,
                               self.cfg.moe.router_norm_topk,
                               logit_bias=None if rbias is None
                               else rbias[j])
            rows.append(_needed_mask(rn.expert_ids, E, active))
        return torch.stack(rows)

    def _ffn(self, p, slot_weights, slot_map, x, flat, r):
        B, T, d = x.shape
        out, _ = moe_mod.moe_slotbuf(
            p["moe"], slot_weights, slot_map, flat, self.cfg.moe,
            capacity=B * T * self.cfg.moe.top_k, router_out=r,
            use_kernel=self.use_kernel)
        return x + out.reshape(B, T, d)

    def _slot_ffn(self, p, slot_map: np.ndarray, x, flat, r):
        """A MoE layer's FFN through the slot buffer, once the compute
        stream has waited for every pending copy into a slot it reads."""
        with self.tracer.span("residency", "residency_s", kind="wait"):
            self._wait_slots(slot_map)
            sm = self._upload(slot_map)
        return self._dispatch(self._ffn, p, self.buffer, sm, x, flat, r)

    def _full_experts(self, li: int) -> Dict[str, torch.Tensor]:
        """All of MoE layer li's experts on the device (the oracle's
        weights), copied from the host store at a layer's first call (on
        the CPU the store's own tensors); `drop_resident_experts` frees
        them. A tiered store's come from its shards through its reader,
        never through the host tier, so the oracle does not depend on the
        tier's residency."""
        if self.tiers is None and self.device.type == "cpu":
            return dict(zip(_EXPERT_KEYS, self.store.layer(li)))
        if li not in self._resident:
            ws = (self.tiers.reader.read_layer(li) if self.tiers is not None
                  else self.store.layer(li))
            self._resident[li] = {k: w.to(self.device)
                                  for k, w in zip(_EXPERT_KEYS, ws)}
        return self._resident[li]

    def drop_resident_experts(self) -> None:
        self._resident = {}

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        """A host array the engine builds (a slot map, a routing bias, the
        active-row mask, a chunk's tokens) onto the device with no host
        wait; every such upload goes through here. On CUDA the array is
        copied into a fresh page-locked block of PyTorch's caching host
        allocator and the copy enqueued on the compute stream; the copy
        records that stream, so the block is not handed out again before
        the copy ends, and the array may change at once. On the CPU it is
        the array itself, as a tensor."""
        t = torch.from_numpy(a)
        if self.device.type == "cpu":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    # -- asynchronous swap-ins -------------------------------------------------
    def _wait_slots(self, slot_map: np.ndarray, fused: bool = False) -> None:
        """Make the compute stream wait for pending copies into the slots
        the next FFN reads: the layer's resident slots and, on the einsum
        path, every slot. `slot_ffn` is given a row count of 0 for a
        non-resident expert, so it never reads the slot its table entry is
        clamped to; `fused_moe_entry` (`fused=True`) routes on the device,
        so it may read any resident slot of the layer, and never reads an
        absent expert's."""
        if not self._slot_ready:
            return
        if fused or self.use_kernel:
            read = {int(s) for s in slot_map if s >= 0}
        else:
            read = set(self._slot_ready)
        stream = torch.cuda.current_stream(self.device)
        timed = self._copy_stream is not None
        waited, kinds = set(), []
        for s in read:
            ev = self._slot_ready.pop(s, None)
            kind = self._slot_kind.pop(s, None)
            if ev is not None and id(ev) not in waited:
                if timed and not waited:
                    before = torch.cuda.Event(enable_timing=True)
                    before.record(stream)
                waited.add(id(ev))
                kinds.append(kind)
                stream.wait_event(ev)
        if timed and waited:
            # the compute stream waits from reaching `before` until the
            # newest awaited copy ends: that copy's kind is the wait's
            after = torch.cuda.Event(enable_timing=True)
            after.record(stream)
            self._wait_timers.append((before, after, max(kinds)[1]))

    def _dispatch_swap(self, slots: List[int], keys: List[Tuple[int, int]],
                       demand: bool) -> None:
        """One batched swap-in of `keys` into `slots`; `demand`: copies the
        step needs now (a miss, a replay's demand), not predicted ones."""
        nbytes = len(slots) * self._expert_nbytes
        timing = swap_in_many(self.buffer, slots, self.store, keys,
                              self._copy_stream)
        self.stats.swap_calls += 1
        self.stats.swap_bytes += int(nbytes)
        if isinstance(timing, float):
            self._note_copy(nbytes, timing)
            return
        for s in slots:
            self._slot_ready[s] = timing[1]
            self._slot_kind[s] = (self._copies_issued, demand)
        self._copies_issued += 1
        self._copy_timers.append((timing[0], timing[1], nbytes))
        if self.tiers is not None:
            # the host records these copies read stay until they end
            self.tiers.note_copies(keys, timing[1])

    def _note_copy(self, nbytes: float, seconds: float) -> None:
        self.stats.copy_s += seconds
        self.controller.update_bandwidth(nbytes, seconds)

    def _read_copy_timers(self) -> None:
        """Feed every completed copy's device-timed duration to the
        controller's bandwidth estimate (issue time would say nothing:
        the copies are asynchronous), and count every completed wait of
        the compute stream on copies."""
        pending = []
        for start, end, nbytes in self._copy_timers:
            if end.query():
                self._note_copy(nbytes, start.elapsed_time(end) / 1e3)
            else:
                pending.append((start, end, nbytes))
        self._copy_timers = pending
        waits = []
        for before, after, demand in self._wait_timers:
            if after.query():
                wait_s = before.elapsed_time(after) / 1e3
                self.stats.copy_wait_s += wait_s
                if demand:
                    self.stats.copy_wait_demand_s += wait_s
            else:
                waits.append((before, after, demand))
        self._wait_timers = waits

    def _pull(self, t: torch.Tensor) -> np.ndarray:
        """ONE blocking device -> host pull (a host sync)."""
        with self.tracer.span("pull", "pull_s"):
            h = t.cpu().numpy()
            self.stats.host_syncs += 1
            self._read_copy_timers()
        return h

    def synchronize(self) -> None:
        """Wait for all device work, then account the finished copies."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._read_copy_timers()

    def _advance_clock(self) -> None:
        """One virtual link-clock tick per MoE-layer dispatch: the device
        prefetcher lands arrivals; with a tiered store the disk link lands
        promotions, the popularity-driven S_disk prefetcher issues the
        next disk window, and the integrity scrubber (when configured)
        spends its idle-paced budget re-verifying host-resident copies."""
        self._clock += 1.0
        self.prefetcher.advance(self._clock)
        if self.tiers is not None:
            self.tiers.advance(self._clock)
            n_moe = max(len(self.moe_layer_ids), 1)
            self.tiers.auto_prefetch(self._clock, int(self._clock) % n_moe)
            self.tiers.scrub_tick(self._clock)

    # -- host tier (core.expert_tiers) ---------------------------------------
    def _tier_demand(self, key: Tuple[int, int]) -> bool:
        """Guarantee host-tier residency for a demanded expert (always True
        on a pre-staged store). A host miss blocks on the disk link and
        records a stall just like a device miss; returns False only when
        injected disk faults defeat every retry (or the expert is
        quarantined) — the caller then drops the expert's tokens and
        degrades (never deadlocks)."""
        if self.tiers is None:
            return True
        r = self.tiers.demand_host(key, self._clock)
        if r is None:
            self.stats.host_misses += 1
            self._enter_degraded()
            return False
        stall, was_hit = r
        if was_hit:
            self.stats.host_hits += 1
        else:
            self.stats.host_misses += 1
            self.stats.disk_stall_s += stall
        return True

    def _tier_ready(self, key: Tuple[int, int]) -> bool:
        """Speculative fills only proceed for host-resident experts; a
        host-absent key queues a disk->host promotion instead of blocking
        the window."""
        if self.tiers is None:
            return True
        if self.tiers.host_resident(key):
            return True
        self.tiers.request_host(key, self._clock)
        return False

    def integrity_counters(self) -> Dict[str, float]:
        """The tier's integrity-guard health counters (zeros without a
        tiered store), which `ServingEngine` mirrors into the
        `ServingReport`."""
        if self.tiers is None:
            return dict(n_corrupt_detected=0, n_requarantined=0,
                        n_scrubbed=0, n_quarantined_experts=0)
        return self.tiers.guard.counters()

    # -- faults ----------------------------------------------------------------
    def _fault_transfer_ok(self, key: Tuple[int, int], *,
                           demand: bool) -> bool:
        """Whether a swap-in of `key` goes through, drawn from the fault
        plan (always True without one). A demand transfer gets up to
        `retry_max` retries with doubling backoff; when they are spent the
        engine degrades. A speculative fill gets one attempt and no
        degradation: a failed guess costs nothing, the expert is demanded
        later if needed."""
        fi = self.faults
        if fi is None:
            return True
        if not fi.transfer_fails(key, self._clock):
            if demand:
                self._note_transfer_ok()
            return True
        self.stats.link_failures += 1
        if not demand:
            return False
        for attempt in range(self.retry_max):
            self.stats.retries += 1
            if self.retry_backoff_s > 0.0:
                time.sleep(self.retry_backoff_s * (2.0 ** attempt))
            if not fi.transfer_fails(key, self._clock):
                self._note_transfer_ok()
                return True
            self.stats.link_failures += 1
        self._enter_degraded()
        return False

    def _note_transfer_ok(self) -> None:
        """A clean demand transfer; `degraded_recover_streak` in a row end
        degraded routing (at route bias 0 decode then makes exactly the
        calls of an engine that never degraded)."""
        self._fault_ok_streak += 1
        if self._degraded \
                and self._fault_ok_streak >= self.degraded_recover_streak:
            self._degraded = False

    def _enter_degraded(self) -> None:
        self._fault_ok_streak = 0
        self._degraded = True

    def _fault_step_end(self, step_s: float) -> None:
        """At the end of a decode step: feed the watchdog the step's wall
        time and count the step if it ran degraded or with the watchdog
        tripped. Inert without faults and watchdog."""
        if self.watchdog is not None:
            self.watchdog.observe(step_s)
        if self._degraded or (self.watchdog is not None
                              and self.watchdog.tripped):
            self.stats.degraded_steps += 1

    # -- residency -------------------------------------------------------------
    def ensure_resident(self, li: int, experts, *,
                        speculative: bool = False) -> int:
        """Swap in ALL missing experts for MoE layer li in one batched copy.
        Returns #experts swapped.

        A demand transfer that the fault plan fails past its retries leaves
        the expert non-resident (`_fault_transfer_ok`).

        The full needed set is pinned while inserting so a later insert can
        never evict an earlier-needed expert of the same layer; if the cache
        is smaller than the working set the overflow experts stay
        non-resident (their tokens drop via the sentinel slot).

        `speculative=True` (the decode window demanding its PREDICTED set):
        prediction accounting is deferred to `_settle_prediction` when the
        layer's actual routing is verified."""
        with self.tracer.span("residency", "residency_s", layer=li,
                              kind="speculative" if speculative
                              else "demand") as span:
            keys = [(li, int(e)) for e in experts]
            if self.tiers is not None and not speculative:
                # host-tier demand-size EWMA: the n_e term of S_disk
                self.tiers.note_layer_demand(len(keys))
                # the bytes of this batch's likely promotions start moving now
                self.tiers.read_ahead([k for k in keys if k not in self.cache])
            for key in keys:
                self.cache.pin(key)
            missing: List[Tuple[int, int]] = []
            slots: List[int] = []
            try:
                for key in keys:
                    if self.cache.touch(key):
                        if self.tiers is not None and not speculative:
                            self.tiers.note_access(key)
                        if not speculative and key in self._prefetch_pending:
                            self._prefetch_pending.discard(key)
                            self._settle_hit(key, self.prefetcher.is_ready(
                                key, self._clock))
                        continue
                    if not speculative:
                        self.stats.demand_misses += 1
                        self.controller.record_stall()
                        if not self._fault_transfer_ok(key, demand=True):
                            # retries exhausted: the expert stays non-resident
                            # this step, its tokens drop through the dead slot
                            # (as on capacity overflow) and routing degrades
                            continue
                        if not self._tier_demand(key):
                            # the disk link defeated the promotion: degrade
                            # exactly like an exhausted device demand above
                            continue
                        self.prefetcher.demand(key, self._clock)
                    else:
                        if not self._fault_transfer_ok(key, demand=False):
                            continue
                        if not self._tier_ready(key):
                            # speculative fills never block on the disk: the
                            # promotion is queued, a later window takes it
                            continue
                    try:
                        victim = self.cache.insert(key)
                    except RuntimeError:  # every resident expert is needed NOW
                        continue
                    if speculative:
                        # a predicted expert the prefetch window couldn't fit:
                        # booked as speculation, settled at verification
                        self.stats.prefetched += 1
                        self.prefetcher.prefetch(key, self._clock)
                        self._prefetch_pending.add(key)
                    if victim is not None:
                        self._evict(victim)
                    slots.append(self.table.assign(li, key[1]))
                    if self.tiers is not None:
                        # slot residency pins the host copy
                        self.tiers.pin(key)
                    missing.append(key)
            finally:
                for key in keys:
                    self.cache.unpin(key)
            if missing:
                self._dispatch_swap(slots, missing, demand=not speculative)
                self.stats.swap_experts += len(missing)
            span.set(experts=len(missing),
                     bytes=len(missing) * self._expert_nbytes)
            return len(missing)

    def _settle_hit(self, key: Tuple[int, int], ready: bool, *,
                    forgotten: bool = False) -> None:
        """A prefetched expert was consumed; a late one counts as a stall."""
        self.stats.prefetch_hits += 1
        if not forgotten:
            self.prefetcher.note_use(key)
        if not ready:
            self.stats.late_hits += 1
            self.controller.record_stall()

    def _evict(self, victim: Tuple[int, int]) -> None:
        """Release a victim's slot; an evicted never-demanded prefetch is the
        controller's overfetch signal — unless its layer is mid-window, in
        which case verification settles it."""
        self.table.release(*victim)
        if self.tiers is not None:
            self.tiers.unpin(victim)
        self.stats.evictions += 1
        deferred = False
        if victim in self._prefetch_pending:
            self._prefetch_pending.discard(victim)
            if victim[0] in self._window_layers:
                self._evicted_spec[victim] = self.prefetcher.is_ready(
                    victim, self._clock)
                deferred = True
            else:
                self.controller.record_overfetch()
        self.prefetcher.forget(victim, count_unused=not deferred)

    def prefetch_layer(self, li: int, experts) -> int:
        """Speculatively swap in predicted experts for ONE future layer."""
        return self.prefetch_window([(li, experts)])

    def prefetch_window(self, plan) -> int:
        """Fan speculative swap-ins across a multi-layer horizon in ONE
        batched copy. `plan`: [(layer, experts)] nearest layer first.
        Guesses only take free slots or evict the cold low-reuse tier —
        never the high tier holding demand residency. Returns #issued."""
        with self.tracer.span("residency", "residency_s", kind="prefetch",
                              layers=[li for li, _ in plan]) as span:
            slots: List[int] = []
            issued: List[Tuple[int, int]] = []
            if self.tiers is not None:
                # predictor output feeds the disk tier's popularity stats even
                # for keys the device window cannot take this round
                self.tiers.note_predicted(
                    [(li, int(e)) for li, experts in plan for e in experts])
            try:
                for li, experts in plan:
                    stop = False
                    for e in experts:
                        key = (li, int(e))
                        if key in self.cache:
                            continue
                        if not self._fault_transfer_ok(key, demand=False):
                            continue     # a failed speculative fill: skip it
                        if not self._tier_ready(key):
                            continue     # host-absent: promotion queued
                        if self.cache.free_slots <= 0 and not any(
                                k not in self.cache.pinned
                                for k in self.cache.low):
                            # no free slot and no evictable cold victim
                            stop = True
                            break
                        victim = self.cache.insert(key, high=False)
                        if victim is not None:
                            self._evict(victim)
                        # pin so a later insert in THIS batch cannot evict it
                        self.cache.pin(key)
                        issued.append(key)
                        slots.append(self.table.assign(li, int(e)))
                        if self.tiers is not None:
                            self.tiers.pin(key)
                        self._prefetch_pending.add(key)
                    if stop:
                        break
                self.prefetcher.prefetch_many(issued, self._clock)
            finally:
                for key in issued:
                    self.cache.unpin(key)
            if issued:
                self._dispatch_swap(slots, issued, demand=False)
                self.stats.swap_experts += len(issued)
                self.stats.prefetched += len(issued)
            span.set(experts=len(issued),
                     bytes=len(issued) * self._expert_nbytes)
            return len(issued)

    def _retier(self, li: int, needed, predicted: Dict[int, Any]) -> None:
        """Re-tier the cache around MoE layer li: its `needed` experts and
        the `predicted` ones ({layer: experts}) go high."""
        with self.tracer.span("residency", "residency_s", kind="retier",
                              layer=li):
            self.cache.retier(
                [(li, int(e)) for e in needed]
                + [(lj, int(e)) for lj, es in predicted.items() for e in es],
                recent_layers=(), current_layer=li)

    def _protect_early_layers(self, s: Optional[int] = None) -> None:
        """Keep the first `s` MoE layers' experts high for the next step
        (default: the horizon, at least 1)."""
        if s is None:
            s = max(1, min(self._s_eff(), len(self.moe_layer_ids)))
        with self.tracer.span("residency", "residency_s", kind="protect"):
            self.cache.protect_early_layers(s)

    # -- forward (no cache) ------------------------------------------------------
    def _next_router(self, li: int) -> Optional[torch.Tensor]:
        if li >= len(self.moe_layer_ids):
            return None
        return self._p[self.moe_layer_ids[li]]["moe"]["router"]

    def forward(self, tokens) -> torch.Tensor:
        """Full forward with slot-buffer MoE. tokens: (B, T) -> (B, T, d)."""
        with self.tracer.span("forward", "step_host_s"):
            if not self.fused:
                return self._forward_legacy(tokens)
            return self._forward_fused(tokens)

    def _forward_fused(self, tokens) -> torch.Tensor:
        self.stats.steps += 1
        tokens = torch.as_tensor(tokens, device=self.device)
        x, positions = self._dispatch(self._embed, tokens)
        li = 0
        for i, spec in enumerate(self.specs):
            p = self._p[i]
            if not spec.is_moe:
                x = self._dispatch(layer_forward, p, self.cfg, spec, x,
                                   positions)
                continue
            nxt = self._next_router(li + 1)
            want_pred = self.prefetch_enabled and nxt is not None
            x, flat, r, masks = self._dispatch(
                self._pre, p, spec, x, positions, nxt if want_pred else None)
            masks_h = self._pull(masks)
            self._advance_clock()
            needed = np.nonzero(masks_h[0])[0]
            predicted = np.nonzero(masks_h[1])[0] if want_pred else []
            self._retier(li, needed, {li + 1: predicted})
            self.ensure_resident(li, needed)
            if want_pred:
                # issue next-layer swap-ins BEFORE this layer's FFN dispatch
                self.prefetch_layer(li + 1, predicted)
            x = self._slot_ffn(p, self.table.layer_slot_map(li), x, flat, r)
            li += 1
        self._protect_early_layers(1)
        return x

    def reference_forward(self, tokens) -> torch.Tensor:
        """Fully-resident oracle of `forward` through the same functions."""
        tokens = torch.as_tensor(tokens, device=self.device)
        x, positions = self._embed(tokens)
        li = 0
        for i, spec in enumerate(self.specs):
            p = self._p[i]
            if not spec.is_moe:
                x = layer_forward(p, self.cfg, spec, x, positions)
                continue
            nxt = self._next_router(li + 1)
            want_pred = self.prefetch_enabled and nxt is not None
            x, flat, r, _ = self._pre(p, spec, x, positions,
                                      nxt if want_pred else None)
            x = self._ffn(p, self._full_experts(li), self._ident_map, x, flat,
                          r)
            li += 1
        return x

    # -- pre-fused execution (the benchmark's baseline) ----------------------
    @property
    def swap_count(self) -> int:
        """Experts written into the slot buffer so far, on every path."""
        return self.stats.swap_experts

    def _ensure_resident_seq(self, li: int, experts) -> int:
        """The pre-fused swap path: one swap-in per missing expert, each
        its own copy on the compute stream, with no pinning of the layer's
        working set. Returns #experts swapped."""
        swaps = 0
        for e in experts:
            key = (li, int(e))
            if self.cache.touch(key):
                continue
            self.stats.demand_misses += 1
            victim = self.cache.insert(key)
            if victim is not None:
                self.table.release(*victim)
            slot = self.table.assign(li, int(e))
            swap_in(self.buffer, slot, *self.store.expert(li, int(e)))
            self.stats.swap_calls += 1
            self.stats.swap_experts += 1
            self.stats.swap_bytes += int(self._expert_nbytes)
            swaps += 1
        return swaps

    def _forward_legacy(self, tokens) -> torch.Tensor:
        """The pre-fused forward, kept as the benchmark's baseline: eager
        per-layer compute, host routing that pulls the whole (B*T, k)
        assignment tensor (one host sync a MoE layer), sequential per-expert
        swap-ins, and `moe_slotbuf` on its plain path re-routing the
        tokens."""
        self.stats.steps += 1
        cfg, k = self.cfg, self.cfg.moe.top_k
        tokens = torch.as_tensor(tokens, device=self.device)
        B, T = tokens.shape
        x, positions = self._embed(tokens)
        li = 0
        for i, spec in enumerate(self.specs):
            p = self._p[i]
            if not spec.is_moe:
                x = layer_forward(p, cfg, spec, x, positions)
                continue
            stripped, spec_nf = split_ffn_params(p, spec)
            x = layer_forward(stripped, cfg, spec_nf, x, positions)
            flat = _norm(x, p["ffn_norm"], cfg).reshape(B * T, -1)
            r = moe_mod.route(p["moe"]["router"], flat, k,
                              cfg.moe.router_norm_topk)
            needed = sorted({int(e) for e in self._pull(r.expert_ids).ravel()})
            self._ensure_resident_seq(li, needed)
            slot_map = self._upload(self.table.layer_slot_map(li))
            out, _ = moe_mod.moe_slotbuf(p["moe"], self.buffer, slot_map, flat,
                                         cfg.moe, capacity=B * T * k)
            ff = out.reshape(B, T, -1)
            if "post_ffn_norm" in p:
                ff = _norm(ff, p["post_ffn_norm"], cfg)
            x = x + ff
            li += 1
        return x

    # -- cache-aware routing (§3.4) ------------------------------------------
    def set_route_bias(self, strength: float, adaptive: bool = False) -> None:
        """Turn on (or adjust) the bounded residency perturbation of decode
        routing: non-resident experts' router logits drop by `strength`
        before top-k, so a non-resident expert loses its place only to a
        resident one within `strength` logits, and the router's KL from the
        unperturbed one is at most `strength` nats
        (`core.cache_aware.residency_logit_bias`).

        `adaptive=True` makes `strength` a ceiling: the engine's
        `StepSizeController` ramps its `route_bias` within [0, strength]
        from the stall/overfetch thresholds that move S. Strength 0 turns
        the feature off."""
        self.route_bias = float(strength)
        self.route_bias_adaptive = bool(adaptive)
        if adaptive and self.route_bias > 0.0 \
                and self.controller.cfg.route_bias_max <= 0.0:
            self.controller.cfg = dataclasses.replace(
                self.controller.cfg, route_bias_max=self.route_bias)

    def _route_bias_strength(self) -> float:
        """The perturbation strength now (router-logit units). While
        degraded (link faults) it is at least `degraded_route_bias`:
        resident-only routing that stays a bounded perturbation (router KL
        <= that many nats a layer), never a hard mask."""
        if self.route_bias_adaptive:
            base = float(min(self.controller.route_bias, self.route_bias))
        else:
            base = self.route_bias
        if self._degraded:
            return max(base, self.degraded_route_bias)
        return base

    def _residency_bias(self, li: int) -> torch.Tensor:
        """(E,) device bias of MoE layer li from the host slot table, the
        state every residency decision reads: no device->host pull.
        Assigned in-flight transfers count as resident: they land before
        the FFN that reads them."""
        mask = self.table.layer_slot_map(li) >= 0
        return self._upload(
            residency_logit_bias(mask, self._route_bias_strength()))

    def _pregate_bias(self, li: int, s: int) -> torch.Tensor:
        """(s, E) bias of the pre-gated horizon (MoE layers li+1..li+s),
        each row from its own layer's residency, so the predictions agree
        with the biased routing those layers will run."""
        rows = np.stack([self.table.layer_slot_map(li + 1 + j) >= 0
                         for j in range(s)])
        return self._upload(
            residency_logit_bias(rows, self._route_bias_strength()))

    # -- adaptive horizon ----------------------------------------------------
    def _s_eff(self) -> int:
        return self.fixed_s if self.fixed_s is not None else self.controller.s

    def _horizon(self, li: int) -> int:
        """Lookahead from MoE layer li, clamped to the remaining sweep; 0
        while the step watchdog is tripped (a sync at every MoE layer until
        its hysteresis lets go) or the fault plan blacks the predictor out;
        always 0 with prefetch off."""
        if not self.prefetch_enabled:
            return 0
        if self.watchdog is not None and self.watchdog.tripped:
            return 0
        if self.faults is not None \
                and self.faults.predictor_blackout(self._clock):
            return 0
        remaining = len(self.moe_layer_ids) - (li + 1)
        if self.fixed_s is not None:
            return max(0, min(self.fixed_s, remaining))
        return self.controller.horizon(remaining)

    def _sync_masks_dev(self, li: int, s: int, flat, needed_dev,
                        active_dev=None, rbias=None) -> torch.Tensor:
        """Device-side (s+1, E) sync mask block (row 0 the layer's needed
        set, rows 1.. the pre-gated horizon; `rbias` the horizon's (s, E)
        residency bias, or None)."""
        if s == 0:
            return needed_dev[None]
        return self._dispatch(self._pregate, flat, needed_dev,
                              self._router_stack[li + 1: li + 1 + s],
                              active_dev, rbias)

    @staticmethod
    def _decode_sync_rows(li: int, s: int, rows: np.ndarray):
        """Pulled (s+1, E) sync block -> (needed expert ids, predicted sets
        keyed by MoE layer)."""
        needed = np.nonzero(rows[0])[0]
        predicted = {li + 1 + j: {int(e) for e in np.nonzero(rows[1 + j])[0]}
                     for j in range(s)}
        return needed, predicted

    # -- incremental decode (KV-cached) ---------------------------------------
    def _settle_prediction(self, li: int, needed: set,
                           ready_at_dispatch: Optional[Dict] = None) -> None:
        """Actual routing for layer li is known: every outstanding prefetch
        for it settles as a hit (late if the link model had not delivered
        it at dispatch) or as an overfetch."""
        for k in [k for k in self._prefetch_pending if k[0] == li]:
            self._prefetch_pending.discard(k)
            if k[1] in needed:
                ready = (ready_at_dispatch.get(k, False)
                         if ready_at_dispatch is not None
                         else self.prefetcher.is_ready(k, self._clock))
                self._settle_hit(k, ready)
            else:
                self.controller.record_overfetch()
        for k in [k for k in self._evicted_spec if k[0] == li]:
            was_ready = self._evicted_spec.pop(k)
            if k[1] in needed:
                self._settle_hit(k, was_ready, forgotten=True)
            else:
                self.prefetcher.note_unused(k)
                self.controller.record_overfetch()

    def _sync_moe_layer(self, li: int, needed: np.ndarray,
                        predicted: Dict[int, set]) -> None:
        """Host-side residency work at a sync layer: tier maintenance,
        demand swap-ins, and the speculative multi-layer prefetch fan-out —
        all issued BEFORE the FFN dispatch."""
        self._settle_prediction(li, {int(e) for e in needed})
        self._retier(li, needed, predicted)
        self.ensure_resident(li, needed)
        if predicted:
            self.prefetch_window(
                [(lj, sorted(es)) for lj, es in sorted(predicted.items())])

    def _prefill_moe_sync(self, li: int, flat, needed_dev,
                          active_dev=None) -> np.ndarray:
        """The per-MoE-layer sync that monolithic `prefill` and
        `prefill_chunk` share: pull the (S+1, E) mask block (pre-gated over
        `active_dev` rows only, when given: a chunk's padding rows never
        demand, evict or pre-gate experts), advance the link clock,
        settle/tier/ensure residency and fan out the speculative window.
        Returns the layer's slot map."""
        s = self._horizon(li)
        masks_h = self._pull(self._sync_masks_dev(li, s, flat, needed_dev,
                                                  active_dev))
        self._advance_clock()
        needed, predicted = self._decode_sync_rows(li, s, masks_h)
        self._sync_moe_layer(li, needed, predicted)
        return self.table.layer_slot_map(li)

    def prefill(self, tokens) -> Tuple[torch.Tensor, DecodeState]:
        """Run the prompt through the slot path, populating per-layer KV
        caches. Returns (last-token logits (B, V), DecodeState)."""
        with self.tracer.span("prefill", "step_host_s"):
            assert self.fused, "incremental decode requires the fused runtime"
            tokens = torch.as_tensor(tokens, device=self.device)
            B, T = tokens.shape
            assert T <= self.max_seq, \
                f"prompt {T} exceeds max_seq {self.max_seq}"
            self.stats.steps += 1
            x, positions = self._dispatch(self._embed, tokens)
            caches: List[Any] = []
            li = 0
            for i, spec in enumerate(self.specs):
                p = self._p[i]
                if not spec.is_moe:
                    x, c = self._dispatch(layer_prefill, p, self.cfg, spec, x,
                                          positions, self.max_seq)
                    caches.append(c)
                    continue
                x, flat, r, needed_dev, c = self._dispatch(
                    self._pre_prefill, p, spec, x, positions)
                caches.append(c)
                slot_map = self._prefill_moe_sync(li, flat, needed_dev)
                x = self._slot_ffn(p, slot_map, x, flat, r)
                li += 1
            self._protect_early_layers()
            logits = self._dispatch(self._logits, x)
            return logits, DecodeState(
                caches, torch.tensor(T, device=self.device), pos=int(T))

    # -- chunked prefill -------------------------------------------------------
    @property
    def chunked_prefill_supported(self) -> bool:
        """Chunks address caches by absolute position: every layer must be
        a global-attention layer (true of every model the port runs)."""
        return all(s.kind == "attn" and s.window == 0 for s in self.specs)

    def start_prefill(self, tokens,
                      chunk_size: int = DEFAULT_PREFILL_CHUNK
                      ) -> PrefillCursor:
        """Open a resumable chunked prefill for ONE prompt, (T,) or (1, T).
        Drive it with `prefill_chunk`; commit it with
        `finish_prefill_into`, or let `prefill_chunked` run it through."""
        assert self.fused, "chunked prefill requires the fused runtime"
        if isinstance(tokens, torch.Tensor):
            tokens = tokens.cpu()
        toks = np.asarray(tokens, np.int64)
        if not (toks.ndim == 1 or (toks.ndim == 2 and toks.shape[0] == 1)):
            raise ValueError(f"start_prefill ingests one prompt, (T,) or "
                             f"(1, T); got shape {toks.shape}")
        toks = toks.reshape(-1)
        if not 1 <= toks.size <= self.max_seq:
            raise ValueError(f"prompt of {toks.size} tokens; the engine "
                             f"takes 1..{self.max_seq}")
        if chunk_size < 1:
            raise ValueError(f"chunk_size must be >= 1, got {chunk_size}")
        caches = [init_layer_cache(self.cfg, spec, 1, self.max_seq,
                                   self.model.dtype, self.device)
                  for spec in self.specs]
        return PrefillCursor(tokens=toks,
                             chunk=int(min(chunk_size, self.max_seq)),
                             caches=caches)

    def _next_chunk(self, cursor: PrefillCursor):
        """(offset, real rows t, padded (1, C) token tensor) of the cursor's
        next chunk."""
        if cursor.done:
            raise ValueError("the cursor has already ingested its prompt")
        o, C = cursor.offset, cursor.chunk
        t = min(C, len(cursor.tokens) - o)
        buf = np.zeros((1, C), np.int64)
        buf[0, :t] = cursor.tokens[o:o + t]
        return o, t, self._upload(buf)

    def prefill_chunk(self, cursor: PrefillCursor) -> bool:
        """Ingest ONE padded (1, C) chunk of the cursor's prompt through the
        slot path: K/V written at absolute positions offset..offset+t, the
        chunk's queries attending over everything ingested so far, and per
        MoE layer the sync sequence of `prefill` with the padding rows
        masked out of routing demand. Returns `cursor.done`.

        Attention runs over exactly the ingested prefix. The reference
        pads it to a power-of-two bucket so that its jit compiles a
        bounded number of shapes; eager PyTorch compiles nothing, so the
        port reads no cache row that has not been written."""
        with self.tracer.span("prefill_chunk", "step_host_s",
                              offset=cursor.offset):
            o, t, buf = self._next_chunk(cursor)
            self.stats.steps += 1
            x, positions, active = self._dispatch(self._embed_chunk, buf, o, t)
            li = 0
            for i, spec in enumerate(self.specs):
                p = self._p[i]
                if not spec.is_moe:
                    x, cursor.caches[i] = self._dispatch(
                        layer_prefill_chunk, p, self.cfg, spec, x, positions,
                        cursor.caches[i], o, t)
                    continue
                x, flat, r, needed_dev, cursor.caches[i] = self._dispatch(
                    self._pre_prefill_chunk, p, spec, x, positions,
                    cursor.caches[i], o, t, active)
                slot_map = self._prefill_moe_sync(li, flat, needed_dev, active)
                x = self._slot_ffn(p, slot_map, x, flat, r)
                li += 1
            self._protect_early_layers()
            cursor.offset = o + t
            if cursor.done:
                cursor.logits = self._dispatch(self._logits_at, x, t - 1)
            return cursor.done

    def _run_prefill_cursor(self, tokens, chunk_size: int) -> PrefillCursor:
        """Open a cursor and drive it to completion."""
        cursor = self.start_prefill(tokens, chunk_size)
        while not self.prefill_chunk(cursor):
            pass
        return cursor

    def prefill_chunked(self, tokens,
                        chunk_size: int = DEFAULT_PREFILL_CHUNK
                        ) -> Tuple[torch.Tensor, DecodeState]:
        """Chunked counterpart of `prefill` for one prompt: the same
        (logits (1, V), DecodeState) contract, one chunk at a time."""
        cursor = self._run_prefill_cursor(tokens, chunk_size)
        T = len(cursor.tokens)
        return cursor.logits, DecodeState(
            cursor.caches, torch.tensor(T, device=self.device), pos=T)

    def finish_prefill_into(self, state: DecodeState, slot: int,
                            cursor: PrefillCursor) -> torch.Tensor:
        """Commit a completed cursor into batch row `slot` of a batched
        state (copying its caches into new tensors, as `prefill_into`
        does). Returns the prompt's last-token logits (1, V)."""
        if not (state.batched and cursor.done):
            raise ValueError("finish_prefill_into needs a batched state and "
                             "a cursor that has ingested its prompt")
        if state.active[slot]:
            raise ValueError(f"slot {slot} is still occupied")
        self._commit_prefill_row(state, slot, cursor.caches,
                                 len(cursor.tokens))
        return cursor.logits

    # -- batched serving state (continuous batching over one engine) --------
    def alloc_decode_state(self, batch: int) -> DecodeState:
        """Empty batched DecodeState with `batch` request rows."""
        caches = [init_layer_cache(self.cfg, spec, batch, self.max_seq,
                                   self.model.dtype, self.device)
                  for spec in self.specs]
        return DecodeState(caches,
                           torch.zeros(batch, dtype=torch.long,
                                       device=self.device),
                           pos=np.zeros(batch, np.int64),
                           active=np.zeros(batch, bool))

    def _commit_prefill_row(self, state: DecodeState, slot: int,
                            caches, T: int) -> None:
        """Write one prompt's batch-1 caches into row `slot` (into new
        tensors: states taken earlier stay as they were) and mark it live."""
        for i in range(len(self.specs)):
            new = {}
            for name, full in state.caches[i].items():
                t = full.clone()
                t[slot] = caches[i][name][0]
                new[name] = t
            state.caches[i] = new
        clen = state.cache_len.clone()
        clen[slot] = T
        state.cache_len = clen
        state.pos[slot] = T
        state.active[slot] = True

    def prefill_into(self, state: DecodeState, slot: int, tokens,
                     chunk_size: Optional[int] = None) -> torch.Tensor:
        """Admit a request: run its (1, T) prompt through the slot path and
        write the caches into row `slot` of `state`. Returns the prompt's
        last-token logits (1, V). `chunk_size`: ingest it chunk by chunk
        (run to completion here; the serving loop interleaves chunks with
        decode through `start_prefill` / `prefill_chunk` instead)."""
        assert state.batched, "prefill_into requires an alloc_decode_state"
        assert not state.active[slot], f"slot {slot} is still occupied"
        if chunk_size:
            cursor = self._run_prefill_cursor(tokens, chunk_size)
            return self.finish_prefill_into(state, slot, cursor)
        tokens = torch.as_tensor(tokens, device=self.device)
        assert tokens.dim() == 2 and tokens.shape[0] == 1
        logits, st1 = self.prefill(tokens)
        self._commit_prefill_row(state, slot, st1.caches, st1.pos)
        return logits

    def retire_slot(self, state: DecodeState, slot: int) -> None:
        """Free a finished request's row (its stale cache row is inert)."""
        assert state.batched
        state.active[slot] = False

    def decode_step(self, tok, state: DecodeState
                    ) -> Tuple[torch.Tensor, DecodeState]:
        """One KV-cached decode step with S-layer speculative execution
        between host syncs. tok: (B,) integer. Returns (logits (B, V), a
        new DecodeState); the input state stays valid.

        A *sync* MoE layer pulls one (S+1, E) mask (actual routing + the
        pre-gated next-S prediction) and fans speculative swap-ins across
        layers l+1..l+S. The next S MoE layers then execute WITHOUT a pull:
        their FFNs dispatch against the predicted residency while their
        needed masks accumulate on the device. The next sync pulls them
        with its own and verifies needed ⊆ resident-at-dispatch for every
        speculative layer; a misprediction rolls x and the caches back to
        the first wrong layer and replays it as a sync layer. Batched
        states run the same control flow over the union of active rows.
        An engine built with `use_superkernel=True` takes the
        segment-fused step instead (`_decode_step_superkernel`)."""
        with self.tracer.span("decode_step", "step_host_s"):
            assert self.fused, "incremental decode requires the fused runtime"
            batched = state.batched
            if batched:
                act = np.asarray(state.active, bool)
                top = int(np.asarray(state.pos)[act].max()) if act.any() else 0
                active_dev = self._upload(act)
            else:
                top, active_dev = state.pos, None
            assert top < self.max_seq, (
                f"decode past max_seq={self.max_seq} would wrap the KV ring "
                "buffer or overflow the positional latent cache")
            step = (self._decode_step_superkernel if self.use_superkernel
                    else self._decode_step_unfused)
            return step(tok, state, active_dev)

    def _decode_step_unfused(self, tok, state: DecodeState,
                             active_dev: Optional[torch.Tensor]
                             ) -> Tuple[torch.Tensor, DecodeState]:
        """`decode_step` layer by layer: about two dispatches a MoE
        layer."""
        # cache-aware routing is switched by the ceiling, not the strength
        # now: an adaptive engine at strength 0 routes with a zero bias;
        # degraded routing (link faults) takes the same biased calls
        ca = self.route_bias > 0.0 or self._degraded
        t0 = time.perf_counter()
        self.stats.steps += 1
        tok = torch.as_tensor(tok, device=self.device)
        caches, clen = list(state.caches), state.cache_len
        x = self._dispatch(self._embed_decode, tok)

        predicted: Dict[int, set] = {}   # li -> predicted expert set
        # pending: (li, abs_i, needed_dev, slot_snap, ready_snap) per
        # speculatively-dispatched MoE layer
        pending: List[tuple] = []
        ckpt: Dict[int, tuple] = {}      # abs_i -> (x_in, old_cache)
        self._window_layers.clear()
        self._evicted_spec.clear()

        def replay_from(fail_idx: int):
            """Roll back to the first mis-speculated layer."""
            plj, pabs = pending[fail_idx][0], pending[fail_idx][1]
            self.stats.replays += 1
            with self.tracer.span("replay", layer=plj):
                for k, (_, old_c) in ckpt.items():
                    if k >= pabs:
                        caches[k] = old_c
                x_r = ckpt[pabs][0]
                # mid-window evictions parked for rolled-back layers: their
                # consuming dispatch is discarded, so the transfer was wasted
                for k in [k for k in self._evicted_spec if k[0] >= plj]:
                    del self._evicted_spec[k]
                    self.prefetcher.note_unused(k)
                    self.controller.record_overfetch()
                predicted.clear()
                pending.clear()
                ckpt.clear()
                self._window_layers.clear()
            return pabs, plj, x_r

        def verify(masks_h: np.ndarray) -> int:
            """First pending index whose actual routing escaped the
            residency it was dispatched with, or -1."""
            with self.tracer.span("verify", layers=len(pending)):
                for idx, (plj, _, _, snap, rsnap) in enumerate(pending):
                    needed = np.nonzero(masks_h[idx])[0]
                    self._settle_prediction(plj, {int(e) for e in needed},
                                            ready_at_dispatch=rsnap)
                    if any(snap[int(e)] < 0 for e in needed):
                        return idx
            return -1

        def pull_and_verify(extra):
            """ONE blocking pull of the window's needed masks (+ the sync
            layer's rows), then verification."""
            mats = [p_[2][None] for p_ in pending]
            if extra is not None:
                mats.append(extra)
            masks_h = self._pull(torch.cat(mats))
            npend = len(pending)
            fail = verify(masks_h[:npend])
            if fail < 0:
                pending.clear()
                ckpt.clear()
                self._window_layers.clear()
            return masks_h[npend:], fail

        i, li = 0, 0
        n_specs = len(self.specs)
        while True:
            if i == n_specs:
                if pending:
                    _, fail = pull_and_verify(None)
                    if fail >= 0:
                        i, li, x = replay_from(fail)
                        continue
                break
            spec = self.specs[i]
            p = self._p[i]
            if not spec.is_moe:
                if pending:
                    ckpt[i] = (x, caches[i])
                x, caches[i] = self._dispatch(layer_decode, p, self.cfg,
                                              spec, x, caches[i], clen)
                i += 1
                continue
            x_in, old_c = x, caches[i]
            x2, flat, r, needed_dev, c2 = self._dispatch(
                self._pre_decode, p, spec, x_in, old_c, clen, active_dev,
                self._residency_bias(li) if ca else None)
            self._advance_clock()
            if li in predicted:
                # ---- speculative layer: no host pull ------------------------
                ckpt[i] = (x_in, old_c)
                caches[i] = c2
                self.ensure_resident(li, sorted(predicted[li]),
                                     speculative=True)
                snap = self.table.layer_slot_map(li)
                ready_snap = {k: self.prefetcher.is_ready(k, self._clock)
                              for k in self._prefetch_pending if k[0] == li}
                pending.append((li, i, needed_dev, snap, ready_snap))
                self._window_layers.add(li)
                x = self._slot_ffn(p, snap, x2, flat, r)
                self.stats.spec_layers += 1
                i += 1
                li += 1
                continue
            # ---- sync layer: ONE blocking pull for verify + routing + S ----
            s = self._horizon(li)
            masks = self._sync_masks_dev(
                li, s, flat, needed_dev, active_dev,
                self._pregate_bias(li, s) if ca and s > 0 else None)
            sync, fail = pull_and_verify(masks)
            if fail >= 0:
                i, li, x = replay_from(fail)
                continue
            needed, pred = self._decode_sync_rows(li, s, sync)
            predicted.clear()
            predicted.update(pred)
            self._sync_moe_layer(li, needed, predicted)
            caches[i] = c2
            x = self._slot_ffn(p, self.table.layer_slot_map(li), x2, flat, r)
            i += 1
            li += 1

        self._protect_early_layers()
        logits = self._dispatch(self._logits, x)
        step_s = time.perf_counter() - t0
        self.controller.update_layer_time(step_s / max(len(self.specs), 1))
        self._fault_step_end(step_s)
        return logits, self._advance(state, caches, active_dev)

    @staticmethod
    def _advance(state: DecodeState, caches,
                 active_dev: Optional[torch.Tensor]) -> DecodeState:
        """The state after one decode step: only occupied rows of a batched
        state advance; idle rows hold their position."""
        if state.batched:
            act = np.asarray(state.active, bool)
            return DecodeState(
                caches, state.cache_len + active_dev.long(),
                pos=np.where(act, np.asarray(state.pos) + 1,
                             np.asarray(state.pos)),
                active=act.copy())
        return DecodeState(caches, state.cache_len + 1, pos=state.pos + 1)

    # -- decode superkernel (segment-fused decode) ---------------------------
    def _sk_segments(self) -> Tuple[List[List[int]], List[int]]:
        """The layer stack as decode segments: each segment is the run of
        dense layers up to and including the next MoE layer (so segment
        index == MoE layer index), plus the trailing dense layers."""
        if self._sk_segs is None:
            segs: List[List[int]] = []
            cur: List[int] = []
            for i, spec in enumerate(self.specs):
                cur.append(i)
                if spec.is_moe:
                    segs.append(cur)
                    cur = []
            assert segs, "superkernel decode needs at least one MoE layer"
            self._sk_segs = (segs, cur)
        return self._sk_segs

    def _sk_seg(self, seg: List[int], ps, seg_caches, x, clen, slot_weights,
                slot_map, routers_next, bias, active=None, *,
                bias_next: Optional[torch.Tensor] = None,
                first: bool = False, with_logits: bool = False,
                max_len: Optional[int] = None):
        """One decode segment: (embed the tokens if first) -> its dense
        layers -> the MoE layer's attention, each attention through
        `fused_decode_attention` (GQA) or `fused_mla_decode_attention` (MLA)
        -> ffn-norm -> routing, top-k and the expert FFN through
        `fused_moe_entry` -> residual, and
        the (1 + s, E) mask block (row 0 the experts routed to over `active`
        rows, rows 1.. the top-(k + margin) pre-gate of the next s routers).
        `bias`: the (E,) router-logit bias `fused_moe_entry` adds (the
        layer's residency bias, or zeros); `bias_next`: the pre-gate's
        (s, E) bias, or None.
        `with_logits`: the last segment of a stack that ends in a MoE layer
        also computes the final-norm logits (otherwise `_sk_tail` does). `max_len`: the host's bound on `clen` (its
        mirror of the lengths), passed to MLA's kernel so that it reads no
        length back from the device. Returns (x, masks, new caches,
        logits)."""
        cfg = self.cfg
        if first:
            x = self._embed_decode(x)
        new_caches = []
        for j, i in enumerate(seg[:-1]):
            x, c = layer_decode(ps[j], cfg, self.specs[i], x, seg_caches[j],
                                clen, use_kernel=True, max_len=max_len)
            new_caches.append(c)
        p = ps[-1]
        stripped, spec_nf = split_ffn_params(p, self.specs[seg[-1]])
        x, c = layer_decode(stripped, cfg, spec_nf, x, seg_caches[-1], clen,
                            use_kernel=True, max_len=max_len)
        new_caches.append(c)
        B, T, d = x.shape
        flat = rms_norm(x, p["ffn_norm"], cfg.norm_eps).reshape(-1, d)
        out, _, ids = moe_mod.moe_slotbuf_fused(
            p["moe"], slot_weights, slot_map, flat, cfg.moe, logit_bias=bias)
        x = x + out.reshape(B, T, d)
        needed = _needed_mask(ids, cfg.moe.num_experts, active)
        masks = self._pregate(flat, needed, routers_next, active, bias_next)
        logits = self._logits(x) if with_logits else None
        return x, masks, new_caches, logits

    def _sk_tail(self, tail: List[int], ps, tail_caches, x, clen,
                 max_len: Optional[int] = None):
        """The trailing dense layers (after the last MoE layer), each
        attention through its decode kernel, then the final-norm logits, in
        one call. Returns (logits, new caches)."""
        new_caches = []
        for j, i in enumerate(tail):
            x, c = layer_decode(ps[j], self.cfg, self.specs[i], x,
                                tail_caches[j], clen, use_kernel=True,
                                max_len=max_len)
            new_caches.append(c)
        return self._logits(x), new_caches

    def _decode_step_superkernel(self, tok, state: DecodeState,
                                 active_dev: Optional[torch.Tensor]
                                 ) -> Tuple[torch.Tensor, DecodeState]:
        """One decode step through the segment-fused path: one call per
        segment instead of about two per MoE layer plus embed and logits.

        Each segment runs against the residency it finds (absent experts'
        gates are zeroed inside the kernel). Segments the last sync
        predicted run speculatively; a sync segment pulls every pending
        segment's mask block at once and verifies needed ⊆
        resident-at-dispatch. On a miss the caches and x roll back to the
        failed segment, which replays with the pulled demand made resident
        first (`demand_hint`, growing monotonically, so replays end). A
        hinted segment whose demand still does not fit is capacity
        overflow: its absent experts' tokens drop, as on the unfused path.
        With cache-aware routing each segment's residency bias goes into
        `fused_moe_entry`'s logit-bias operand and its horizon's into the
        pre-gate, both built from the residency the segment finds (so a
        replay is rebuilt from the residency at that point). Degraded
        routing (link faults) takes the biased calls too."""
        ca = self.route_bias > 0.0 or self._degraded
        t0 = time.perf_counter()
        self.stats.steps += 1
        tok = torch.as_tensor(tok, device=self.device)
        caches, clen = list(state.caches), state.cache_len
        max_len = int(np.max(state.pos))     # the host mirror of clen
        segs, tail = self._sk_segments()
        n_segs = len(segs)
        logits = x = None

        predicted: Dict[int, set] = {}
        demand_hint: Dict[int, set] = {}   # li -> known demand after replay
        # pending: (li, seg_i, masks_dev, slot_snap, ready_snap, hint)
        pending: List[tuple] = []
        ckpt: Dict[int, tuple] = {}        # seg_i -> (x_in, [seg caches])
        self._window_layers.clear()
        self._evicted_spec.clear()

        def commit():
            pending.clear()
            ckpt.clear()
            self._window_layers.clear()

        def replay_from(fail_idx: int, needed_h):
            plj, psi = pending[fail_idx][0], pending[fail_idx][1]
            self.stats.replays += 1
            with self.tracer.span("replay", seg=psi):
                for kk, (_, cs_old) in ckpt.items():
                    if kk >= psi:
                        for jj, aj in enumerate(segs[kk]):
                            caches[aj] = cs_old[jj]
                x_r = ckpt[psi][0]
                for kk in [kk for kk in self._evicted_spec if kk[0] >= plj]:
                    del self._evicted_spec[kk]
                    self.prefetcher.note_unused(kk)
                    self.controller.record_overfetch()
                demand_hint[plj] = demand_hint.get(plj, set()) | {
                    int(e) for e in needed_h}
                predicted.clear()
                commit()
            return psi, x_r

        def pull_and_verify():
            """ONE blocking pull of every pending segment's mask block.
            Returns (fail_idx, fail_needed, sync_rows): fail_idx < 0 on
            success, with sync_rows the last segment's (1 + s, E) block."""
            masks_h = self._pull(torch.cat([pp[2] for pp in pending]))
            row = 0
            with self.tracer.span("verify", segs=len(pending)):
                for idx, (plj, _, mdev, snap, rsnap, hint) in enumerate(
                        pending):
                    needed = np.nonzero(masks_h[row])[0]
                    self._settle_prediction(plj, {int(e) for e in needed},
                                            ready_at_dispatch=rsnap)
                    if any(snap[int(e)] < 0 for e in needed):
                        # within a replay's hint a still-absent expert is
                        # capacity overflow, not a misprediction
                        if not (hint and {int(e) for e in needed} <= hint):
                            return idx, needed, None
                    row += mdev.shape[0]
            return -1, None, masks_h[row - pending[-1][2].shape[0]: row]

        replays0 = self.stats.replays
        si = 0
        while True:
            if si == n_segs:
                if pending:
                    fail, needed_h, _ = pull_and_verify()
                    if fail >= 0:
                        si, x = replay_from(fail, needed_h)
                        continue
                    commit()
                break
            with self.tracer.span("segment", seg=si,
                                  replay=self.stats.replays - replays0
                                  ) as span:
                li = si
                seg = segs[si]
                first = si == 0
                hint = demand_hint.pop(li, set())
                if hint:
                    self._retier(li, hint, {})
                    self.ensure_resident(li, sorted(hint))
                elif li in predicted:
                    self.ensure_resident(li, sorted(predicted[li]),
                                         speculative=True)
                sync = li not in predicted or bool(hint)
                span.set(sync=sync)
                s = self._horizon(li) if sync else 0
                if ca:
                    bias_this = self._residency_bias(li)
                    bias_next = self._pregate_bias(li, s) if s > 0 else None
                else:
                    bias_this, bias_next = self._zero_bias, None
                x_in = tok if first else x
                last = si == n_segs - 1
                ckpt[si] = (x_in, [caches[j] for j in seg])
                slot_map = self.table.layer_slot_map(li)
                with self.tracer.span("residency", "residency_s", kind="wait"):
                    self._wait_slots(slot_map, fused=True)
                    slot_map_dev = self._upload(slot_map)
                x, masks_dev, new_cs, lg = self._dispatch(
                    self._sk_seg, seg, [self._p[j] for j in seg],
                    [caches[j] for j in seg], x_in, clen, self.buffer,
                    slot_map_dev, self._router_stack[li + 1: li + 1 + s],
                    bias_this, active_dev, bias_next=bias_next, first=first,
                    with_logits=last and not tail, max_len=max_len)
                if last:
                    logits = lg
                for jj, aj in enumerate(seg):
                    caches[aj] = new_cs[jj]
                self._advance_clock()
                ready_snap = {kk: self.prefetcher.is_ready(kk, self._clock)
                              for kk in self._prefetch_pending if kk[0] == li}
                pending.append((li, si, masks_dev, slot_map, ready_snap,
                                hint))
                self._window_layers.add(li)
                if not sync:
                    self.stats.spec_layers += 1
                    si += 1
                    continue
                fail, needed_h, sync_rows = pull_and_verify()
                if fail >= 0:
                    si, x = replay_from(fail, needed_h)
                    continue
                needed, pred = self._decode_sync_rows(li, s, sync_rows)
                predicted.clear()
                predicted.update(pred)
                self._retier(li, needed, pred)
                # verified: LRU touches only, unless a hinted segment
                # overflowed capacity, in which case this books the miss
                self.ensure_resident(li, needed)
                if pred:
                    self.prefetch_window(
                        [(lj, sorted(es)) for lj, es in sorted(pred.items())])
                commit()
                si += 1

        if tail:
            with self.tracer.span("tail"):
                logits, new_tc = self._dispatch(
                    self._sk_tail, tail, [self._p[j] for j in tail],
                    [caches[j] for j in tail], x, clen, max_len=max_len)
            for jj, aj in enumerate(tail):
                caches[aj] = new_tc[jj]
        self._protect_early_layers()
        step_s = time.perf_counter() - t0
        self.controller.update_layer_time(step_s / max(len(self.specs), 1))
        self._fault_step_end(step_s)
        return logits, self._advance(state, caches, active_dev)

    # -- fully-resident decode oracle ---------------------------------------
    def reference_prefill(self, tokens) -> Tuple[torch.Tensor, DecodeState]:
        """Prefill through the SAME functions with the identity slot table
        over the full expert weights — no buffer, no swaps."""
        tokens = torch.as_tensor(tokens, device=self.device)
        B, T = tokens.shape
        x, positions = self._embed(tokens)
        caches: List[Any] = []
        li = 0
        for i, spec in enumerate(self.specs):
            p = self._p[i]
            if not spec.is_moe:
                x, c = layer_prefill(p, self.cfg, spec, x, positions,
                                     self.max_seq)
                caches.append(c)
                continue
            x, flat, r, _, c = self._pre_prefill(p, spec, x, positions)
            caches.append(c)
            x = self._ffn(p, self._full_experts(li), self._ident_map, x, flat,
                          r)
            li += 1
        return self._logits(x), DecodeState(
            caches, torch.tensor(T, device=self.device), pos=int(T))

    def reference_prefill_chunked(self, tokens,
                                  chunk_size: int = DEFAULT_PREFILL_CHUNK
                                  ) -> Tuple[torch.Tensor, DecodeState]:
        """Chunked prefill of one prompt through the SAME chunk functions
        with the identity slot table over the full expert weights — no
        buffer, no swaps. `prefill_chunked` must match it bitwise."""
        cursor = self.start_prefill(tokens, chunk_size)
        while not cursor.done:
            o, t, buf = self._next_chunk(cursor)
            x, positions, active = self._embed_chunk(buf, o, t)
            li = 0
            for i, spec in enumerate(self.specs):
                p = self._p[i]
                if not spec.is_moe:
                    x, _ = layer_prefill_chunk(p, self.cfg, spec, x,
                                               positions, cursor.caches[i],
                                               o, t)
                    continue
                x, flat, r, _, _ = self._pre_prefill_chunk(
                    p, spec, x, positions, cursor.caches[i], o, t, active)
                x = self._ffn(p, self._full_experts(li), self._ident_map, x,
                              flat, r)
                li += 1
            cursor.offset = o + t
        T = len(cursor.tokens)
        return self._logits_at(x, t - 1), DecodeState(
            cursor.caches, torch.tensor(T, device=self.device), pos=T)

    def reference_decode_step(self, tok, state: DecodeState
                              ) -> Tuple[torch.Tensor, DecodeState]:
        """One decode step of the fully-resident oracle (single-stream
        states only). The slot path must match it bitwise."""
        assert not state.batched, "reference_decode_step is single-stream"
        assert state.pos < self.max_seq, (
            f"decode past max_seq={self.max_seq} would wrap the KV ring "
            "buffer or overflow the positional latent cache")
        tok = torch.as_tensor(tok, device=self.device)
        caches, clen = list(state.caches), state.cache_len
        x = self._embed_decode(tok)
        li = 0
        for i, spec in enumerate(self.specs):
            p = self._p[i]
            if not spec.is_moe:
                x, caches[i] = layer_decode(p, self.cfg, spec, x, caches[i],
                                            clen)
                continue
            x2, flat, r, _, caches[i] = self._pre_decode(p, spec, x,
                                                         caches[i], clen)
            x = self._ffn(p, self._full_experts(li), self._ident_map, x2,
                          flat, r)
            li += 1
        return self._logits(x), DecodeState(caches, clen + 1,
                                            pos=state.pos + 1)

    def generate(self, tokens, n_steps: int, temperature: float = 0.0,
                 generator: Optional[torch.Generator] = None,
                 reference: bool = False) -> np.ndarray:
        """Prefill + n_steps - 1 decode steps. tokens: (B, T). Returns the
        generated ids (B, n_steps). Greedy by default."""
        do_prefill = self.reference_prefill if reference else self.prefill
        do_step = self.reference_decode_step if reference else self.decode_step
        logits, state = do_prefill(tokens)
        tok = sample(logits, generator, temperature)
        out = [tok.cpu().numpy()]
        for _ in range(1, n_steps):
            logits, state = do_step(tok, state)
            tok = sample(logits, generator, temperature)
            out.append(tok.cpu().numpy())
        return np.stack(out, axis=1)
