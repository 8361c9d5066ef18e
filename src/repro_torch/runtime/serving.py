"""Serving on the slot-buffer engine: continuous batching over
`SlotBufferEngine`.

Same `Request` objects, `ContinuousBatcher` (with the working-set admission
cap fed by the engine's `StepSizeController`) and `ServingReport` as the
reference. Loop shape, with chunked admission (`prefill_chunk` > 0, the
default, 32 tokens):

    admit   -> open a prefill cursor for the request in a free batch row
    prefill -> ONE chunk of ONE cursor (shortest remaining first, with
               aging); a finished cursor is committed into its row and
               samples the first token
    decode  -> ONE batched `decode_step` over every fully-prefilled row
               (rows mid-prefill hold their slot but sit out)
    sample  -> per-request temperature and generator (`sample_rows`)
    retire  -> finished rows free their slot for the next waiting request

With `prefill_chunk = 0` admission is monolithic instead: the whole prompt
is prefilled into its row, and its first token sampled, inside the
admitting iteration (the head-of-line baseline chunked serving beats).

Timing is wall-clock on the host; every decode iteration ends in a host
pull of its sampled tokens, so a step's time includes its device work.
Each emitted token's time goes on its request (`Request.token_times_s`).
The loop's phases are spans of the engine's tracer (`serve.admit`,
`serve.prefill`, `serve.decode`, `serve.sample`, `serve.retire`, each with
its request ids), recorded when a `runtime.instrument.SpanLog` is
attached: `engine.tracer.log = SpanLog()`.
Serving through the decode superkernel is
`ServingEngine(SlotBufferEngine(..., use_superkernel=True))`: the loop is
the same, the engine's `decode_step` takes the segment-fused path.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.metrics import (RunReport, ServingReport, StepMetrics,
                                      request_metrics)
from repro_torch.distributed.fault_tolerance import StragglerPolicy
from repro_torch.models.moe import top_k_first_max
from repro_torch.runtime.batching import ContinuousBatcher, WorkingSetAdmission
from repro_torch.runtime.engine import SlotBufferEngine
from repro_torch.runtime.request import Request
from repro_torch.runtime.sampler import sample, sample_rows


@dataclass
class EngineServingConfig:
    max_batch: int = 4
    # working-set admission cap fed by the engine's controller, its budget
    # scaled by `admission_headroom`
    admission_cap: bool = True
    admission_headroom: float = 1.0
    max_iterations: int = 100_000
    # chunked prefill: prompt-chunk width interleaved with decode; 0 =
    # monolithic whole-prompt prefill at admission
    prefill_chunk: int = 32
    # aging bound of the shortest-remaining-first chunk scheduler: a cursor
    # passed over this many consecutive iterations is advanced regardless
    prefill_starve_limit: int = 4
    # record each request's logits rows, its prefill's and one per decode
    # step (tests, debugging): `ServingEngine.logits_trace`
    trace_logits: bool = False
    # §3.4 cache-aware routing, applied to the engine at construction (None
    # leaves the engine's own setting): `route_bias` is the strength delta
    # in router-logit units (router KL from unperturbed routing <= delta
    # nats; 0 turns it off), `route_bias_adaptive` makes it a ceiling that
    # the engine's StepSizeController ramps within
    route_bias: Optional[float] = None
    route_bias_adaptive: Optional[bool] = None
    # default per-request deadline, relative to arrival: a request still
    # queued past it is shed at admission (a request's own `deadline_s`
    # wins; None = never shed)
    deadline_s: Optional[float] = None
    # brownout admission: admissions pause while the single-replica
    # StragglerPolicy drains (decode-step EWMA past threshold x baseline),
    # or while the engine is fault-degraded or its watchdog tripped; the
    # queue head still enters an empty batch. None = on iff the engine was
    # built with a fault plan
    brownout_admission: Optional[bool] = None
    brownout_threshold: float = 4.0
    brownout_recovery: float = 1.5


class ServingEngine:
    """Continuous-batching server over one `SlotBufferEngine`. `seed`
    seeds each request's sampling generator (with its request id)."""

    def __init__(self, engine: SlotBufferEngine,
                 cfg: Optional[EngineServingConfig] = None, seed: int = 17):
        self.engine = engine
        self.cfg = cfg or EngineServingConfig()
        if self.cfg.route_bias is not None:
            engine.set_route_bias(
                self.cfg.route_bias,
                adaptive=bool(self.cfg.route_bias_adaptive))
        admission = None
        if self.cfg.admission_cap:
            L = max(len(engine.moe_layer_ids), 1)
            admission = WorkingSetAdmission(
                controller=engine.controller,     # the engine's OWN signals
                slots_per_layer=max(1, engine.n_slots // L),
                expert_bytes=engine._expert_nbytes,
                default_ws=float(engine.cfg.moe.top_k),
                headroom=self.cfg.admission_headroom)
        self.straggler = StragglerPolicy(
            1, threshold=self.cfg.brownout_threshold,
            recovery=self.cfg.brownout_recovery)
        brown = self.cfg.brownout_admission
        if brown is None:
            brown = engine.faults is not None
        self.batcher = ContinuousBatcher(
            self.cfg.max_batch, admission=admission,
            brownout=self._browned_out if brown else None)
        self.seed = seed
        self.logits_trace: Dict[int, List[np.ndarray]] = {}
        # per-row sampling state
        self._row_gen: List[Optional[torch.Generator]] = \
            [None] * self.cfg.max_batch
        self._row_temp = np.zeros(self.cfg.max_batch, np.float32)
        # in-flight chunked prefills: [(Request, PrefillCursor)]
        self._prefills: List = []
        self._chunked = (self.cfg.prefill_chunk > 0
                         and engine.chunked_prefill_supported)

    def _browned_out(self) -> bool:
        """The admission brownout signal: the straggler policy drains this
        (single) replica, or the engine runs degraded (link faults) or with
        its step watchdog tripped."""
        eng = self.engine
        return (self.straggler.draining(0) or eng._degraded
                or (eng.watchdog is not None and eng.watchdog.tripped))

    # -- admission-control working-set estimate -----------------------------
    def predict_working_set(self, req: Request) -> float:
        """Mean over MoE layers of the distinct experts the prompt's token
        embeddings route to (every router at once; no FFN compute)."""
        eng = self.engine
        prompt = torch.as_tensor(np.asarray(req.prompt, np.int64).reshape(-1),
                                 device=eng.device)
        x = eng.model.embed(eng.params, prompt).float()           # (T, d)
        logits = torch.einsum("td,lde->lte", x, eng._router_stack.float())
        _, ids = top_k_first_max(logits, eng.cfg.moe.top_k)        # (L, T, k)
        L, E = logits.shape[0], logits.shape[-1]
        hot = torch.zeros((L, E), dtype=torch.bool, device=eng.device)
        hot.scatter_(1, ids.reshape(L, -1), True)
        return float(hot.sum(dim=1).float().mean())

    # -- lifecycle helpers ---------------------------------------------------
    def _admit_one(self, req: Request, slot: int, state, now_s: float,
                   report: ServingReport, it: int) -> None:
        """Monolithic admission: whole-prompt prefill, then the first
        token — all inside one serving iteration."""
        req.admitted_s = now_s
        logits = self.engine.prefill_into(
            state, slot, np.asarray(req.prompt, np.int64)[None, :])
        req.prefill_done_s = time.perf_counter() - self._t0
        self._emit_first_token(req, slot, logits, now_s, report, it)

    def _emit_first_token(self, req: Request, slot: int, logits,
                          t_start: float, report: ServingReport,
                          it: int) -> None:
        """Sample the prompt's first output token and stamp TTFT."""
        eng = self.engine
        with eng.tracer.span("serve.sample", requests=[req.request_id]):
            gen = None
            if req.temperature > 0.0:
                gen = torch.Generator(device=eng.device)
                gen.manual_seed(self.seed * 1_000_003 + req.request_id)
            tok = sample(logits, gen, req.temperature)
            self._row_gen[slot] = gen
            self._row_temp[slot] = max(float(req.temperature), 0.0)
            req.output.append(int(tok[0]))
            req.first_token_s = time.perf_counter() - self._t0
            req.token_times_s.append(req.first_token_s)
            if self.cfg.trace_logits:
                self.logits_trace.setdefault(req.request_id, []).append(
                    logits[0].float().cpu().numpy())
        report.run.add(StepMetrics(step=it,
                                   compute_s=req.first_token_s - t_start,
                                   step_size=eng.controller.s))

    def _advance_prefill(self, state, report: ServingReport, it: int,
                         finish) -> None:
        """One chunk of ONE in-flight prefill cursor per serving iteration,
        shortest remaining first: a short prompt admitted behind a long one
        overtakes it chunk by chunk. A cursor passed over
        `prefill_starve_limit` consecutive iterations is advanced
        regardless, so a stream of shorter arrivals cannot starve a long
        prompt."""
        with self.engine.tracer.span("serve.prefill") as span:
            eng = self.engine
            t0 = time.perf_counter() - self._t0
            self._prefills.sort(key=lambda rc: rc[1].remaining)
            pick = max(range(len(self._prefills)),
                       key=lambda i: self._prefills[i][1].skipped)
            if self._prefills[pick][1].skipped < self.cfg.prefill_starve_limit:
                pick = 0                       # nobody starving: pure SRF
            req, cursor = self._prefills[pick]
            span.set(requests=[req.request_id])
            for _, other in self._prefills:
                other.skipped += 1
            cursor.skipped = 0
            eng.prefill_chunk(cursor)
            if not cursor.done:
                report.run.add(StepMetrics(
                    step=it, compute_s=(time.perf_counter() - self._t0) - t0,
                    step_size=eng.controller.s))
                return
            self._prefills.pop(pick)
            logits = eng.finish_prefill_into(state, req.slot, cursor)
            req.prefill_done_s = time.perf_counter() - self._t0
            self._emit_first_token(req, req.slot, logits, t0, report, it)
            if req.done:                 # 1-token request: done at prefill
                finish(req)
                self.batcher.release(req)

    # -- the serving loop ----------------------------------------------------
    def serve(self, requests: List[Request]) -> ServingReport:
        """Serve the request population to completion; returns a
        `ServingReport` (TTFT/TPOT/queue p50/p95/p99, throughput,
        occupancy) with wall-clock timings."""
        eng = self.engine
        cfg = self.cfg
        platform = eng.device.type
        report = ServingReport(
            run=RunReport(policy="engine", platform=platform,
                          model=eng.cfg.name),
            policy="engine", platform=platform, model=eng.cfg.name)
        state = eng.alloc_decode_state(cfg.max_batch)
        toks = np.zeros(cfg.max_batch, np.int64)
        pending = sorted(requests, key=lambda r: (r.arrival_s, r.request_id))
        for r in pending:
            # decode writes KV for all but the last sampled token
            if r.prompt_len + r.max_new_tokens - 1 > eng.max_seq:
                raise ValueError(
                    f"request {r.request_id}: prompt {r.prompt_len} + "
                    f"max_new {r.max_new_tokens} exceeds engine "
                    f"max_seq {eng.max_seq}; it would fail mid-decode")
        if cfg.deadline_s is not None:
            for r in pending:
                if r.deadline_s is None:
                    r.deadline_s = cfg.deadline_s
        tr = eng.tracer
        with tr.span("serve.admit", requests=[r.request_id for r in pending]):
            for r in pending:
                if self.batcher.admission is not None \
                        and r.predicted_ws is None:
                    r.predicted_ws = self.predict_working_set(r)
        # the engine's health counters are cumulative: diff around this run
        failures0 = eng.stats.link_failures
        retries0 = eng.stats.retries
        degraded0 = eng.stats.degraded_steps
        host_hits0 = eng.stats.host_hits
        host_misses0 = eng.stats.host_misses
        disk_stall0 = eng.stats.disk_stall_s
        integ0 = eng.integrity_counters()
        self._t0 = time.perf_counter()
        it = 0

        def now() -> float:
            return time.perf_counter() - self._t0

        def finish(req: Request, slot: Optional[int] = None) -> None:
            # `slot` must be passed wherever the batcher has already retired
            # the request (step() clears req.slot)
            req.finish_s = now()
            eng.retire_slot(state, req.slot if slot is None else slot)
            report.add_request(request_metrics(req), req.token_times_s)

        while pending or self.batcher.has_work:
            if it >= cfg.max_iterations:
                raise RuntimeError("serving exceeded max_iterations")
            tnow = now()
            while pending and pending[0].arrival_s <= tnow:
                self.batcher.submit(pending.pop(0))
            if not self.batcher.has_work:
                # nothing can happen before the next arrival
                time.sleep(max(pending[0].arrival_s - tnow, 1e-4))
                continue

            with tr.span("serve.admit") as span:
                admitted = self.batcher.admit(now=tnow)
                span.set(requests=[r.request_id for r in admitted])
                for req in admitted:
                    if self._chunked:
                        # admission only opens the cursor; chunks are
                        # scheduled one per iteration below
                        req.admitted_s = now()
                        self._prefills.append((req, eng.start_prefill(
                            np.asarray(req.prompt, np.int64),
                            cfg.prefill_chunk)))
                        continue
                    with tr.span("serve.prefill", requests=[req.request_id]):
                        self._admit_one(req, req.slot, state, now(), report,
                                        it)
                    it += 1
                    if req.done:          # 1-token request: done at prefill
                        finish(req)
                        self.batcher.release(req)

            if self._prefills:
                self._advance_prefill(state, report, it, finish)
                it += 1

            # decode advances fully-prefilled rows only (state.active)
            active_slots = [s for s in self.batcher.active_slots()
                            if state.active[s]]
            if not active_slots:
                continue

            # -- one batched decode iteration over all occupied rows --------
            t_step = now()
            sm = StepMetrics(step=it, step_size=eng.controller.s)
            it += 1
            misses0 = eng.stats.demand_misses
            hits0 = eng.stats.prefetch_hits
            pf0 = eng.stats.prefetched
            rows = [self.batcher.active[s] for s in active_slots]
            rids = [r.request_id for r in rows]
            for slot, req in zip(active_slots, rows):
                toks[slot] = req.output[-1]
            with tr.span("serve.decode", requests=rids):
                logits, state = eng.decode_step(toks, state)
            with tr.span("serve.sample", requests=rids):
                sampled = sample_rows(logits, self._row_gen,
                                      self._row_temp).cpu().numpy()
                t_tok = now()
                if cfg.trace_logits:
                    logits_h = logits.float().cpu().numpy()
                    for slot, rid in zip(active_slots, rids):
                        self.logits_trace.setdefault(rid, []).append(
                            logits_h[slot])
                for req in rows:
                    req.token_times_s.append(t_tok)
                done = self.batcher.step(
                    {slot: int(sampled[slot]) for slot in active_slots})
            if done:
                slot_of = dict(zip(rids, active_slots))
                with tr.span("serve.retire",
                             requests=[r.request_id for r in done]):
                    for req in done:
                        finish(req, slot_of[req.request_id])
            sm.compute_s = now() - t_step
            sm.n_misses = eng.stats.demand_misses - misses0
            sm.n_hits = eng.stats.prefetch_hits - hits0
            sm.n_prefetched = eng.stats.prefetched - pf0
            report.run.add(sm)
            self.straggler.record(0, sm.compute_s)

        report.makespan_s = now()
        report.mean_occupancy = self.batcher.stats.mean_occupancy
        report.n_link_failures = eng.stats.link_failures - failures0
        report.n_retries = eng.stats.retries - retries0
        report.n_degraded_steps = eng.stats.degraded_steps - degraded0
        report.n_shed = self.batcher.stats.shed
        report.n_host_hits = eng.stats.host_hits - host_hits0
        report.n_host_misses = eng.stats.host_misses - host_misses0
        report.disk_stall_s = eng.stats.disk_stall_s - disk_stall0
        integ = eng.integrity_counters()
        for k in ("n_corrupt_detected", "n_requarantined", "n_scrubbed"):
            setattr(report, k, int(integ[k] - integ0[k]))
        # quarantine is permanent: report the gauge, not a diff
        report.n_quarantined_experts = int(integ["n_quarantined_experts"])
        return report
