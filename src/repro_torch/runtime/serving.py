"""Serving on the slot-buffer engine: continuous batching over
`SlotBufferEngine`.

Same `Request` objects, `ContinuousBatcher` (with the working-set admission
cap fed by the engine's `StepSizeController`) and `ServingReport` as the
reference. Loop shape:

    admit   -> whole-prompt prefill into a free batch row (monolithic
               admission), then the first token
    decode  -> ONE batched `decode_step` over every occupied row
    sample  -> per-request temperature and generator (`sample_rows`)
    retire  -> finished rows free their slot for the next waiting request

Timing is wall-clock on the host; every decode iteration ends in a host
pull of its sampled tokens, so a step's time includes its device work.
Serving through the decode superkernel is
`ServingEngine(SlotBufferEngine(..., use_superkernel=True))`: the loop is
the same, the engine's `decode_step` takes the segment-fused path.
Chunked prefill is not ported yet: `prefill_chunk > 0` raises.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import List, Optional

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
    # working-set admission cap fed by the engine's controller
    admission_cap: bool = True
    max_iterations: int = 100_000
    # chunked prefill width; only 0 (monolithic admission) is ported so far
    prefill_chunk: int = 0
    # brownout admission: admissions pause while the single-replica
    # StragglerPolicy drains (decode-step EWMA past threshold x baseline)
    brownout_admission: bool = False
    brownout_threshold: float = 4.0
    brownout_recovery: float = 1.5


class ServingEngine:
    """Continuous-batching server over one `SlotBufferEngine`. `seed`
    seeds each request's sampling generator (with its request id)."""

    def __init__(self, engine: SlotBufferEngine,
                 cfg: Optional[EngineServingConfig] = None, seed: int = 17):
        self.engine = engine
        self.cfg = cfg or EngineServingConfig()
        if self.cfg.prefill_chunk > 0:
            raise NotImplementedError(
                "chunked prefill is not ported yet; use prefill_chunk=0")
        admission = None
        if self.cfg.admission_cap:
            L = max(len(engine.moe_layer_ids), 1)
            admission = WorkingSetAdmission(
                controller=engine.controller,     # the engine's OWN signals
                slots_per_layer=max(1, engine.n_slots // L),
                expert_bytes=engine._expert_nbytes,
                default_ws=float(engine.cfg.moe.top_k))
        self.straggler = StragglerPolicy(
            1, threshold=self.cfg.brownout_threshold,
            recovery=self.cfg.brownout_recovery)
        self.batcher = ContinuousBatcher(
            self.cfg.max_batch, admission=admission,
            brownout=(lambda: self.straggler.draining(0))
            if self.cfg.brownout_admission else None)
        self.seed = seed
        # per-row sampling state
        self._row_gen: List[Optional[torch.Generator]] = \
            [None] * self.cfg.max_batch
        self._row_temp = np.zeros(self.cfg.max_batch, np.float32)

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
        gen = None
        if req.temperature > 0.0:
            gen = torch.Generator(device=eng.device)
            gen.manual_seed(self.seed * 1_000_003 + req.request_id)
        tok = sample(logits, gen, req.temperature)
        self._row_gen[slot] = gen
        self._row_temp[slot] = max(float(req.temperature), 0.0)
        req.output.append(int(tok[0]))
        req.first_token_s = time.perf_counter() - self._t0
        report.run.add(StepMetrics(step=it,
                                   compute_s=req.first_token_s - t_start,
                                   step_size=eng.controller.s))

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
        for r in pending:
            if self.batcher.admission is not None and r.predicted_ws is None:
                r.predicted_ws = self.predict_working_set(r)
        self._t0 = time.perf_counter()
        it = 0

        def now() -> float:
            return time.perf_counter() - self._t0

        def finish(req: Request, slot: Optional[int] = None) -> None:
            # `slot` must be passed wherever the batcher has already retired
            # the request (step() clears req.slot)
            req.finish_s = now()
            eng.retire_slot(state, req.slot if slot is None else slot)
            report.add_request(request_metrics(req))

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

            for req in self.batcher.admit(now=tnow):
                self._admit_one(req, req.slot, state, now(), report, it)
                it += 1
                if req.done:          # 1-token request: done at prefill
                    finish(req)
                    self.batcher.release(req)

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
            for slot in active_slots:
                toks[slot] = self.batcher.active[slot].output[-1]
            logits, state = eng.decode_step(toks, state)
            sampled = sample_rows(logits, self._row_gen,
                                  self._row_temp).cpu().numpy()
            next_tokens = {slot: int(sampled[slot]) for slot in active_slots}
            slot_of = {self.batcher.active[s].request_id: s
                       for s in active_slots}
            for req in self.batcher.step(next_tokens):
                finish(req, slot_of[req.request_id])
            sm.compute_s = now() - t_step
            sm.n_misses = eng.stats.demand_misses - misses0
            sm.n_hits = eng.stats.prefetch_hits - hits0
            sm.n_prefetched = eng.stats.prefetched - pf0
            report.run.add(sm)
            self.straggler.record(0, sm.compute_s)

        report.makespan_s = now()
        report.mean_occupancy = self.batcher.stats.mean_occupancy
        report.n_shed = self.batcher.stats.shed
        return report
