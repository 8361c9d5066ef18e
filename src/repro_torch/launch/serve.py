"""Serving driver: continuous batching + ExpertFlow runtime + simulator.

    PYTHONPATH=src python -m repro.launch.serve --arch deepseek-v2-lite \
        --requests 8 --max-new 12 --platform a6000 --workload poisson

Two backends behind ONE Request/Scheduler/Report surface:

- ``--backend sim`` (default): runs the real reduced-config model once per
  request (routing traces from actual execution on workload-generated
  prompts), trains the forest predictor on the collected traces, then
  replays the request population — with its arrival pattern — through the
  multi-tenant serving simulator under each policy, with platform timing
  constants. Reports modeled TTFT / TPOT / queueing / stall latencies.
- ``--backend engine``: serves the SAME workload's prompts directly on the
  real `SlotBufferEngine` via `runtime.serving.ServingEngine` — batched
  KV-cached decode through the shared expert slot buffer, adaptive
  prefetch horizon, working-set-capped admission — and reports measured
  wall-clock TTFT / TPOT / throughput, and the inter-token latency over
  every gap. `--spans <path>` also records the engine's and the server's
  host spans (`runtime.instrument.SpanLog`) and writes them as a Chrome
  trace (open it in Perfetto or chrome://tracing; its
  `baseTimeNanoseconds` is the wall-clock time the log started, so the
  events merge into a `torch.profiler` trace of the same process with
  `SpanLog.chrome_events(<that trace's baseTimeNanoseconds>)`).

Both emit the same `core.metrics.ServingReport`. `main` returns the
backend's reports (and, for the simulator, the inputs it replayed), so a
caller in the same process can read them.
"""
from __future__ import annotations

import argparse
import json

import numpy as np

from repro_torch.configs.registry import get_smoke_config
from repro_torch.core import (FeatureSpec, ForestPredictor, TraceLog,
                              baseline, expertflow, pregate_fixed,
                              promoe_like)
from repro_torch.core.faults import FaultPlan
from repro_torch.data.workloads import (WORKLOAD_PATTERNS, make_workload,
                                        prompt_tokens)
from repro_torch.runtime.engine import Engine
from repro_torch.simulator.events import SimSpec
from repro_torch.simulator.hardware import (PLATFORMS, expert_bytes,
                                            layer_time_decode)
from repro_torch.simulator.serving import (ServingConfig, ServingRequest,
                                           ServingWorkload, simulate_serving)


def _pad_to_bucket(toks: np.ndarray, bucket: int = 16) -> np.ndarray:
    """Right-pad prompts to bucket multiples (the reference's prompt
    shapes)."""
    T = len(toks)
    padded = ((T + bucket - 1) // bucket) * bucket
    if padded == T:
        return toks
    return np.concatenate([toks, np.zeros(padded - T, toks.dtype)])


def _serve_engine(args, cfg, specs, rng) -> dict:
    """--backend engine: the request population on the real slot-path
    runtime under continuous batching."""
    from repro_torch.runtime.engine import SlotBufferEngine
    from repro_torch.runtime.instrument import SpanLog
    from repro_torch.runtime.request import Request
    from repro_torch.runtime.serving import (EngineServingConfig,
                                             ServingEngine)

    requests = []
    for spec_r in specs:
        n_steps = max(2, min(spec_r.decode_len, args.max_new))
        toks = _pad_to_bucket(prompt_tokens(spec_r, cfg.vocab_size, rng))
        requests.append(Request(
            prompt=toks.astype(np.int32), max_new_tokens=n_steps,
            temperature=args.temperature, arrival_s=spec_r.arrival_s,
            request_id=spec_r.request_id))
    max_seq = max(r.prompt_len for r in requests) + args.max_new + 8
    eng = Engine(cfg, max_seq=max_seq, device=args.device)
    slots = max(2, int(cfg.moe.num_experts * args.capacity_frac))
    plan = FaultPlan.from_arg(args.fault_plan)
    store = None
    if args.expert_store_dir:
        # disk->host->device tiered expert store (core.expert_tiers):
        # export shards on first use, then serve through the budgeted
        # host staging tier instead of the pre-staged HostExpertStore
        import os

        from repro_torch.core.expert_tiers import (SHARD_MANIFEST,
                                                   TieredExpertStore,
                                                   export_expert_shards)
        from repro_torch.runtime.engine import build_host_store
        sdir = args.expert_store_dir
        if not os.path.exists(os.path.join(sdir, SHARD_MANIFEST)):
            export_expert_shards(build_host_store(eng.model, eng.params),
                                 sdir)
            print(f"exported expert shards to {sdir}")
        budget = (args.host_budget_mb * 1e6
                  if args.host_budget_mb is not None else None)
        store = TieredExpertStore(sdir, host_budget_bytes=budget,
                                  disk_bandwidth=args.disk_bandwidth,
                                  verify=args.verify,
                                  scrub_budget=args.scrub_budget)
        print(f"tiered store: {store.total_expert_bytes/1e6:.1f}MB experts, "
              f"host budget "
              f"{store.model.host_budget_bytes/1e6:.1f}MB, "
              f"disk_bw={args.disk_bandwidth:g}B/tick, "
              f"verify={store.verify}")
    sb = SlotBufferEngine(cfg, eng.params, eng.model,
                          n_slots_per_layer=slots, max_seq=max_seq,
                          faults=plan, retry_max=args.retry_max,
                          retry_backoff_s=args.retry_backoff,
                          store=store, device=args.device)
    srv = ServingEngine(sb, EngineServingConfig(
        max_batch=args.batch, prefill_chunk=args.prefill_chunk,
        route_bias=args.route_bias,
        route_bias_adaptive=args.route_bias_adaptive,
        deadline_s=args.deadline))
    if args.spans:
        sb.tracer.log = SpanLog()
    rep = srv.serve(requests)
    s = rep.summary()
    print(f"engine backend: slots/layer={slots} batch={args.batch} "
          f"S={sb.controller.s} "
          f"route_bias={args.route_bias}"
          f"{'(adaptive)' if args.route_bias_adaptive else ''} "
          f"prefill_chunk={args.prefill_chunk if srv._chunked else 'mono'}")
    print(f"  {'engine':14s} tput={s['throughput_tok_s']:8.1f}tok/s "
          f"ttft_p50={s['ttft_p50_s']*1e3:8.3f}ms "
          f"ttft_p99={s['ttft_p99_s']*1e3:8.3f}ms "
          f"tpot_p50={s['tpot_p50_s']*1e3:7.3f}ms "
          f"tpot_p99={s['tpot_p99_s']*1e3:7.3f}ms "
          f"occ={s['mean_occupancy']:.2f} "
          f"deferred={srv.batcher.stats.admission_deferred}")
    print(f"  ttft split: queue={s['ttft_queue_mean_s']*1e3:.3f}ms "
          f"prefill={s['ttft_prefill_mean_s']*1e3:.3f}ms "
          f"first_step={s['ttft_first_step_mean_s']*1e3:.3f}ms")
    itl = rep.itl()
    print(f"  itl (every gap): p50={itl['p50']*1e3:.3f}ms "
          f"p95={itl['p95']*1e3:.3f}ms p99={itl['p99']*1e3:.3f}ms")
    if args.spans:
        log = sb.tracer.log
        base = log.anchor[1]
        with open(args.spans, "w") as f:
            json.dump({"traceEvents": log.chrome_events(base),
                       "baseTimeNanoseconds": base,
                       "displayTimeUnit": "ms"}, f)
        print(f"  spans: {len(log.records)} written to {args.spans} "
              f"({log.dropped} past the log's capacity)")
    if plan is not None:
        print(f"  health: link_failures={s['n_link_failures']} "
              f"retries={s['n_retries']} "
              f"degraded_steps={s['n_degraded_steps']} "
              f"shed={s['n_shed']}")
    if store is not None:
        print(f"  tier: host_hits={s['n_host_hits']} "
              f"host_misses={s['n_host_misses']} "
              f"disk_stall={s['disk_stall_s']:.3f} link-units "
              f"({store.snapshot()['promotions']:.0f} promotions)")
        if store.verify != "off":
            print(f"  integrity: corrupt_detected={s['n_corrupt_detected']} "
                  f"requarantined={s['n_requarantined']} "
                  f"scrubbed={s['n_scrubbed']} "
                  f"quarantined={s['n_quarantined_experts']}")
    return {"backend": "engine", "report": rep, "engine": sb}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="deepseek-v2-lite")
    ap.add_argument("--backend", default="sim", choices=("sim", "engine"),
                    help="latency simulator vs the real slot-path engine")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4,
                    help="continuous-batching slots (max batch)")
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--platform", default="a6000",
                    choices=sorted(PLATFORMS))
    ap.add_argument("--capacity-frac", type=float, default=0.6)
    ap.add_argument("--workload", default="poisson",
                    choices=list(WORKLOAD_PATTERNS))
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="engine backend: per-request sampling temperature")
    ap.add_argument("--prefill-chunk", type=int, default=32,
                    help="engine backend: fixed prompt-chunk width "
                         "interleaved with decode (0 = monolithic prefill)")
    ap.add_argument("--route-bias", type=float, default=0.0,
                    help="cache-aware routing strength delta (router-logit "
                         "units; router KL vs unperturbed <= delta nats). "
                         "0 = off (bit-exact routing)")
    ap.add_argument("--route-bias-adaptive", action="store_true",
                    help="let the step-size controller ramp the routing "
                         "bias within [0, --route-bias] from its "
                         "stall/overfetch thresholds")
    ap.add_argument("--fault-plan", default=None,
                    help="fault-injection plan: preset name "
                         f"({'/'.join(FaultPlan.PRESETS)}), inline JSON, "
                         "or a JSON file path. Unset = no fault layer "
                         "(bit-exact)")
    ap.add_argument("--deadline", type=float, default=None,
                    help="per-request SLO deadline in seconds (relative to "
                         "arrival); queued requests past it are shed")
    ap.add_argument("--retry-max", type=int, default=3,
                    help="bounded retries for failed demand swap-ins "
                         "before degrading to resident-only routing")
    ap.add_argument("--retry-backoff", type=float, default=1e-3,
                    help="base exponential-backoff delay (s) between "
                         "demand-transfer retries")
    ap.add_argument("--expert-store-dir", default=None,
                    help="serve experts through the disk->host->device "
                         "tiered store rooted here (engine backend; shards "
                         "are exported on first use). Unset = pre-staged "
                         "host store (bit-exact pre-tier behavior)")
    ap.add_argument("--host-budget-mb", type=float, default=None,
                    help="host staging tier byte budget in MB (default: "
                         "everything fits). Engine backend uses it "
                         "directly; sim backend converts to a fraction of "
                         "total expert bytes")
    ap.add_argument("--disk-bandwidth", type=float, default=2e9,
                    help="disk->host promotion link bandwidth (bytes per "
                         "link-clock unit: engine ticks once per MoE "
                         "layer; sim uses modeled seconds)")
    ap.add_argument("--verify", default="off",
                    choices=("off", "promote", "scrub"),
                    help="expert integrity: verify disk->host promotions "
                         "against the shard manifest's per-record CRCs "
                         "(promote), plus budgeted background re-"
                         "verification of host-resident copies (scrub). "
                         "off = pre-feature behavior (bit-exact)")
    ap.add_argument("--scrub-budget", type=int, default=2,
                    help="host-copy re-verifications per idle scrubber "
                         "tick (--verify scrub)")
    ap.add_argument("--spans", default=None,
                    help="engine backend: write the engine's and the "
                         "server's host spans here as a Chrome trace (JSON)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device the model runs on (cuda or cpu)")
    args = ap.parse_args(argv)
    if args.requests < 1:
        ap.error("--requests must be >= 1")
    if args.max_new < 2:
        ap.error("--max-new must be >= 2 (need at least one decode step)")

    cfg = get_smoke_config(args.arch)
    hw = PLATFORMS[args.platform]

    # deployment capacity plan for the FULL architecture on this platform
    from repro_torch.configs.registry import get_config
    from repro_torch.core.capacity_planner import plan
    full_cfg = get_config(args.arch)
    cap_plan = plan(full_cfg, hw, batch=args.batch, kv_len=1024)
    print(f"capacity plan ({full_cfg.name} on {hw.name}): "
          f"{cap_plan.summary()}")

    rng = np.random.default_rng(args.seed)
    specs = make_workload(args.workload, args.requests, seed=args.seed,
                          mean_decode=args.max_new)

    if args.backend == "engine":
        return _serve_engine(args, cfg, specs, rng)

    eng = Engine(cfg, max_seq=256, device=args.device)

    # --- collect a real routing trace per request -------------------------
    requests = []
    all_logs = TraceLog()
    for spec_r in specs:
        n_steps = max(2, min(spec_r.decode_len, args.max_new))
        toks = _pad_to_bucket(prompt_tokens(spec_r, cfg.vocab_size, rng))
        _, trace, log = eng.generate(toks[None, :], n_steps=n_steps)
        all_logs.extend(log.samples)
        requests.append(ServingRequest(
            prompt_len=spec_r.prompt_len, max_new_tokens=n_steps,
            steps=trace.steps, arrival_s=spec_r.arrival_s,
            request_id=spec_r.request_id, topic=spec_r.topic))
    L, M = trace.num_moe_layers, trace.num_experts
    print(f"collected {len(requests)} request traces "
          f"({sum(len(r.steps) for r in requests)} decode steps, "
          f"workload={args.workload})")

    # --- predictor training on collected traces ---------------------------
    spec = FeatureSpec(cfg.vocab_size, 16, L, M, include_pregate=True)
    forest = ForestPredictor(spec)
    mse = forest.fit(all_logs)
    print(f"forest trained on {len(all_logs.samples)} samples, mse={mse:.4f}")

    # --- policy comparison under shared-cache serving ----------------------
    ebytes = expert_bytes(cfg)
    sim = SimSpec(
        expert_bytes=max(ebytes, 4e6),   # floor so transfers are visible
        layer_time_s=layer_time_decode(cfg, hw, args.batch, 64),
        capacity_experts=max(4, int(L * M * args.capacity_frac)))
    scfg = ServingConfig(max_batch=args.batch,
                         fault_plan=FaultPlan.from_arg(args.fault_plan),
                         retry_max=args.retry_max,
                         retry_backoff_s=args.retry_backoff,
                         deadline_s=args.deadline,
                         verify=args.verify,
                         scrub_budget=args.scrub_budget)
    if args.host_budget_mb is not None:
        scfg.host_budget_frac = min(
            1.0, args.host_budget_mb * 1e6 / (sim.expert_bytes * L * M))
        scfg.disk_bandwidth = args.disk_bandwidth
        print(f"host tier: budget_frac={scfg.host_budget_frac:.2f} "
              f"disk_bw={scfg.disk_bandwidth:g}B/s")
    print(f"platform={hw.name} expert_bytes={sim.expert_bytes/1e6:.1f}MB "
          f"layer_time={sim.layer_time_s*1e3:.3f}ms "
          f"capacity={sim.capacity_experts}/{L*M} slots={args.batch}")
    wl = ServingWorkload(L, M, trace.top_k, eng.routers(),
                         requests, model=cfg.name, name=args.workload)
    policies = [baseline(), pregate_fixed(2), promoe_like(2), expertflow()]
    if args.route_bias > 0.0:
        # the engine backend's routing perturbation, mirrored trace-level
        ef_rb = expertflow()
        ef_rb.name = f"expertflow_rb{args.route_bias:g}"
        ef_rb.route_bias = args.route_bias
        policies.append(ef_rb)
    reports = {}
    for pol in policies:
        rep = simulate_serving(wl, sim, hw, pol, forest=forest, cfg=scfg)
        s = rep.summary()
        reports[s["policy"]] = rep
        print(f"  {s['policy']:14s} stall={s['stall_s']*1e3:9.3f}ms "
              f"ttft_p50={s['ttft_p50_s']*1e3:8.3f}ms "
              f"ttft_p99={s['ttft_p99_s']*1e3:8.3f}ms "
              f"tpot_p50={s['tpot_p50_s']*1e3:7.3f}ms "
              f"tpot_p99={s['tpot_p99_s']*1e3:7.3f}ms "
              f"hit={s['hit_rate']:.3f} occ={s['mean_occupancy']:.2f}")
        if args.fault_plan is not None:
            print(f"  {'':14s} health: "
                  f"link_failures={s['n_link_failures']} "
                  f"retries={s['n_retries']} "
                  f"degraded_steps={s['n_degraded_steps']} "
                  f"shed={s['n_shed']}")
        if scfg.host_budget_frac is not None:
            print(f"  {'':14s} tier: host_hits={s['n_host_hits']} "
                  f"host_misses={s['n_host_misses']} "
                  f"disk_stall={s['disk_stall_s']*1e3:.3f}ms")
            if scfg.verify != "off":
                print(f"  {'':14s} integrity: "
                      f"corrupt_detected={s['n_corrupt_detected']} "
                      f"requarantined={s['n_requarantined']} "
                      f"scrubbed={s['n_scrubbed']} "
                      f"quarantined={s['n_quarantined_experts']}")
    return {"backend": "sim", "reports": reports, "workload": wl,
            "sim": sim, "hw": hw, "cfg": scfg, "policies": policies,
            "forest": forest, "log": all_logs, "mse": mse}


if __name__ == "__main__":
    main()
