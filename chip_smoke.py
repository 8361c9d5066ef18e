#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed on its own lines; any failure exits non-zero before
the last line:

1. environment: the card's name and power limit (nvidia-smi);
2. build: every CUDA kernel of the serving path, from `src/repro_torch/
   kernels/csrc`, one nvcc per source, all at once;
3. kernels: each kernel against its plain PyTorch version on the card at
   the serving path's shapes (olmoe-1b-7b decode at batch 4, prefill of a
   128-token prompt, and a ragged shape), tolerance 2e-2, with CUDA-event
   medians of the kernel, the plain version and a library yardstick, and
   the kernel's bound (the larger of needed bytes / 3.35 TB/s and needed
   bf16 FLOPs / 989 TFLOP/s, H100 SXM peaks);
4. serving: olmoe-1b-7b at its published widths (16 layers, weights drawn
   from a seed on the card), 16 expert slots per layer, `slot_ffn` on,
   8 greedy requests of 64-128 prompt tokens and 16 new tokens at batch 4
   through `ServingEngine`. Kernel launch counts are zeroed just before and
   read just after; every prefill and decode step must launch `slot_ffn`
   once per MoE layer at least, and experts must be swapped in and evicted;
5. oracle: one prompt decoded single-stream through the slot path must give
   logits bitwise equal to the fully-resident reference path, and every
   served request's tokens must match the reference's unless the
   reference's top two logits are within 5e-2 (a near-tie);
6. a `{"kernels": [...]}` line, then the last line
   `{"ok": true, "device": {...}}`.

Exits with code 2 and prints no result without a CUDA device or outside a
checkout of the repository.
"""
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
H100_BYTES_PER_S = 3.35e12        # HBM3, H100 SXM data sheet
H100_BF16_FLOP_PER_S = 989e12     # dense bf16 tensor cores, H100 SXM
TOL = 2e-2
SEED = 0


def log(*a):
    print(*a, flush=True)


def check(cond, what):
    if not cond:
        raise SystemExit(f"chip_smoke FAILED: {what}")


def time_ms(torch, fn, reps=5, inner=5):
    """Median over `reps` CUDA-event windows of `inner` back-to-back calls,
    per call, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(inner):
            fn()
        e.record()
        e.synchronize()
        out.append(s.elapsed_time(e) / inner)
    return statistics.median(out)


# --------------------------------------------------------------- phase 3

def slot_ffn_inputs(torch, moe_mod, g, *, B, T, k, E, D, F, S, resident_frac):
    """A dispatch buffer and slot table shaped as the serving path builds
    them: T*B tokens route to k distinct experts each, the buffer holds
    capacity B*T*k rows per expert (the rest zero padding), routed experts
    sit in distinct slots, and a share of the others is resident too (the
    rest point at slot 0, as `moe_slotbuf` clamps non-resident entries)."""
    dev = "cuda"
    n = B * T
    x_tok = torch.randn((n, D), generator=g, device=dev).to(torch.bfloat16)
    logits = torch.randn((n, E), generator=g, device=dev)
    _, ids = moe_mod.top_k_first_max(logits, k)
    buf = moe_mod._dispatch_gather(x_tok, ids, E, n * k)[0].contiguous()
    routed = torch.zeros(E, dtype=torch.bool, device=dev)
    routed[ids.reshape(-1)] = True
    keep = routed | (torch.rand(E, generator=g, device=dev) < resident_frac)
    perm = torch.randperm(S, generator=g, device=dev)[:E].to(torch.int32)
    slot = torch.where(keep, perm, torch.zeros_like(perm)).contiguous()
    w = lambda *s: (torch.randn(s, generator=g, device=dev)  # noqa: E731
                    * s[-2] ** -0.5).to(torch.bfloat16)
    wg, wu, wd = w(S, D, F), w(S, D, F), w(S, F, D)
    return (buf, slot, wg, wu, wd), slot[routed]


def kernel_phase(torch, moe_mod, slot_gather, ref):
    import torch.nn.functional as Fn
    g = torch.Generator(device="cuda").manual_seed(SEED)

    def library(x, slot, wg, wu, wd):
        # yardstick only: a slot gather + torch.bmm chain (bf16 throughout)
        idx = slot.long()
        h = Fn.silu(torch.bmm(x, wg[idx])) * torch.bmm(x, wu[idx])
        return torch.bmm(h, wd[idx]).float()

    shapes = {
        "decode": dict(B=4, T=1, k=8, E=64, D=2048, F=1024, S=256,
                       resident_frac=0.25),
        "prefill": dict(B=1, T=128, k=8, E=64, D=2048, F=1024, S=256,
                        resident_frac=0.25),
        "ragged": dict(B=1, T=5, k=2, E=3, D=96, F=40, S=4,
                       resident_frac=1.0),
    }
    results = {}
    for name, sh in shapes.items():
        args, routed_slots = slot_ffn_inputs(torch, moe_mod, g, **sh)
        x = args[0]
        E, C, D = x.shape
        F = args[2].shape[-1]
        got = slot_gather.slot_ffn(*args)
        want = ref.slot_ffn_ref(*args)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        ok = torch.allclose(got, want, rtol=TOL, atol=TOL)
        check(ok, f"slot_ffn disagrees with its plain version at {name}: "
                  f"max |err| {err}")
        rows = sh["B"] * sh["T"] * sh["k"]           # rows holding tokens
        distinct = int(torch.unique(routed_slots).numel())
        nbytes = (x.numel() * 2 + E * C * D * 4 + E * 4
                  + distinct * 3 * D * F * 2)
        flops = 2 * 3 * D * F * rows
        t_bytes = nbytes / H100_BYTES_PER_S * 1e3
        t_flops = flops / H100_BF16_FLOP_PER_S * 1e3
        dense_ms = 2 * 3 * D * F * E * C / H100_BF16_FLOP_PER_S * 1e3
        heavy = E * C * D > 2 ** 26
        r = {
            "shape": {"E": E, "C": C, "D": D, "F": F,
                      "S": args[2].shape[0]},
            "max_abs_err": err,
            "ms": time_ms(torch, lambda: slot_gather.slot_ffn(*args)),
            "plain_ms": time_ms(torch, lambda: ref.slot_ffn_ref(*args),
                                reps=3, inner=2 if heavy else 5),
            "library_ms": time_ms(torch, lambda: library(*args)),
            "bound_ms": max(t_bytes, t_flops),
            "bound_by": "bytes" if t_bytes >= t_flops else "operations",
            "needed_rows": rows, "distinct_routed_slots": distinct,
            "dense_rows_flop_ms": dense_ms,
        }
        results[name] = r
        log(f"kernel slot_ffn {name} {r['shape']}: max|err| {err:.3g}, "
            f"kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
            f"gather+bmm {r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f}"
            f" ms ({r['bound_by']}; all {E * C} rows dense: "
            f"{dense_ms:.4f} ms)")
        del args, got, want
        torch.cuda.empty_cache()
    return results


# --------------------------------------------------------------- phase 4/5

def serving_phase(torch, np, mods):
    cfg = mods["get_config"]("olmoe-1b-7b")
    Model, SlotBufferEngine = mods["Model"], mods["SlotBufferEngine"]
    slot_ffn = mods["slot_gather"].slot_ffn
    model = Model(cfg)
    t0 = time.perf_counter()
    g = torch.Generator(device="cuda").manual_seed(SEED)
    params = model.init(g, device="cuda")
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    t0 = time.perf_counter()
    eng = SlotBufferEngine(cfg, params, model, n_slots_per_layer=16,
                           use_kernel=True, max_seq=256, device="cuda")
    del params                      # the experts now live in pinned memory
    torch.cuda.empty_cache()
    t_engine = time.perf_counter() - t0
    log(f"serving: olmoe-1b-7b, {cfg.num_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.moe.num_experts} experts top-{cfg.moe.top_k}; "
        f"init {t_init:.1f} s on the card, host store "
        f"{eng.store.nbytes / 1e9:.2f} GB pinned ({t_engine:.1f} s), slot "
        f"buffer {eng.n_slots} slots = "
        f"{eng.n_slots * cfg.expert_bytes() / 1e9:.2f} GB")

    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab_size, int(n))
               for n in rng.integers(64, 129, 8)]
    Request = mods["Request"]
    reqs = [Request(p, max_new_tokens=16) for p in prompts]
    srv = mods["ServingEngine"](eng, mods["EngineServingConfig"](
        max_batch=4, admission_cap=False))

    # per-call launch counts through shims on the engine instance
    per = {"prefill": [], "decode": [], "decode_syncs": []}
    orig_prefill, orig_step = eng.prefill, eng.decode_step

    def prefill(tokens):
        n0 = slot_ffn.launches
        out = orig_prefill(tokens)
        per["prefill"].append(slot_ffn.launches - n0)
        return out

    def decode_step(tok, state):
        n0, s0 = slot_ffn.launches, eng.stats.host_syncs
        out = orig_step(tok, state)
        per["decode"].append(slot_ffn.launches - n0)
        per["decode_syncs"].append(eng.stats.host_syncs - s0)
        return out

    eng.prefill, eng.decode_step = prefill, decode_step
    eng.stats.reset()
    slot_ffn.launches = 0                      # the main path's count
    t0 = time.perf_counter()
    report = srv.serve(reqs)
    eng.synchronize()
    wall = time.perf_counter() - t0
    launches = slot_ffn.launches
    eng.prefill, eng.decode_step = orig_prefill, orig_step

    st = eng.stats
    summ = report.summary()
    n_moe = len(eng.moe_layer_ids)
    for r in reqs:
        check(len(r.output) == 16 and all(0 <= t < cfg.vocab_size
                                          for t in r.output),
              f"request {r.request_id} output {r.output}")
    check(launches > 0, "slot_ffn was never launched on the serving path")
    check(min(per["prefill"]) >= n_moe and min(per["decode"]) >= n_moe,
          f"slot_ffn launches per prefill {per['prefill']} / per decode "
          f"step {per['decode']} fall below {n_moe}")
    check(st.swap_experts > 0 and st.evictions > 0,
          f"no churn: swapped {st.swap_experts}, evicted {st.evictions}")
    gbps = st.swap_bytes / st.copy_s / 1e9 if st.copy_s > 0 else float("nan")
    serving = {
        "requests": len(reqs), "batch": 4,
        "prompt_tokens": [int(len(p)) for p in prompts],
        "new_tokens": 16, "wall_s": wall,
        "ttft_p50_s": summ["ttft_p50_s"], "tpot_p50_s": summ["tpot_p50_s"],
        "throughput_tok_s": summ["throughput_tok_s"],
        "slot_ffn_launches": launches,
        "launches_per_prefill": per["prefill"],
        "launches_per_decode_step_mean": float(np.mean(per["decode"])),
        "decode_steps": len(per["decode"]),
        "host_syncs_per_decode_step": float(np.mean(per["decode_syncs"])),
        "replays": st.replays, "spec_layers": st.spec_layers,
        "swap_experts": st.swap_experts, "evictions": st.evictions,
        "demand_misses": st.demand_misses, "prefetched": st.prefetched,
        "prefetch_hits": st.prefetch_hits,
        "swapped_bytes": st.swap_bytes, "copy_s": st.copy_s,
        "h2d_GBps": gbps,
        "peak_device_GB": torch.cuda.max_memory_allocated() / 1e9,
        "controller_s_history": list(eng.controller.s_history),
    }
    log(f"serving: {len(reqs)} requests done in {wall:.2f} s; TTFT p50 "
        f"{serving['ttft_p50_s'] * 1e3:.1f} ms, TPOT p50 "
        f"{serving['tpot_p50_s'] * 1e3:.1f} ms, "
        f"{serving['throughput_tok_s']:.1f} tok/s")
    log(f"serving: slot_ffn launches {launches} (per prefill "
        f"{per['prefill']}, per decode step mean "
        f"{serving['launches_per_decode_step_mean']:.2f} over "
        f"{len(per['decode'])} steps); host syncs per decode step "
        f"{serving['host_syncs_per_decode_step']:.2f}; replays {st.replays}")
    log(f"serving: swapped {st.swap_experts} experts = "
        f"{st.swap_bytes / 1e9:.2f} GB in {st.copy_s:.3f} s of copies "
        f"({gbps:.2f} GB/s host->device), {st.evictions} evictions")
    log("serving: " + json.dumps(serving))

    # ---- phase 5: oracle checks ------------------------------------------
    prompt = prompts[0][None, :]
    lg, s_slot = eng.prefill(prompt)
    lr, s_ref = eng.reference_prefill(prompt)
    worst = float((lg - lr).abs().max())
    toks_slot, toks_ref = [], []
    for _ in range(16):
        toks_slot.append(int(lg.argmax(-1)[0]))
        toks_ref.append(int(lr.argmax(-1)[0]))
        tok = lr.argmax(-1)
        lg, s_slot = eng.decode_step(tok, s_slot)
        lr, s_ref = eng.reference_decode_step(tok, s_ref)
        worst = max(worst, float((lg - lr).abs().max()))
    check(worst == 0.0 and toks_slot == toks_ref,
          f"slot path differs from the fully-resident oracle: max |dlogit| "
          f"{worst}, tokens {toks_slot} vs {toks_ref}")
    log(f"oracle: single-stream slot path bitwise equal to the fully-"
        f"resident reference over prefill + 16 decode steps "
        f"(tokens {toks_slot[:8]}...)")
    near_ties = 0
    for r, p in zip(reqs, prompts):
        lr, s_ref = eng.reference_prefill(p[None, :])
        for step, t in enumerate(r.output):
            row = lr[0].float().cpu().numpy()
            want = int(row.argmax())
            if t != want:
                top2 = np.sort(row)[-2:]
                check(top2[1] - top2[0] <= 5e-2,
                      f"request {r.request_id} step {step}: served {t}, "
                      f"reference {want}, top-2 gap {top2[1] - top2[0]}")
                near_ties += 1
                break
            lr, s_ref = eng.reference_decode_step(
                torch.tensor([t], device="cuda"), s_ref)
    log(f"oracle: served streams match single-request reference decoding "
        f"({near_ties} stream(s) part at a near-tie)")
    eng.drop_resident_experts()
    serving["oracle_bitwise"] = True
    serving["served_streams_near_ties"] = near_ties
    return serving, launches


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to run", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from a "
              "checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import numpy as np
    torch.backends.cuda.matmul.allow_tf32 = False   # plain versions in fp32
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    # ---- phase 1: environment ----------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    log(smi[0])
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    # ---- phase 2: build ------------------------------------------------------
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    secs = build.build_all()
    log(f"build: {json.dumps(secs)} ({time.perf_counter() - t0:.1f} s wall)")
    for name, out in build.LIBS.build_log.items():
        for line in out.splitlines():
            if "registers" in line or "spill" in line:
                log(f"build {name}: {line.strip()}")

    from repro_torch.configs import get_config
    from repro_torch.kernels import ref, slot_gather
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.transformer import Model
    from repro_torch.runtime.engine import SlotBufferEngine
    from repro_torch.runtime.request import Request
    from repro_torch.runtime.serving import EngineServingConfig, ServingEngine

    # ---- phase 3: kernels against their plain versions ----------------------
    kres = kernel_phase(torch, moe_mod, slot_gather, ref)

    # ---- phases 4-5: serving at published widths, oracle -----------------
    serving, launches = serving_phase(torch, np, dict(
        get_config=get_config, Model=Model, SlotBufferEngine=SlotBufferEngine,
        Request=Request, ServingEngine=ServingEngine,
        EngineServingConfig=EngineServingConfig, slot_gather=slot_gather))

    dec = kres["decode"]
    kernels = {"kernels": [{
        "name": "slot_ffn", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/slot_ffn.cu",
        "replaces": "src/repro/kernels/slot_gather.py:72",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in kres.values()),
        "ms": dec["ms"], "plain_ms": dec["plain_ms"],
        "bound_ms": dec["bound_ms"], "bound_by": dec["bound_by"],
        "library_ms": dec["library_ms"],
        "shapes": kres,
    }]}
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(
        {"gpu": smi[0], "kernels": kernels["kernels"], "serving": serving,
         "total_s": time.perf_counter() - t_start}, indent=1))
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(json.dumps(kernels))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
