"""Run one cell of the port's benchmark once, on this machine's GPU.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell, its configuration, its traffic mix
and its metrics are read from `BENCHMARK.json` and found by name under
`portbench/`. Set-up (counted in `setup_s`): the kernel libraries built or
loaded, the weights drawn on the GPU from the seed, the engine built (its
experts moved to pinned host memory), the traffic drawn, and serving until
the window opens. Then `--seconds` of `ServingEngine.serve` over
`SlotBufferEngine(use_kernel=True, use_superkernel=True)`; the window's
stop and its timestamps come from `pbcore.timed`. After the window the
program is freed and the plain reference judges every served token. The
last stdout line is the result (JSON); the numbers compared, with their
limits, are the last lines of stderr. With `--trace 1` the window runs
under `torch.profiler` and the result carries the per-layer metrics.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import List, Optional  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
for p in (str(ROOT / "src"), str(HERE)):
    if p not in sys.path:
        sys.path.insert(0, p)

# modules that no run may hold once its window has closed (whole top-level
# names: the port `repro_torch` is not the reference package `repro`)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
# the traced part of a `--trace 1` run's window: the trace of a whole
# window (~1.8 GB of JSON for 51 s) takes minutes to write and read
TRACE_SECONDS = 15.0
CACHE_ENV = ("TRITON_CACHE_DIR", "TORCH_EXTENSIONS_DIR",
             "TORCHINDUCTOR_CACHE_DIR", "CUDA_CACHE_PATH")


def forbidden_modules() -> List[str]:
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def set_cache_dirs() -> None:
    """Every compile or kernel cache at a fixed path inside the checkout
    (the port's own kernel libraries build into
    `src/repro_torch/kernels/_build/`)."""
    for name in CACHE_ENV:
        d = HERE / "_cache" / name.lower()
        d.mkdir(parents=True, exist_ok=True)
        os.environ[name] = str(d)


def load_json(path: Path) -> dict:
    return json.loads(path.read_text())


def load_module(path: Path):
    spec = importlib.util.spec_from_file_location(
        "pb_" + path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """One workload of the manifest, with everything found by its names."""

    def __init__(self, manifest: dict, name: str, root: Path = ROOT):
        here = root / "portbench"
        cells = {w["name"]: w for w in manifest["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r}; have {sorted(cells)}")
        self.name = name
        self.spec = cells[name]
        cfg_entry = {c["name"]: c for c in manifest["configs"]}[
            self.spec["config"]]
        self.conf = load_json(root / cfg_entry["file"])
        self.mix = load_json(here / "traffic" / f"{self.spec['traffic']}.json")
        self.limits = load_json(here / "limits" / f"{name}.json")
        self.chips = int(self.spec["chips"])
        self.end_to_end = self._metrics(manifest["end_to_end"])
        self.per_layer = self._metrics(manifest["per_layer"])
        self.readers = {m["name"]: load_module(
            here / "metrics" / f"{m['name']}.py").read
            for m in self.end_to_end + self.per_layer}

    def _metrics(self, entries: List[dict]) -> List[dict]:
        return [m for m in entries
                if "workloads" not in m or self.name in m["workloads"]]


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: Optional[float] = None):
    """One run of `cell`. Returns (result dict, what was served)."""
    import torch

    from pbcore import model as pbmodel
    from pbcore.devtrace import analyse
    from pbcore.judge import served_gaps, verdict
    from pbcore.measure import RunView
    from pbcore.timed import Recorder, WindowClosed
    from repro_torch.models.transformer import Model
    from repro_torch.runtime.engine import SlotBufferEngine
    from repro_torch.runtime.request import Request
    from repro_torch.runtime.serving import EngineServingConfig, ServingEngine
    from traffic.generate import requests

    t_start = T_START if t_start is None else t_start
    conf, mix = cell.conf, cell.mix
    cuda = device == "cuda"
    cfg = pbmodel.port_config(conf)
    layout = pbmodel.check_layout(conf, cfg)
    if cuda:
        from repro_torch.kernels.build import LIBS
        LIBS.build()
        log(f"kernel libraries: {json.dumps(LIBS.build_seconds)} s to build")
    params = pbmodel.make_params(seed, layout, device)
    eng = SlotBufferEngine(cfg, params, Model(cfg),
                           n_slots_per_layer=int(conf["n_slots_per_layer"]),
                           use_kernel=True, use_superkernel=True,
                           max_seq=int(mix["max_seq"]), device=device)
    del params
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    srv = ServingEngine(eng, EngineServingConfig(
        max_batch=int(mix["max_batch"]),
        prefill_chunk=int(mix["prefill_chunk"])))
    specs = requests(mix, seed, cfg.vocab_size)
    reqs = [Request(prompt=s.prompt, max_new_tokens=s.max_new_tokens,
                    request_id=s.request_id, arrival_s=s.arrival_s)
            for s in specs]

    prof = None
    marks: List[float] = []

    def mark() -> None:
        """A `cudaDeviceSynchronize` in the trace at a known host time."""
        marks.append(time.perf_counter())
        torch.cuda.synchronize()

    def on_open():
        # the device's activity only: tracing the host's ops would slow the
        # host-bound loop and, through the engine's timing feedback, change
        # what the admission cap admits
        nonlocal prof
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        if trace and cuda:
            prof = torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA])
            prof.start()
            mark()

    def on_trace_end():
        mark()
        prof.stop()

    rec = Recorder(srv, mix["window"], seconds, on_open,
                   trace_s=min(TRACE_SECONDS, seconds),
                   on_trace_end=on_trace_end if trace and cuda else None)
    try:
        srv.serve(reqs)
    except WindowClosed:
        pass
    else:
        raise RuntimeError("the traffic ran out before the window closed")
    facts = None
    if cuda:
        torch.cuda.synchronize()
    if prof is not None:
        if len(marks) < 2:                   # the window closed first
            on_trace_end()
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            t0 = time.perf_counter()
            prof.export_chrome_trace(path)
            t1 = time.perf_counter()
            facts = analyse(path, (marks[0], marks[-1]), rec.host_spans())
            log(f"trace: {os.path.getsize(path) / 1e6:.1f} MB, exported in "
                f"{t1 - t0:.1f} s, read in {time.perf_counter() - t1:.1f} s")
            steps = [s for s in rec.rec.decode
                     if marks[0] < s.t1 <= marks[-1]]
            log(f"traced: {len(steps)} decode steps; launches of the top "
                f"device ops {json.dumps(facts.launches)}")
        finally:
            os.remove(path)
        prof = None
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    view = RunView(conf, rec.rec, seconds, rec.rec.open_t - t_start, facts)
    served = [(r.prompt, list(r.output)) for r in reqs if r.output]
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = cell.readers[m["name"]](view)
        if v is None and not trace:
            raise RuntimeError(f"the run has no {m['name']}")
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}

    # free the program before the reference runs
    del srv, eng, rec, view
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    v = verdict(served_gaps(conf, seed, served, device), cell.limits["check"])
    result = {
        "correct": v.correct, "attempted": v.requests, "failed": v.failed,
        "metrics": metrics,
        "device": {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                   "count": cell.chips, "memory_peak_bytes": int(peak)}}
    if facts is not None:
        result["device"]["busy_s"] = facts.busy_s
        result["device"]["window_s"] = facts.window_s
        result["breakdown"] = {
            "device_ops": [[n, s] for n, s in facts.device_ops],
            "idle_gaps": [[n, s] for n, s in facts.idle_gaps]}
    result["checks"] = v.checks()
    return result, served


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    set_cache_dirs()
    cell = Cell(load_json(ROOT / "BENCHMARK.json"), args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        log(f"{args.workload} needs {cell.chips} CUDA device(s); this "
            f"machine has {torch.cuda.device_count()}")
        return 2
    result, _ = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    held = forbidden_modules()
    if held:
        log(f"the run holds modules it must not load: {held}")
        return 3
    for name, c in result["checks"].items():
        log(f"{name} {c['value']} limit {c['limit']}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
