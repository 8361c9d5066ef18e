"""Multi-pod dry run: every (arch x shape) cell's step on the production
meshes, on fake tensors, with its memory, cost and collective analysis;
one JSON report a cell.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun                 # all
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-9b \\
        --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --single-pod-only

The reference forces 512 host devices and compiles. The port starts a fake
process group of 256 (16x16) or 512 (2x16x16) ranks in this process
(rank 0; it moves no data), builds the step of `training/steps.py`
(`make_train_step` / `make_prefill_step` / `make_serve_step`) and runs it
under a fake-tensor mode: every op runs with rank 0's shapes and computes
nothing. From that run come the per-device FLOPs, bytes and collectives
(`launch.roofline.lower_cost`), and the peak memory from
`torch.distributed._tools.mem_tracker.MemTracker` (the params, optimizer
state and inputs tracked as external tensors; torchtitan's memory
estimation combines the same three pieces). `compile_seconds` holds the
fake run's wall seconds (nothing is compiled). The kernels' fake device is
the CPU, so every kernel is counted through its plain version. Every
number is modeled (H100 data-sheet peaks, `launch.roofline`), none
measured. A cell that fails is recorded with its error, and so is one
whose fake run passes `CELL_TIMEOUT_S` (the recurrent mixers' time loops
run one step per token, eagerly, so their long cells are slow to fake).

Reports go to `reports/dryrun_torch/` under the repository root.
"""
import argparse
import contextlib
import json
import pathlib
import signal
import time
import traceback

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs.registry import (ASSIGNED_ARCH_IDS, SHAPE_NAMES,
                                          SHAPES, cell_skip_reason,
                                          get_config)
from repro_torch.distributed import sharding as shd
from repro_torch.launch import roofline as rl
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.specs import (abstract_batch, abstract_opt_state,
                                      abstract_params, decode_inputs)
from repro_torch.models.transformer import Model
from repro_torch.training.steps import (make_prefill_step, make_serve_step,
                                        make_train_step)
from repro_torch.tree import tree_leaves

REPORT_DIR = pathlib.Path(__file__).resolve().parents[3] / "reports" / \
    "dryrun_torch"
CELL_TIMEOUT_S = 3600     # a cell's fake run past this is recorded failed


@contextlib.contextmanager
def fake_world(world_size: int):
    """A fake process group of `world_size` ranks (this process rank 0),
    closed on exit; a group already up is left alone."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        yield
        return
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def build_step(cfg, model, cell, mesh):
    """(step, args) of one cell on one mesh, all inputs abstract. Call
    under a fake-tensor mode."""
    kind = cell.kind
    # weights are sharded over BOTH axes in serving too (no optimizer state,
    # but 104B/235B-class weights do not fit one device's memory at
    # model-axis-only sharding; the per-layer all-gather is the trade)
    params = abstract_params(model, mesh, fsdp=True)
    if kind == "train":
        opt = abstract_opt_state(params, mesh, fsdp=True)
        batch = abstract_batch(cfg, cell, mesh, "train")
        return make_train_step(model, ce_chunk=rl.CE_CHUNK), \
            (params, opt, batch)
    if kind == "prefill":
        batch = abstract_batch(cfg, cell, mesh, "prefill")
        return make_prefill_step(model, max_seq=cell.seq_len), \
            (params, batch)
    token, cache = decode_inputs(cfg, cell, mesh, model)
    return make_serve_step(model), (params, token, cache)


def _locals(tree):
    return [t.to_local() if shd.is_dtensor(t) else t
            for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def run_cell(arch: str, shape: str, *, multi_pod: bool,
             with_components: bool = True) -> dict:
    cfg = get_config(arch)
    cell = SHAPES[shape]
    mesh_name = "2x16x16" if multi_pod else "16x16"
    out = {"arch": arch, "shape": shape, "mesh": mesh_name, "status": "ok"}
    skip = cell_skip_reason(cfg, shape)
    if skip:
        out.update(status="skip", reason=skip)
        return out

    with fake_world(512 if multi_pod else 256):
        mesh = make_production_mesh(multi_pod=multi_pod)
        with FakeTensorMode():
            out.update(analyse(cfg, cell, mesh,
                               with_components=with_components
                               and not multi_pod))
    return out


def analyse(cfg, cell, mesh, with_components: bool = True) -> dict:
    """The report of one cell's step on `mesh` (under a fake-tensor mode
    and a process group of the mesh's size)."""
    from torch.distributed._tools.mem_tracker import MemTracker
    model = Model(cfg)
    chips = mesh.size()
    fsdp = cell.kind == "train"
    t0 = time.time()
    with shd.mesh_context(mesh, fsdp=fsdp):
        step, args = build_step(cfg, model, cell, mesh)
        args_bytes = sum(t.numel() * t.element_size() for t in _locals(args))
        mt = MemTracker()
        mt.track_external(*_locals(args))
        with mt:
            flops, nbytes, coll = rl.lower_cost(step, *args)
        peak = sum(v.get("Total", 0) for v in
                   mt.get_tracker_snapshot("peak").values())
    out = dict(
        loop_collective_bytes=coll.total_bytes,
        loop_collective_bytes_by_kind=coll.bytes_by_kind,
        loop_collective_counts=coll.count_by_kind,
        compile_seconds=round(time.time() - t0, 2),
        peak_memory_bytes=int(peak),
        argument_bytes=int(args_bytes),
        raw_flops_per_device=flops,
        raw_bytes_per_device=nbytes,
        raw_collective_bytes=coll.total_bytes,
        raw_collective_counts=coll.count_by_kind,
        raw_collective_bytes_by_kind=coll.bytes_by_kind,
    )
    # the terms come from the components, which sum to the full step; the
    # full step is its own single component when the breakdown is skipped
    comps = [rl.Component("step", 1, flops, nbytes, coll.total_bytes,
                          coll.bytes_by_kind)]
    if with_components:
        with shd.mesh_context(mesh, fsdp=fsdp):
            comps = rl.component_costs(model, cfg, cell, mesh, cell.kind)
        attn = [s for s in model.specs if s.kind == "attn"]
        if attn and cell.kind != "decode":
            # the block geometry (counted in the step already, not added)
            T = rl._geometry(cfg, cell, cell.kind)[1]
            out["flash_blocks"] = {
                "active_per_layer": [rl._n_blocks(T, T, True, s.window)
                                     for s in attn],
                "block_cost": dict(zip(
                    ("flops_fwd", "bytes_fwd", "flops_bwd", "bytes_bwd"),
                    rl.flash_block_cost(cfg, mesh, cell.global_batch, T,
                                        fsdp)))}
    out["roofline"] = rl.RooflineReport(
        arch=cfg.name, shape=cell.name,
        mesh="x".join(map(str, mesh.shape)), chips=chips,
        components=comps, model_flops_global=rl.model_flops(cfg, cell),
        raw_flops=flops, raw_bytes=nbytes, raw_coll_bytes=coll.total_bytes,
        peak_memory_bytes=peak, compile_seconds=out["compile_seconds"],
        min_bytes_per_device=rl.analytic_min_bytes(cfg, cell, chips),
        loop_coll_bytes=coll.total_bytes).to_dict()
    return out


@contextlib.contextmanager
def _time_limit(seconds: float):
    """Raise TimeoutError in the main thread once `seconds` have passed
    (SIGALRM: the CLI's thread)."""
    def expire(signum, frame):
        raise TimeoutError(f"the fake run exceeded {seconds:.0f} s")
    old = signal.signal(signal.SIGALRM, expire)
    signal.setitimer(signal.ITIMER_REAL, seconds)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, old)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--single-pod-only", action="store_true")
    ap.add_argument("--multi-pod-only", action="store_true")
    ap.add_argument("--no-components", action="store_true")
    ap.add_argument("--force", action="store_true",
                    help="recompute cells that already have reports")
    args = ap.parse_args(argv)

    REPORT_DIR.mkdir(parents=True, exist_ok=True)
    archs = [args.arch] if args.arch else ASSIGNED_ARCH_IDS
    shapes = [args.shape] if args.shape else SHAPE_NAMES
    meshes = []
    if not args.multi_pod_only:
        meshes.append(False)
    if not args.single_pod_only:
        meshes.append(True)

    n_ok = n_skip = n_fail = 0
    records = {}
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                tag = f"{arch}__{shape}__{'2x16x16' if mp else '16x16'}"
                path = REPORT_DIR / f"{tag}.json"
                if path.exists() and not args.force:
                    rec = json.loads(path.read_text())
                    print(f"[cached] {tag}: {rec['status']}")
                    records[tag] = rec
                    continue
                try:
                    with _time_limit(CELL_TIMEOUT_S):
                        rec = run_cell(arch, shape, multi_pod=mp,
                                       with_components=not args.no_components)
                except Exception as e:  # noqa: BLE001 — record and continue
                    rec = {"arch": arch, "shape": shape,
                           "mesh": "2x16x16" if mp else "16x16",
                           "status": "fail",
                           "error": f"{type(e).__name__}: {e}"[:2000],
                           "traceback": traceback.format_exc()[-2000:]}
                path.write_text(json.dumps(rec, indent=1))
                records[tag] = rec
                st = rec["status"]
                n_ok += st == "ok"
                n_skip += st == "skip"
                n_fail += st == "fail"
                msg = rec.get("reason") or rec.get("error") or \
                    f"run={rec.get('compile_seconds')}s " \
                    f"peak={rec.get('peak_memory_bytes', 0)/2**30:.2f}GiB"
                print(f"[{st:4s}] {tag}: {msg}", flush=True)
    print(f"done: ok={n_ok} skip={n_skip} fail={n_fail}")
    return records


if __name__ == "__main__":
    main()
