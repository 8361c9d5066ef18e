"""Readings that set a cell's limit, on the GPU, many seeds in one process.

    python3 portbench/calibrate.py --workload <cell> --seconds <s> --seeds <n> [<n> ...]

For each seed: one run of the cell as `run.py` makes it (the timed path at
the cell's size and load), the widest and the mean gap of its served
tokens (the lower readings), the control on the same tokens: the
reference through float8 in the program's place (the upper readings), and
the share of each request's served tokens that repeat an earlier one. One JSON line a seed on
stdout and in `chiprun_out/calibrate_<cell>.jsonl`. The benchmark's own
runs never run the control.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    run.set_cache_dirs()
    cell = run.Cell(run.load_json(run.ROOT / "BENCHMARK.json"),
                    args.workload)
    import torch

    from pbcore import judge
    if not torch.cuda.is_available():
        print("calibrate needs a CUDA device", file=sys.stderr)
        return 2
    out = Path("chiprun_out")
    out.mkdir(exist_ok=True)
    with open(out / f"calibrate_{args.workload}.jsonl", "a") as f:
        for seed in args.seeds:
            t0 = time.perf_counter()
            result, served = run.run_cell(cell, seed, args.seconds, False,
                                          t_start=t0)
            t1 = time.perf_counter()
            ctl = judge.control_gaps(cell.conf, seed, served, "cuda")
            prog = judge.served_gaps(cell.conf, seed, served, "cuda")
            line = {"workload": args.workload, "seed": seed,
                    "program": judge.numbers(prog),
                    "control": judge.numbers(ctl),
                    "tokens": int(sum(len(g) for g in ctl)),
                    "repeat_share": sum(1 - len(set(o)) / len(o)
                                        for _, o in served) / len(served),
                    "correct": result["correct"],
                    "metrics": {k: v["value"]
                                for k, v in result["metrics"].items()},
                    "run_s": t1 - t0,
                    "control_s": time.perf_counter() - t1}
            print(json.dumps(line), flush=True)
            f.write(json.dumps(line) + "\n")
            f.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
