#!/usr/bin/env python3
"""Read the correctness check's numbers for several seeds of one cell in
one process: the program's readings (the lower end of each limit) and the
control's, the fp32 reference computed with float8 products in the
program's place (the upper end).  Each seed is a whole run of the cell
(set-up, a window of ``--seconds`` at the cell's own load, the check);
benchmark runs never run the control.  One JSON line per seed.

    python3 bench/control.py --workload phi3-mini.reason --seeds 11,12,13 --seconds 10
"""

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--no-control", action="store_true",
                    help="read the program's numbers only")
    args = ap.parse_args()
    from bench.harness import spec
    from bench.harness.runner import run_cell
    import torch

    if not torch.cuda.is_available():
        print("control.py needs a CUDA device", file=sys.stderr)
        return 2
    cell = spec.cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        result, _ = run_cell(cell, seed, args.seconds, False, device="cuda",
                             t_start=time.perf_counter(), control=not args.no_control)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "correct": result["correct"], "check": result["check"],
                          "control": result.get("control"),
                          "control_correct": result.get("control_correct"),
                          "metrics": result["metrics"]}), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    return 0


if __name__ == "__main__":
    sys.exit(main())
