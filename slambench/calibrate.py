#!/usr/bin/env python3
"""The readings that a cell's limits are set from, on the GPU, at the
cell's own size, in one process:

    python3 slambench/calibrate.py --workload <cell> --seeds 12 --control 3 [--first-seed N]

For each of ``--seeds`` seeds, one whole drive of the program (the
window's entry, ``window.drive``) and the output check's numbers; for each
of the first ``--control`` seeds, the numbers of the control (the
reference one precision below, ``check.judge(control=True)``). Prints one
JSON line a reading, then, per number, the largest program reading (the
lower reading) and the least control reading (the upper one)."""

import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=3_000_000_001)
    args = ap.parse_args(argv)

    from slambench.harness import cache_env

    cache_env()
    import torch

    from lidar_slam_tpu_torch.models.pipeline import SlamEngine
    from slambench import check
    from slambench.cell import load_cell
    from slambench.harness import prepare_scans
    from slambench.traffic.generate import make_drive
    from slambench.window import Window, drive

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cell = load_cell(args.workload)
    cfg = cell.slam_config()
    engine = SlamEngine(cfg)
    low, high = {}, {}
    for i in range(args.seeds):
        seed = args.first_seed + 7919 * i
        t0 = time.time()
        raw, _ = make_drive(cell.traffic, seed, "cuda")
        drive(engine, prepare_scans(cfg, raw), Window(), 0)
        out = check.ProgramOutputs.from_engine(engine)
        c = engine.metrics()
        t1 = time.time()
        det = {}
        _, nums = check.judge(cell, raw, out, seed, "cuda", details=det)
        t2 = time.time()
        rec = {"kind": "program", "seed": seed, "loops": c["loop_count"],
               "unconverged": int((~c["icp_converged"][1:]).sum()),
               "drive_s": t1 - t0, "check_s": t2 - t1,
               **{n: v for n, v, _ in nums}, "details": det}
        print(json.dumps(rec), flush=True)
        for n, v, _ in nums:
            low[n] = max(low.get(n, 0.0), v)
        if i < args.control:
            det = {}
            _, nums = check.judge(cell, raw, out, seed, "cuda", control=True,
                                  details=det)
            rec = {"kind": "control", "seed": seed, "check_s": time.time() - t2,
                   **{n: v for n, v, _ in nums}, "details": det}
            print(json.dumps(rec), flush=True)
            for n, v, _ in nums:
                high[n] = min(high.get(n, float("inf")), v)
    print(json.dumps({"lower": low, "upper": high}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
