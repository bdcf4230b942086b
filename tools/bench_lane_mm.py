#!/usr/bin/env python3
"""What the ICP's per-lane normal equations cost the batched engine, on one
NVIDIA GPU.

``ops/icp._lane_mm`` forms each lane's Gauss-Newton normal equations with
a 2-D product of its own, so a lane of a batch rounds as the lane alone
does; one batched ``torch.matmul`` is fewer launches but lets cuBLAS plan
a batch of 4 otherwise than a batch of 1. This runs ``chip_smoke.py``'s
[cli-batch] data (4 lanes x 200 frames, fast mode at full width) through
``BatchedSlamEngine`` with each product, in the order per-lane, batched,
batched, per-lane, after one run that is not reported (the process's first
cuBLAS and allocator calls), and reports for each run the seconds of
``run_preloaded`` and ``finalize`` (each ended by a device synchronise) and
the aggregate scans/s; then each lane alone through ``SlamEngine`` under
each product, and the largest pose difference of each batched lane from
it; then one Gauss-Newton step (``icp.solve_point_to_plane``) at 4 and 12
lanes of 4,096 rows under each product, ms a call back to back (CUDA
events; the host's launches included).

Run from the repository root on a machine with a card:

    python3 tools/bench_lane_mm.py [--out build/profile/lane_mm.json]
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import sys
import tempfile
import time
from concurrent.futures import ProcessPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="build/profile/lane_mm.json")
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke
    from lidar_slam_tpu_torch.config import SlamConfig, apply_mode
    from lidar_slam_tpu_torch.models import pipeline
    from lidar_slam_tpu_torch.ops import icp, knn_cuda
    from lidar_slam_tpu_torch.parallel import BatchedSlamEngine
    from lidar_slam_tpu_torch.utils.io import discover_frames, load_scan
    from lidar_slam_tpu_torch.utils.native import voxel_downsample_host

    dev = torch.device("cuda:0")
    knn_cuda.load_library()
    B, n = chip_smoke.BATCH_LANES, chip_smoke.BATCH_FRAMES
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as work:
        dirs = [os.path.join(work, f"lane{b}") for b in range(B)]
        with ProcessPoolExecutor(
                B, mp_context=multiprocessing.get_context("spawn")) as pool:
            list(pool.map(chip_smoke.render_lane, range(B), dirs, [n] * B,
                          [chip_smoke.RAW_POINTS] * B))
        seqs = [[voxel_downsample_host(load_scan(p), chip_smoke.VOXEL,
                                       chip_smoke.N_POINTS)
                 for _, p in discover_frames(d)] for d in dirs]
    print(f"[prep] {B} lanes x {n} frames in {time.perf_counter() - t0:.1f} s",
          flush=True)
    # the configuration `run-batch --mode fast --resident` gives these data
    cfg = apply_mode(SlamConfig(), "fast").replace(
        max_frames=n + 8, host_voxelize=True,
        max_raw_points=chip_smoke.RAW_POINTS)
    products = {"per-lane": icp._lane_mm, "batched": torch.matmul}

    def timed(eng):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.run_preloaded()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        eng.finalize()
        torch.cuda.synchronize()
        return t1 - t0, time.perf_counter() - t1

    out = {"device": torch.cuda.get_device_name(0),
           "nvidia_smi": chip_smoke.nvidia_smi(), "lanes": B, "frames": n,
           "runs": [], "alone": {}}
    trajs = {}
    try:
        for kind in ("warm-up", "per-lane", "batched", "batched", "per-lane"):
            if kind == "warm-up":
                eng = BatchedSlamEngine(cfg, B, dev,
                                        optimize_midrun=cfg.optimize_midrun)
                eng.preload(seqs)
                timed(eng)
                del eng
                continue
            icp._lane_mm = products[kind]
            eng = BatchedSlamEngine(cfg, B, dev,
                                    optimize_midrun=cfg.optimize_midrun)
            eng.preload(seqs)
            run_s, fin_s = timed(eng)
            traj = eng.trajectories()
            same = (bool(np.array_equal(traj, trajs[kind]))
                    if kind in trajs else None)
            trajs.setdefault(kind, traj)
            r = dict(product=kind, run_preloaded_s=run_s, finalize_s=fin_s,
                     scans_per_s=B * n / (run_s + fin_s),
                     loops=[m["loop_count"] for m in eng.metrics()],
                     equal_to_first_run=same)
            del eng
            out["runs"].append(r)
            print(f"[batch] {json.dumps(r)}", flush=True)
        for kind in ("per-lane", "batched"):
            icp._lane_mm = products[kind]
            diffs, secs = [], []
            for b in range(B):
                eng = pipeline.SlamEngine(cfg, dev)
                eng.preload(seqs[b])
                run_s, fin_s = timed(eng)
                secs.append(run_s + fin_s)
                diffs.append(float(np.abs(eng.trajectory()
                                          - trajs[kind][b]).max()))
                del eng
            out["alone"][kind] = dict(seconds=secs,
                                      largest_pose_difference_m=diffs)
            print(f"[alone] {kind}: {json.dumps(out['alone'][kind])}",
                  flush=True)
        rng = np.random.default_rng(0)
        out["step_ms"] = {}
        for lanes in (B, 3 * B):
            src = rng.normal(0, 20, (lanes, 4096, 3)).astype(np.float32)
            tgt = src + rng.normal(0, 0.05, src.shape).astype(np.float32)
            nrm = rng.normal(size=src.shape).astype(np.float32)
            nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
            w = rng.uniform(size=src.shape[:2]) < 0.9
            a = [torch.from_numpy(x).to(dev) for x in (src, tgt, nrm, w)]
            for kind in ("per-lane", "batched", "batched", "per-lane"):
                icp._lane_mm = products[kind]
                ms = chip_smoke.time_ms(lambda: icp.solve_point_to_plane(*a),
                                        reps=500)
                out["step_ms"].setdefault(f"{lanes} lanes", {}).setdefault(
                    kind, []).append(ms)
        print(f"[step] ms a Gauss-Newton step: {json.dumps(out['step_ms'])}",
              flush=True)
    finally:
        icp._lane_mm = products["per-lane"]
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(out["nvidia_smi"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
