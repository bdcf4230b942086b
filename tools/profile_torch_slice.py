#!/usr/bin/env python3
"""Where the time of the PyTorch port's main path goes, on one NVIDIA GPU.

Runs the same full-size fast-mode slice as ``chip_smoke.py`` (500-frame
corridor route, 32,768-point clouds, 4,608-frame DB) or, with ``--mode
fidelity`` / ``--mode default``, the exact modes as the command line
configures them on ``chip_smoke.py``'s 120-frame route (65,536 raw points
through the device voxelizer, full-density ICP on K2, optimize-on-find, the
keyframe DB sized to the route), and reports:

- per-stage wall time, each stage bracketed by ``torch.cuda.synchronize``
  (ICP, normals, the device voxelizer, occupancy, DB write, loop ticks
  split firing / idle, optimize-on-find, finalize) — the synchronisation
  itself costs a little;
- a ``torch.profiler`` trace of two windows (steady odometry frames, and
  the revisit frames with firing loop ticks): device time by kernel and the
  device's busy share of the window's wall time;
- the odometry ICP's device launches: 24 ICP calls of the steady frames are
  replayed one by one under the profiler, and a line fitted through
  (iterations, launches) gives the launches per iteration and per call
  set-up, hand-written kernels, ATen kernels and copies apart.

Run from the repository root on a machine with a card:

    python3 tools/profile_torch_slice.py [--mode fast|fidelity|default]
        [--out build/profile/profile_slice.json]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from collections import defaultdict

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="build/profile/profile_slice.json")
    ap.add_argument("--mode", choices=["fast", "fidelity", "default"],
                    default="fast")
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke
    from lidar_slam_tpu_torch.config import SlamConfig, apply_mode, slice_config
    from lidar_slam_tpu_torch.models import loop_closure as lc
    from lidar_slam_tpu_torch.models import pipeline
    from lidar_slam_tpu_torch.ops import knn_cuda

    dev = torch.device("cuda:0")
    knn_cuda.load_library()
    if args.mode == "fast":
        scans, _, _ = chip_smoke.prepare_route()
        cfg = slice_config()
        windows = {"steady": (100, 160), "revisit": (440, 500)}
        replay = (100, 124)  # the ICP calls replayed under the profiler
    else:
        from lidar_slam_tpu_torch.utils import dataset

        n = chip_smoke.FID_FRAMES  # the route of make_dataset, in memory
        half = dataset.route_half_for(n)
        world = dataset.generate_world(0, route_half=half)
        gt = dataset.generate_trajectory(n, half=half)
        rng = np.random.default_rng(0)
        scans = [dataset.render_scan(world, gt[i], rng,
                                     max_points=chip_smoke.RAW_POINTS)
                 for i in range(n)]
        cfg = apply_mode(SlamConfig(), args.mode).replace(
            max_raw_points=chip_smoke.RAW_POINTS, max_frames=n + 8)
        windows = {"steady": (40, 60), "revisit": (100, 120)}
        replay = (40, 52)
    n = len(scans)

    stage_s = defaultdict(float)
    stage_n = defaultdict(int)

    def timed(name, fn):
        def wrapper(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            stage_s[name] += time.perf_counter() - t0
            stage_n[name] += 1
            return out
        return wrapper

    orig_tick = pipeline.loop_tick

    def tick(state, cfg, frame):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        det = orig_tick(state, cfg, frame)
        torch.cuda.synchronize()
        fired = bool(torch.isfinite(det.sc_distance).any())
        key = "loop_tick_firing" if fired else "loop_tick_idle"
        stage_s[key] += time.perf_counter() - t0
        stage_n[key] += 1
        return det

    orig_normals_fn = pipeline.normals_fn
    originals = (pipeline.icp_point_to_plane, pipeline.update_occupancy,
                 lc.add_frame, pipeline.voxel_downsample,
                 pipeline.optimize_on_find)
    icp_calls = []  # the arguments of the ICP calls of the replay frames

    def icp_capture(*a, **kw):
        if replay[0] <= stage_n["icp"] + 1 < replay[1]:
            icp_calls.append((a, kw))
        return originals[0](*a, **kw)

    pipeline.icp_point_to_plane = timed("icp", icp_capture)
    pipeline.normals_fn = lambda cfg: timed("normals", orig_normals_fn(cfg))
    pipeline.update_occupancy = timed("occupancy", pipeline.update_occupancy)
    lc.add_frame = timed("db_write", lc.add_frame)
    pipeline.voxel_downsample = timed("voxelizer", pipeline.voxel_downsample)
    pipeline.optimize_on_find = timed("optimize_on_find",
                                      pipeline.optimize_on_find)
    pipeline.loop_tick = tick

    eng = pipeline.SlamEngine(cfg, dev)
    eng.preload(scans)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.run_preloaded()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    eng.finalize()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    stages = {k: {"s": stage_s[k], "calls": stage_n[k]} for k in stage_s}
    stages["finalize"] = {"s": t2 - t1, "calls": 1}
    run_s = t1 - t0
    # optimize_on_find runs inside the firing loop ticks: not counted twice
    accounted = sum(v["s"] for k, v in stages.items()
                    if k not in ("finalize", "optimize_on_find"))
    stages["other_host"] = {"s": run_s - accounted, "calls": n}

    # profiler windows, without the stage timers' synchronisations: a fresh
    # engine, frames [a, b) of the same route
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    (pipeline.icp_point_to_plane, pipeline.update_occupancy, lc.add_frame,
     pipeline.voxel_downsample, pipeline.optimize_on_find) = originals
    pipeline.normals_fn, pipeline.loop_tick = orig_normals_fn, orig_tick
    traces = {}
    for name, (a, b) in windows.items():
        eng = pipeline.SlamEngine(cfg, dev)
        eng.preload(scans[:a])
        eng.run_preloaded()
        eng.preload(scans[a:b], frame0=a)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            w0 = time.perf_counter()
            eng.run_preloaded()
            torch.cuda.synchronize()
            wall = time.perf_counter() - w0
        rows = []
        dev_total = 0.0
        for e in prof.key_averages():
            # device-side kernel and memcpy events only: an aten op's
            # device time is its kernels' again
            if e.device_type != DeviceType.CUDA:
                continue
            d = getattr(e, "self_device_time_total", 0.0) or 0.0
            if d > 0:
                rows.append((e.key, d / 1e3, e.count))
                dev_total += d / 1e3
        rows.sort(key=lambda r: -r[1])
        traces[name] = {
            "frames": [a, b], "wall_ms": wall * 1e3,
            "device_busy_ms": dev_total,
            "device_busy_share": dev_total / (wall * 1e3),
            "top_device_ms": [
                {"name": k[:120], "ms": ms, "count": c} for k, ms, c in rows[:15]
            ],
        }

    # launches of one odometry ICP iteration: replay the captured calls
    hand_names = ("match_slab_kernel", "nn1_kernel")
    per_call = []
    for a, kw in icp_calls:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            res = originals[0](*a, **kw)
            torch.cuda.synchronize()
        counts = {"hand": 0, "aten": 0, "copies": 0}
        for e in prof.key_averages():
            if e.device_type != DeviceType.CUDA:
                continue
            if any(h in e.key for h in hand_names):
                counts["hand"] += e.count
            elif e.key.startswith(("Memcpy", "Memset")):
                counts["copies"] += e.count
            else:
                counts["aten"] += e.count
        per_call.append({"iterations": int(res.num_iterations), **counts})
    iters = np.array([c["iterations"] for c in per_call], float)
    icp_launches = {"calls": per_call}
    if len(set(iters)) >= 2:  # launches = set-up + per-iteration * iterations
        for k in ("hand", "aten", "copies"):
            slope, icept = np.polyfit(iters, [c[k] for c in per_call], 1)
            icp_launches[k] = {"per_iteration": float(slope),
                               "per_call_setup": float(icept)}

    out = {
        "device": torch.cuda.get_device_name(0),
        "nvidia_smi": chip_smoke.nvidia_smi(),
        "mode": args.mode, "frames": n, "run_preloaded_s": run_s, "finalize_s": t2 - t1,
        "stages": stages, "windows": traces, "icp_launches": icp_launches,
    }
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({k: out[k] for k in ("device", "nvidia_smi", "mode", "frames",
                                          "run_preloaded_s", "finalize_s")}))
    for k, v in sorted(stages.items(), key=lambda kv: -kv[1]["s"]):
        print(f"stage {k:18s} {v['s']:9.3f} s  calls {v['calls']}")
    for name, t in traces.items():
        print(f"window {name} frames {t['frames']}: wall {t['wall_ms']:.1f} ms, "
              f"device busy {t['device_busy_ms']:.1f} ms "
              f"({100 * t['device_busy_share']:.1f}%)")
        for r in t["top_device_ms"][:8]:
            print(f"   {r['ms']:9.2f} ms  x{r['count']:6d}  {r['name']}")
    for k in ("hand", "aten", "copies"):
        if k in icp_launches:
            v = icp_launches[k]
            print(f"odometry ICP, {k:6s} launches: {v['per_iteration']:.2f} per "
                  f"iteration + {v['per_call_setup']:.2f} per call (fit over "
                  f"{len(per_call)} calls, {int(iters.min())}-{int(iters.max())} "
                  f"iterations)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
