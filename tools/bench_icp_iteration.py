#!/usr/bin/env python3
"""Kernel launches, device time and host wall of one odometry ICP iteration
on one NVIDIA GPU, in fast mode's configuration (K1, 4,096 sources) and in
fidelity's (K2, 32,768 x 32,768).

Each figure is the difference between an ICP of 6 and one of 2 iterations
(tolerance and minimum error 0, so neither stops early) on one frame pair
of the corridor route, over 4: kernels from a ``torch.profiler`` trace
(copies and sets left out), device time as the sum of those kernels, the
host wall as the median of 20 synced calls. What the 2-iteration call has
beyond its two iterations is the per-call cost. It uses only the public
ICP call, so two checkouts can be compared on one card in one go:

    python3 tools/bench_icp_iteration.py                 # this checkout
    python3 tools/bench_icp_iteration.py --root DIR      # the package under DIR

Prints one JSON object as its last line.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=ROOT,
                    help="checkout whose lidar_slam_tpu_torch is measured")
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.root))
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from lidar_slam_tpu_torch.config import apply_mode, slice_config
    from lidar_slam_tpu_torch.models.pipeline import resolve_nn1
    from lidar_slam_tpu_torch.ops.icp import icp_point_to_plane
    from lidar_slam_tpu_torch.ops.normals import estimate_normals_adaptive
    from lidar_slam_tpu_torch.types import PointCloud
    from lidar_slam_tpu_torch.utils.dataset import (
        ScanRenderer,
        generate_trajectory,
        generate_world,
        route_half_for,
    )
    from lidar_slam_tpu_torch.utils.native import voxel_downsample_host

    dev = torch.device("cuda:0")
    half = route_half_for(500)
    renderer = ScanRenderer(generate_world(0, route_half=half, corridor=60.0))
    gt = generate_trajectory(500, half=half)
    rng = np.random.default_rng(0)
    clouds = []
    for i in (40, 41):
        v = voxel_downsample_host(renderer.render(gt[i], rng, max_points=65536),
                                  0.5, 32768)
        pts = np.zeros((32768, 3), np.float32)
        pts[: len(v)] = v
        p = torch.from_numpy(pts).to(dev)
        m = torch.from_numpy(np.arange(32768) < len(v)).to(dev)
        clouds.append((PointCloud(p, m), estimate_normals_adaptive(
            p, m, r_min=1.2, window=4096, probe_stride=2)))
    (tgt, nrm), (src, _) = clouds

    out = {"device": torch.cuda.get_device_name(0)}
    for mode in ("fast", "fidelity"):
        cfg = apply_mode(slice_config(), mode)
        nn1_fn = resolve_nn1(cfg)
        got = {}
        for k in (2, 6):
            icfg = dataclasses.replace(cfg.icp, max_iterations=k, tolerance=0.0,
                                       min_error=0.0, warm_start=False)

            def call():
                return icp_point_to_plane(src, tgt, nrm, icfg, nn1_fn=nn1_fn)

            for _ in range(3):
                call()
            torch.cuda.synchronize()
            walls = []
            for _ in range(20):
                t0 = time.perf_counter()
                res = call()
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                call()
                torch.cuda.synchronize()
            ops = [e for e in prof.events() if e.device_type == DeviceType.CUDA
                   and not e.name.startswith(("Memcpy", "Memset"))]
            got[k] = dict(kernels=len(ops), wall_ms=1e3 * float(np.median(walls)),
                          device_ms=sum(e.device_time for e in ops) / 1e3,
                          iterations=int(res.num_iterations))
            print(f"[{mode}] {k} iterations: {got[k]}", flush=True)
        per = {key: (got[6][key] - got[2][key]) / 4
               for key in ("kernels", "wall_ms", "device_ms")}
        per["kernels_per_call"] = got[2]["kernels"] - 2 * per["kernels"]
        print(f"[{mode}] per iteration: {per}", flush=True)
        out[mode] = per
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
