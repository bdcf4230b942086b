#!/usr/bin/env python3
"""Times of the two correspondence kernels (K1 slab match, K2 1-NN) at the
main path's shapes, on one NVIDIA GPU, through the package's public calls.

It uses only what every version of the port offers (``SlabBackend``,
``nn1``, the dataset utilities), so two checkouts can be compared on one
card in one go:

    python3 tools/bench_knn_kernels.py                 # this checkout
    python3 tools/bench_knn_kernels.py --root DIR      # the package under DIR

For each call it reports the CUDA-event time per call (the larger of host
and device time), and from a ``torch.profiler`` trace the device kernels
launched per call (hand-written and ATen apart) and the device time per
launch of the hand-written kernel; at the end, the card's clock and power
draw while it runs K2 back to back. Prints one JSON object as its last line.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HAND_KERNELS = ("match_slab_kernel", "nn1_kernel")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=ROOT,
                    help="checkout whose lidar_slam_tpu_torch is measured")
    ap.add_argument("--reps", type=int, default=200)
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.root))
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from lidar_slam_tpu_torch.ops import knn_cuda
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
    N, n_frames = 32768, 500
    half = route_half_for(n_frames)
    renderer = ScanRenderer(generate_world(0, route_half=half, corridor=60.0))
    gt = generate_trajectory(n_frames, half=half)
    rng = np.random.default_rng(0)

    def cloud(i):
        scan = voxel_downsample_host(
            renderer.render(gt[i], rng, max_points=65536), 0.5, N)
        pts = np.zeros((N, 3), np.float32)
        pts[: len(scan)] = scan
        return (torch.from_numpy(pts).to(dev),
                torch.from_numpy(np.arange(N) < len(scan)).to(dev))

    tgt, tmask = cloud(10)
    src_pts, src_mask = cloud(11)
    nrm = estimate_normals_adaptive(tgt, tmask, r_min=1.2, window=4096,
                                    probe_stride=2)
    src_pts = torch.where(src_mask[:, None], src_pts,
                          torch.full_like(src_pts, 1.0e6))
    src = PointCloud(src_pts, src_mask).subsample(4096).points.contiguous()
    lanes = [cloud(i) for i in (20, 250, 480)]
    t3 = torch.stack([c[0] for c in lanes])
    m3 = torch.stack([c[1] for c in lanes])
    s3 = src[None].expand(3, -1, -1).contiguous()

    def measure(fn, reps):
        fn()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        call_ms = a.elapsed_time(b) / reps
        n = min(reps, 50)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        hand_n = aten_n = 0
        hand_us = 0.0
        for e in prof.key_averages():
            if e.device_type != DeviceType.CUDA:
                continue
            if any(k in e.key for k in HAND_KERNELS):
                hand_n += e.count
                hand_us += e.self_device_time_total
            else:
                aten_n += e.count
        return {
            "call_ms": call_ms,
            "hand_launches_per_call": hand_n / n,
            "other_device_ops_per_call": aten_n / n,
            "hand_kernel_ms": hand_us / 1e3 / max(hand_n, 1),
        }

    out = {"root": os.path.abspath(args.root)}
    q1 = knn_cuda.SlabBackend().prepare_match(tgt, tmask, nrm)
    out["k1_query"] = measure(lambda: q1(src), args.reps)
    out["k2_nn1_3lanes"] = measure(lambda: knn_cuda.nn1(s3, t3, m3),
                                   args.reps // 4)
    out["k2_nn1_1lane"] = measure(
        lambda: knn_cuda.nn1(s3[:1], t3[:1], m3[:1]), args.reps // 4)
    prepare = getattr(knn_cuda.nn1, "prepare", None)
    if prepare is not None:
        q3, q1l = prepare(t3, m3), prepare(t3[:1], m3[:1])
        out["k2_query_3lanes"] = measure(lambda: q3(s3), args.reps // 4)
        out["k2_query_1lane"] = measure(lambda: q1l(s3[:1]), args.reps // 4)
    # the card's clock and power while K2 runs back to back for ~2 s:
    # nvidia-smi is asked in the middle of it
    busy = prepare(t3, m3) if prepare is not None else (
        lambda s: knn_cuda.nn1(s, t3, m3))
    smi = subprocess.Popen(
        "sleep 1; nvidia-smi --query-gpu=name,power.limit,clocks.sm,"
        "clocks.max.sm,power.draw --format=csv,noheader",
        shell=True, stdout=subprocess.PIPE, text=True)
    for _ in range(int(2000 / out["k2_nn1_3lanes"]["call_ms"])):
        busy(s3)
    torch.cuda.synchronize()
    out["nvidia_smi_under_load"] = smi.communicate(timeout=60)[0].strip()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
