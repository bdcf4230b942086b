#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``lidar_slam_tpu_torch``) on one NVIDIA GPU.

Run from the repository root, with no install and no arguments:

    python3 chip_smoke.py

Phases, one line each (plus details):

1. environment: torch and CUDA versions, the card, nvcc, the power limit;
2. kernel build: ``csrc/knn.cu`` compiled by nvcc for sm_90a;
3. K1 (slab match) and K2 (brute-force 1-NN) against their plain PyTorch
   versions at the main path's shapes (4,096 sources against 32,768
   targets, window 4,096; K2 also 3 lanes at once and a masked tail):
   indices and distances must be exactly equal, K1's matched rows bit-exact
   to the gathered rows; kernel and plain times from CUDA events;
4. the engine: the full-size fast-mode config (32,768-point clouds, a
   4,608-frame keyframe DB, 8192^2 grid) on a 500-frame corridor route whose
   last eighth revisits the start, through ``SlamEngine.preload ->
   run_preloaded -> finalize``; scans/s, peak device memory, ATE before and
   after finalize, loops, and the kernels' launch counts in that run.

The last lines are a JSON line of per-kernel results, the card's name and
power limit, and ``{"ok": true, "device": {...}}``. Any failed check raises,
and the script exits non-zero without printing the result lines. There is
no CPU fallback: without CUDA it exits with code 2.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
N_FRAMES = 500
RAW_POINTS = 65536
N_POINTS = 32768  # the slice config's max_points
VOXEL = 0.5


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def nvidia_smi() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    return r.stdout.strip().splitlines()[0] if r.returncode == 0 else "unavailable"


def nvcc_version(nvcc: str) -> str:
    r = subprocess.run([nvcc, "--version"], capture_output=True, text=True,
                       timeout=60)
    return r.stdout.strip().splitlines()[-1] if r.returncode == 0 else "?"


def time_ms(fn, reps: int = 20) -> float:
    """Mean ms per call from CUDA events, after a warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def prepare_route():
    """The 500-frame corridor route, rendered and host-voxelized."""
    import numpy as np

    from lidar_slam_tpu_torch.utils.dataset import (
        ScanRenderer,
        generate_trajectory,
        generate_world,
        route_half_for,
    )
    from lidar_slam_tpu_torch.utils.native import voxel_downsample_host

    half = route_half_for(N_FRAMES)
    world = generate_world(0, route_half=half, corridor=60.0)
    renderer = ScanRenderer(world)
    gt = generate_trajectory(N_FRAMES, half=half)
    rng = np.random.default_rng(0)
    scans = [
        voxel_downsample_host(
            renderer.render(gt[i], rng, max_points=RAW_POINTS), VOXEL, N_POINTS
        )
        for i in range(N_FRAMES)
    ]
    return scans, gt


def check_kernels(scans, dev):
    """K1 and K2 against their plain versions at main-path shapes."""
    import numpy as np
    import torch

    from lidar_slam_tpu_torch.ops import knn_cuda
    from lidar_slam_tpu_torch.ops.normals import estimate_normals_adaptive
    from lidar_slam_tpu_torch.types import PointCloud

    N = N_POINTS

    def cloud(i):
        pts = np.zeros((N, 3), np.float32)
        pts[: len(scans[i])] = scans[i]
        return (torch.from_numpy(pts).to(dev),
                torch.from_numpy(np.arange(N) < len(scans[i])).to(dev))

    tgt, tmask = cloud(10)
    src_pts, src_mask = cloud(11)
    nrm = estimate_normals_adaptive(tgt, tmask, r_min=1.2, window=4096,
                                    probe_stride=2)
    # the odometry ICP's source: sentinel-displaced, strided to 4,096 rows
    src_pts = torch.where(src_mask[:, None], src_pts,
                          torch.full_like(src_pts, 1.0e6))
    src = PointCloud(src_pts, src_mask).subsample(4096).points.contiguous()
    results = []

    # K1 --------------------------------------------------------------
    q_k, n_k, d_k = knn_cuda.match_slab(src, tgt, tmask, nrm)
    q_p, n_p, d_p = knn_cuda.match_slab_torch(src, tgt, tmask, nrm)
    i_k, _ = knn_cuda.nn1_slab(src, tgt, tmask)
    i_p, _ = knn_cuda.nn1_slab_torch(src, tgt, tmask)
    torch.cuda.synchronize()
    check(torch.equal(i_k, i_p), "K1 indices differ from the plain version")
    check(torch.equal(d_k, d_p), "K1 d2 differs from the plain version")
    check(torch.equal(q_k, q_p) and torch.equal(n_k, n_p),
          "K1 matched rows differ from the plain version")
    il = i_k.long()
    check(torch.equal(q_k, tgt[il]) and torch.equal(n_k, nrm[il]),
          "K1 matched rows are not the gathered rows")
    err1 = max(float((d_k - d_p).abs().max()), float((q_k - q_p).abs().max()),
               float((n_k - n_p).abs().max()))
    index = knn_cuda._build_slab_index(tgt, tmask, nrm)
    starts = knn_cuda._slab_starts_lut(src, index, 256, 4096, 3.0)
    ms1 = time_ms(lambda: knn_cuda._match_slab_cuda(src, index.tgt8, starts,
                                                    256, 4096))
    pms1 = time_ms(lambda: knn_cuda._match_slab_plain(src, index.tgt8, starts,
                                                      256, 4096))
    log(f"[kernels] K1 match_slab S=4096 T=32768 window=4096: exact "
        f"(idx, d2, rows); kernel {ms1:.4f} ms, plain {pms1:.4f} ms")
    results.append(dict(
        name="match_slab", route="cuda",
        source="lidar_slam_tpu_torch/csrc/knn.cu",
        replaces=knn_cuda.MATCH_SLAB.replaces, max_abs_err=err1,
        ms=ms1, plain_ms=pms1,
    ))

    # K2: 3 lanes in one launch, each 4,096 sources vs 32,768 targets ---------
    lanes = [cloud(i) for i in (20, N_FRAMES // 2, N_FRAMES - 20)]
    t3 = torch.stack([c[0] for c in lanes])
    m3 = torch.stack([c[1] for c in lanes])
    s3 = src[None].expand(3, -1, -1).contiguous()
    i_k, d_k = knn_cuda.nn1(s3, t3, m3)
    i_p, d_p = knn_cuda.nn1_torch(s3, t3, m3)
    torch.cuda.synchronize()
    check(torch.equal(i_k, i_p) and torch.equal(d_k, d_p),
          "K2 (3 lanes) differs from the plain version")
    err2 = float((d_k - d_p).abs().max())
    # masked tail: the last 40% of the targets invalid
    m_tail = tmask.clone()
    m_tail[int(0.6 * N):] = False
    i_k, d_k = knn_cuda.nn1(src, tgt, m_tail)
    i_p, d_p = knn_cuda.nn1_torch(src, tgt, m_tail)
    torch.cuda.synchronize()
    check(torch.equal(i_k, i_p) and torch.equal(d_k, d_p),
          "K2 (masked tail) differs from the plain version")
    check(int(i_k.max()) < int(0.6 * N), "K2 picked a masked target")
    err2 = max(err2, float((d_k - d_p).abs().max()))
    ms2 = time_ms(lambda: knn_cuda.nn1(s3, t3, m3), reps=10)
    pms2 = time_ms(lambda: knn_cuda.nn1_torch(s3, t3, m3), reps=3)
    log(f"[kernels] K2 nn1 3 lanes x S=4096 x T=32768 + masked tail: exact "
        f"(idx, d2); kernel {ms2:.4f} ms, plain {pms2:.4f} ms")
    results.append(dict(
        name="nn1", route="cuda", source="lidar_slam_tpu_torch/csrc/knn.cu",
        replaces=knn_cuda.NN1.replaces, max_abs_err=err2,
        ms=ms2, plain_ms=pms2,
    ))
    return results


def run_engine(scans, gt, dev):
    import numpy as np
    import torch

    from lidar_slam_tpu_torch.config import slice_config
    from lidar_slam_tpu_torch.models.pipeline import SlamEngine
    from lidar_slam_tpu_torch.ops import knn_cuda
    from lidar_slam_tpu_torch.utils.metrics import ate_rmse

    cfg = slice_config()
    torch.cuda.reset_peak_memory_stats(dev)
    for k in knn_cuda.KERNELS:  # count only the main path's launches
        k.launches = 0
    eng = SlamEngine(cfg, dev)
    eng.preload(scans)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.run_preloaded()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    traj_odo = eng.trajectory()
    t2 = time.perf_counter()
    eng.finalize()
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    launches = {k.name: k.launches for k in knn_cuda.KERNELS}
    traj = eng.trajectory()
    m = eng.metrics()
    peak = torch.cuda.max_memory_allocated(dev)
    ate0, ate1 = ate_rmse(traj_odo, gt), ate_rmse(traj, gt)
    wall = (t1 - t0) + (t3 - t2)
    log(f"[engine] {N_FRAMES} frames: run_preloaded {t1 - t0:.3f} s, "
        f"finalize {t3 - t2:.3f} s -> {N_FRAMES / wall:.3f} scans/s; peak "
        f"device memory {peak / 2**30:.3f} GiB")
    log(f"[engine] ATE {ate0:.4f} m before finalize, {ate1:.4f} m after; "
        f"loops {m['loop_count']}, verify_fired {m['verify_fired']}, "
        f"verify_fine_fired {m['verify_fine_fired']}, mean icp_iters "
        f"{float(np.mean(m['icp_iters'][1:])):.3f}, occ_dropped "
        f"{m['occ_dropped']}; launches {launches}")
    check(traj.shape == (N_FRAMES, 4, 4) and eng.state.n_poses == N_FRAMES,
          "the engine did not produce one pose per frame")
    check(bool(np.isfinite(traj).all()), "non-finite poses")
    check(m["loop_count"] >= 1, "no loop closed on the revisit")
    check(launches["match_slab"] > 0 and launches["nn1"] > 0,
          f"a kernel of the main path was not launched: {launches}")
    check(ate1 <= ate0 + 0.05, f"finalize made ATE worse: {ate0} -> {ate1}")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an "
              "NVIDIA GPU and has no CPU fallback", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import lidar_slam_tpu_torch

    pkg = os.path.dirname(os.path.abspath(lidar_slam_tpu_torch.__file__))
    check(os.path.dirname(pkg) == HERE,
          f"run from the repository root (found the package at {pkg})")
    from lidar_slam_tpu_torch.ops import knn_cuda

    dev = torch.device("cuda:0")
    smi = nvidia_smi()
    log(f"[env] torch {torch.__version__} cuda {torch.version.cuda}; device "
        f"{torch.cuda.get_device_name(0)} (count {torch.cuda.device_count()}); "
        f"nvcc: {nvcc_version(knn_cuda._nvcc())}; nvidia-smi: {smi}")

    t0 = time.perf_counter()
    knn_cuda.load_library()
    ptxas = [ln.strip() for ln in knn_cuda.build_log.splitlines()
             if "registers" in ln or "Compiling entry" in ln]
    log(f"[build] {time.perf_counter() - t0:.2f} s -> {knn_cuda.library_path()}"
        + "".join(f"\n  {ln}" for ln in ptxas))

    t0 = time.perf_counter()
    scans, gt = prepare_route()
    log(f"[prep] {N_FRAMES} scans rendered and voxelized on the host in "
        f"{time.perf_counter() - t0:.1f} s (set-up, not timed below)")

    results = check_kernels(scans, dev)
    launches = run_engine(scans, gt, dev)
    for r in results:
        r["launches"] = launches[r["name"]]
    print(json.dumps({"kernels": results}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
