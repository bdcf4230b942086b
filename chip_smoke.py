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
   to the gathered rows and its in-kernel window starts equal to the plain
   glue's; then the designs' edges (a ragged source count, a tile of
   sentinel rows, one lane, a ragged target count, equal targets on both
   sides of a split boundary, prepare/query against the single call). The
   kernel times are device times (a CUDA graph of launches between two
   events), the plain and whole-call times CUDA-event loops; each kernel's
   bound is computed from the card's SM count and clock;
   K2 also at the exact modes' shapes, 1 and 3 lanes x 32,768 x 32,768
   (fidelity odometry, full-density verification); and at the batched
   engine's: K1 over 4 ICP lanes in one launch (each lane exact against
   the plain version and bit-identical to a one-lane launch on it), K2 over
   12 lanes (a verification tranche of 4 lanes);
4. the engine: the full-size fast-mode config (32,768-point clouds, a
   4,608-frame keyframe DB, 8192^2 grid) on a 500-frame corridor route whose
   last eighth revisits the start, through ``SlamEngine.preload ->
   run_preloaded -> finalize``; scans/s, peak device memory, ATE before and
   after finalize, loops, and the kernels' launch counts in that run;
5. the command line, in process, at the same width (65,536 raw points,
   32,768-point clouds, 8192^2 grid, the keyframe DB sized to the dataset):
   **cli-fast**: the 500 raw scans of phase 4 written as ``.ply`` with
   ``poses_gt.txt``, ``run --mode fast --resident``; every artifact is
   checked, and loops, firing ticks and ATE must equal phase 4's;
   **cli-fidelity**: a 120-frame route with a revisit, ``run --mode
   fidelity --no-host-voxelize`` streaming, with a checkpoint and a
   snapshot on the way: a loop must close, optimize-on-find must move the
   poses, K2 must run and K1 must not, ``frame_npts`` must be the voxel
   counts; **cli-resume**: the same command from the checkpoint must give
   the uninterrupted run's final trajectory bit for bit; **cli-batch**:
   ``run-batch --mode fast --resident`` on 4 lanes of 200 frames, each
   through its own world on one route with a revisit: every lane must close
   a loop, and equal (loops, firing ticks, ATE within 0.01 m) the port's
   single engine run on that lane's prepared scans, which are run after it
   for comparison; the batched run must launch K1 fewer times than the
   single runs together. Each run prints its scans/s, prep / upload /
   device times, peak device memory and launches.

The last lines are a JSON line of per-kernel results, the card's name and
power limit, and ``{"ok": true, "device": {...}}``. Any failed check raises,
and the script exits non-zero without printing the result lines. There is
no CPU fallback: without CUDA it exits with code 2.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
N_FRAMES = 500
RAW_POINTS = 65536
N_POINTS = 32768  # the slice config's max_points
VOXEL = 0.5
# K1: target and source scans; K2: three lanes' targets
KERNEL_FRAMES = (10, 11, 20, N_FRAMES // 2, N_FRAMES - 20)
# the fidelity route: its last eighth (frames 105-119) re-drives frames 0-14,
# so the loop tick of frame 110 finds frame 5; the checkpoint is written
# after frame 60 (the first loop tick), the snapshot after frame 100
FID_FRAMES = 120
FID_CHECKPOINT = 60
FID_SNAPSHOT = 100
# one frame of it is thinned to every 4th raw point, so that its voxel count
# lies below the cloud pad and frame_npts can be told from the pad
FID_SPARSE = 77
# [cli-batch]: 4 lanes of 200 frames, each through its own world on one
# shared route whose last 25 frames re-drive its start (the ticks of frames
# 180 and 190 can close a loop)
BATCH_LANES = 4
BATCH_FRAMES = 200
ARTIFACTS = ("trajectory.txt", "trajectory_tum.txt", "map.ply",
             "occupancy.npz", "occupancy.pgm", "metrics.jsonl")


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


def time_graph_ms(fn, reps: int = 20, replays: int = 5) -> float:
    """Mean device ms per call of ``fn`` (kernel launches and allocations
    only): ``reps`` calls captured in a CUDA graph and replayed, so the
    host's launch cost does not hide a kernel of a few microseconds."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * replays)


def card_rates(dev) -> dict:
    """What the bounds are computed from: SM count, the card's maximum SM
    clock, and the data-sheet memory rate of an H100 SXM."""
    import torch

    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60,
    )
    check(r.returncode == 0, "nvidia-smi did not give the SM clock")
    mhz = float(r.stdout.strip().splitlines()[0])
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return {
        "sms": sms, "sm_clock_mhz": mhz,
        # FP32 instructions a second without FMA: SMs x 128 lanes x clock
        "fp32_instr_per_s": sms * 128 * mhz * 1e6,
        "hbm_bytes_per_s": 3.35e12,
    }


def bound_ms(evaluations: int, n_bytes: int, rates: dict) -> tuple[float, str]:
    """The least time the card could take: 8 FP32 instructions (3 sub, 3 mul,
    2 add; the exact-equality contract forbids FMA) per distance evaluation
    at the instruction rate, against the bytes once over the memory rate."""
    t_ops = 8 * evaluations / rates["fp32_instr_per_s"] * 1e3
    t_bytes = n_bytes / rates["hbm_bytes_per_s"] * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def prepare_route():
    """The 500-frame corridor route, rendered and host-voxelized: the
    prepared scans, the ground truth and the raw scans."""
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
    raw = [renderer.render(gt[i], rng, max_points=RAW_POINTS)
           for i in range(N_FRAMES)]
    scans = [voxel_downsample_host(r, VOXEL, N_POINTS) for r in raw]
    return scans, gt, raw


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def check_kernels(scans, dev):
    """K1 and K2 against their plain versions at main-path shapes, and at
    the edges of their designs; uses the scans of ``KERNEL_FRAMES``."""
    import numpy as np
    import torch

    from lidar_slam_tpu_torch.ops import knn_cuda
    from lidar_slam_tpu_torch.ops.normals import estimate_normals_adaptive
    from lidar_slam_tpu_torch.types import PointCloud

    N = N_POINTS
    rates = card_rates(dev)
    log(f"[bound] {rates['sms']} SMs x 128 FP32 lanes x "
        f"{rates['sm_clock_mhz']:.0f} MHz = "
        f"{rates['fp32_instr_per_s'] / 1e12:.3f} T FP32 instructions/s (no "
        f"FMA: 8 per distance evaluation); memory "
        f"{rates['hbm_bytes_per_s'] / 1e12:.2f} TB/s (data sheet)")

    def cloud(i):
        pts = np.zeros((N, 3), np.float32)
        pts[: len(scans[i])] = scans[i]
        return (torch.from_numpy(pts).to(dev),
                torch.from_numpy(np.arange(N) < len(scans[i])).to(dev))

    def same(a, b, what):
        torch.cuda.synchronize()
        for x, y in zip(a, b):
            check(x.shape == y.shape and torch.equal(x, y), what)

    frames = KERNEL_FRAMES
    tgt, tmask = cloud(frames[0])
    src_pts, src_mask = cloud(frames[1])
    nrm = estimate_normals_adaptive(tgt, tmask, r_min=1.2, window=4096,
                                    probe_stride=2)
    # the odometry ICP's source: sentinel-displaced, strided to 4,096 rows
    src_pts = torch.where(src_mask[:, None], src_pts,
                          torch.full_like(src_pts, 1.0e6))
    src_full = src_pts.contiguous()
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

    def k1_both(s, ts=256, window=4096):
        return (knn_cuda._slab_query(s, index, ts, window, 3.0),
                knn_cuda._slab_query(s, index, ts, window, 3.0,
                                     knn_cuda._slab_query_plain))

    out_k, out_p = k1_both(src)
    same(out_k, out_p, "K1 query (qn, d2, idx, starts) differs from plain")
    check(torch.equal(out_k[3], knn_cuda._slab_starts_lut(
        src, index, 256, 4096, 3.0)),
        "K1's in-kernel window starts differ from _slab_starts_lut")
    # edges: a source count that is no multiple of the tile; a tile whose
    # rows are all sentinel (invalid source rows sort to the end)
    same(*k1_both(src[:3901]), "K1 with a ragged source count differs")
    src_s = src.clone()
    src_s[-300:] = 1.0e6
    out_k, out_p = k1_both(src_s)
    same(out_k, out_p, "K1 with an all-sentinel tile differs")
    err1 = max(err1, float((out_k[1] - out_p[1]).abs().max()))
    ms1 = time_graph_ms(
        lambda: knn_cuda._slab_query_cuda(src[None], index, 256, 4096, 3.0))
    pms1 = time_ms(
        lambda: knn_cuda._slab_query_plain(src[None], index, 256, 4096, 3.0))
    k1_call = knn_cuda.SlabBackend().prepare_match(tgt, tmask, nrm)
    call1 = time_ms(lambda: k1_call(src), reps=200)
    b1, by1 = bound_ms(
        4096 * 4096,
        _nbytes(src, index.tgt8, index.lut, *out_k), rates)
    log(f"[kernels] K1 match_slab S=4096 T=32768 window=4096: exact (idx, "
        f"d2, rows, starts; ragged S; sentinel tile); kernel {ms1:.4f} ms, "
        f"bound {b1:.4f} ms ({by1}), plain {pms1:.4f} ms; whole call "
        f"(prepare_match's query, host included) {call1:.4f} ms")
    results.append(dict(
        name="match_slab", route="cuda",
        source="lidar_slam_tpu_torch/csrc/knn.cu",
        replaces=knn_cuda.MATCH_SLAB.replaces, max_abs_err=err1,
        ms=ms1, plain_ms=pms1, bound_ms=b1, bound_by=by1, library_ms=None,
        call_ms=call1, shape="4096 x window 4096 of 32768", phase="engine",
    ))

    # K2: 3 lanes in one launch, each 4,096 sources vs 32,768 targets ---------
    lanes = [cloud(i) for i in frames[2:5]]
    t3 = torch.stack([c[0] for c in lanes])
    m3 = torch.stack([c[1] for c in lanes])
    s3 = src[None].expand(3, -1, -1).contiguous()

    def k2_same(s, t, m, what):
        got, want = knn_cuda.nn1(s, t, m), knn_cuda.nn1_torch(s, t, m)
        same(got, want, what)
        return float((got[1] - want[1]).abs().max()), got[0]

    err2, _ = k2_same(s3, t3, m3, "K2 (3 lanes) differs from the plain version")
    # masked tail: the last 40% of the targets invalid
    m_tail = tmask.clone()
    m_tail[int(0.6 * N):] = False
    e, i_k = k2_same(src, tgt, m_tail, "K2 (masked tail) differs from plain")
    check(int(i_k.max()) < int(0.6 * N), "K2 picked a masked target")
    err2 = max(err2, e)
    # edges: one lane; a target count that is no multiple of the tile or of 4
    e, _ = k2_same(s3[:1], t3[:1], m3[:1], "K2 (1 lane) differs from plain")
    err2 = max(err2, e)
    e, _ = k2_same(s3[:2, :777], t3[:2, :30001], m3[:2, :30001],
                   "K2 (ragged S and T) differs from plain")
    err2 = max(err2, e)
    # a forced tie: equal target rows on both sides of group, tile and split
    # boundaries; a source on the point itself must get the lower index
    t_tie, s_tie = t3[:1].clone(), s3[:1].clone()
    m_tie = torch.ones_like(m3[:1])
    bounds = [16, 512, 1024, 2048, 4096, 16384, N - 1]
    for r, b in enumerate(bounds):
        t_tie[0, b - 1] = torch.tensor([500.0 + r, -500.0, 250.0], device=dev)
        t_tie[0, b] = t_tie[0, b - 1]
        t_tie[0, (b + 9000) % N] = t_tie[0, b - 1]
        s_tie[0, r] = t_tie[0, b - 1]
    e, i_k = k2_same(s_tie, t_tie, m_tie, "K2 (forced ties) differs from plain")
    for r, b in enumerate(bounds):
        check(int(i_k[0, r]) == min(b - 1, (b + 9000) % N),
              f"K2 did not keep the first index of a tie at boundary {b}")
    err2 = max(err2, e)
    # one layout, several queries
    query = knn_cuda.nn1.prepare(t3, m3)
    for shift in (0.0, 0.25):
        same(query(s3 + shift), knn_cuda.nn1_torch(s3 + shift, t3, m3),
             "K2 prepare/query differs from the plain version")
    ms2 = time_graph_ms(lambda: query(s3), reps=10)
    call2 = time_ms(lambda: knn_cuda.nn1(s3, t3, m3), reps=20)
    pms2 = time_ms(lambda: knn_cuda.nn1_torch(s3, t3, m3), reps=3)
    i_k, d_k = query(s3)
    b2, by2 = bound_ms(3 * 4096 * N, _nbytes(s3, t3, m3, i_k, d_k), rates)
    log(f"[kernels] K2 nn1 3 lanes x S=4096 x T=32768: exact (idx, d2; masked "
        f"tail; 1 lane; ragged S, T; ties at split boundaries; "
        f"prepare/query); kernel {ms2:.4f} ms, bound {b2:.4f} ms ({by2}), "
        f"plain {pms2:.4f} ms; single call with layout {call2:.4f} ms")
    results.append(dict(
        name="nn1", route="cuda", source="lidar_slam_tpu_torch/csrc/knn.cu",
        replaces=knn_cuda.NN1.replaces, max_abs_err=err2,
        ms=ms2, plain_ms=pms2, bound_ms=b2, bound_by=by2, library_ms=None,
        call_ms=call2, shape="3x4096x32768", phase="engine",
    ))

    # K2 at the exact modes' shapes: fidelity odometry is one lane of 32,768
    # sources against 32,768 targets, full-density verification three ----
    sms = rates["sms"]
    full = [torch.where(m[:, None], c, torch.full_like(c, 1.0e6))
            for c, m in lanes[1:] + lanes[:1]]  # sentinel-displaced sources,
    # as ICP makes them: each lane's source is another frame's cloud
    for n_lanes, s_big in ((1, src_full[None]), (3, torch.stack(full))):
        t_b, m_b = t3[:n_lanes], m3[:n_lanes]
        if n_lanes == 1:
            t_b, m_b = tgt[None], tmask[None]
        splits, tiles_per = knn_cuda._nn1_plan(n_lanes, N, N, sms)
        blocks = n_lanes * (N // 512) * splits
        check(splits * tiles_per >= N // 512 and (splits - 1) * tiles_per < N // 512,
              f"K2 plan at {n_lanes}x{N}x{N} does not cover the target")
        check(splits <= 65535 and n_lanes <= 65535, "K2 grid out of range")
        e, _ = k2_same(s_big, t_b, m_b,
                       f"K2 ({n_lanes} x {N} x {N}) differs from plain")
        q_big = knn_cuda.nn1.prepare(t_b, m_b)
        ms_b = time_graph_ms(lambda: q_big(s_big), reps=5)
        pms_b = time_ms(lambda: knn_cuda.nn1_torch(s_big, t_b, m_b), reps=2)
        i_b, d_b = q_big(s_big)
        b_b, by_b = bound_ms(n_lanes * N * N,
                             _nbytes(s_big, t_b, m_b, i_b, d_b), rates)
        shape = f"{n_lanes}x{N}x{N}"
        log(f"[kernels] K2 nn1 {shape}: exact (idx, d2); plan {splits} splits "
            f"x {tiles_per} tiles, {blocks} blocks; kernel {ms_b:.4f} ms, "
            f"bound {b_b:.4f} ms ({by_b}), plain {pms_b:.4f} ms")
        results.append(dict(
            name=f"nn1@{shape}", route="cuda",
            source="lidar_slam_tpu_torch/csrc/knn.cu",
            replaces=knn_cuda.NN1.replaces, max_abs_err=e, ms=ms_b,
            plain_ms=pms_b, bound_ms=b_b, bound_by=by_b, library_ms=None,
            shape=shape, phase="cli-fidelity",
        ))
    results += check_lane_kernels(scans, cloud, rates, dev)
    return results


def check_lane_kernels(scans, cloud, rates, dev):
    """The batched engine's shapes: K1 over 4 ICP lanes in one launch (each
    lane against its own target, LUT and scale), exact against the plain
    version and bit-identical, lane by lane, to a one-lane launch; K2 over a
    verification tranche of 4 lanes (12 ICP lanes)."""
    import torch

    from lidar_slam_tpu_torch.ops import knn_cuda
    from lidar_slam_tpu_torch.ops.normals import estimate_normals_adaptive
    from lidar_slam_tpu_torch.types import PointCloud

    def source(i):
        """Frame i as the odometry ICP's source: sentinel-displaced, strided
        to 4,096 rows."""
        pts, mask = cloud(i)
        pts = torch.where(mask[:, None], pts, torch.full_like(pts, 1.0e6))
        return PointCloud(pts, mask).subsample(4096).points

    def exact(a, b, what):
        torch.cuda.synchronize()
        for x, y in zip(a, b):
            check(x.shape == y.shape and torch.equal(x, y), what)

    B = BATCH_LANES
    frames = [10 + (len(scans) - 40) * b // B for b in range(B)]
    tgts = [cloud(i) for i in frames]
    tgt = torch.stack([t for t, _ in tgts])
    tmask = torch.stack([m for _, m in tgts])
    nrm = torch.stack([estimate_normals_adaptive(t, m, r_min=1.2, window=4096,
                                                 probe_stride=2)
                       for t, m in tgts])
    src = torch.stack([source(i + 1) for i in frames]).contiguous()
    index = knn_cuda._build_slab_index(tgt, tmask, nrm)
    before = knn_cuda.MATCH_SLAB.launches
    out_k = knn_cuda._slab_query(src, index, 256, 4096, 3.0)
    check(knn_cuda.MATCH_SLAB.launches == before + 1,
          "K1 over lanes took more than one launch")
    out_p = knn_cuda._slab_query(src, index, 256, 4096, 3.0,
                                 knn_cuda._slab_query_plain)
    exact(out_k, out_p, f"K1 over {B} lanes (qn, d2, idx, starts) differs "
          "from the plain version")
    for b in range(B):
        one = knn_cuda._build_slab_index(tgt[b], tmask[b], nrm[b])
        exact([x[b] for x in out_k],
              knn_cuda._slab_query(src[b], one, 256, 4096, 3.0),
              f"K1 lane {b} differs from a one-lane launch on it")
    err1 = max(float((a.float() - b.float()).abs().max())
               for a, b in zip(out_k, out_p))
    ms1 = time_graph_ms(
        lambda: knn_cuda._slab_query_cuda(src, index, 256, 4096, 3.0))
    pms1 = time_ms(
        lambda: knn_cuda._slab_query_plain(src, index, 256, 4096, 3.0), reps=5)
    b1, by1 = bound_ms(B * 4096 * 4096,
                       _nbytes(src, index.tgt8, index.lut, *out_k), rates)
    log(f"[kernels] K1 match_slab {B} lanes x S=4096 x window 4096 of "
        f"T=32768, one launch: exact (idx, d2, rows, starts) and each lane "
        f"bit-identical to a one-lane launch; kernel {ms1:.4f} ms, bound "
        f"{b1:.4f} ms ({by1}), plain {pms1:.4f} ms")
    results = [dict(
        name=f"match_slab@{B}x4096x32768", route="cuda",
        source="lidar_slam_tpu_torch/csrc/knn.cu",
        replaces=knn_cuda.MATCH_SLAB.replaces, max_abs_err=err1, ms=ms1,
        plain_ms=pms1, bound_ms=b1, bound_by=by1, library_ms=None,
        shape=f"{B} lanes x 4096 x window 4096 of 32768", phase="cli-batch",
    )]

    # K2: a tranche of every lane, 3 candidates each against its query
    L = 3 * B
    cands = [cloud(f) for f in range(30, 30 + 30 * L, 30)]
    t12 = torch.stack([c for c, _ in cands])
    m12 = torch.stack([m for _, m in cands])
    s12 = src.repeat_interleave(3, dim=0).contiguous()
    got, want = knn_cuda.nn1(s12, t12, m12), knn_cuda.nn1_torch(s12, t12, m12)
    exact(got, want, f"K2 ({L} lanes) differs from the plain version")
    err2 = float((got[1] - want[1]).abs().max())
    query = knn_cuda.nn1.prepare(t12, m12)
    ms2 = time_graph_ms(lambda: query(s12), reps=10)
    pms2 = time_ms(lambda: knn_cuda.nn1_torch(s12, t12, m12), reps=3)
    b2, by2 = bound_ms(L * 4096 * N_POINTS, _nbytes(s12, t12, m12, *got), rates)
    log(f"[kernels] K2 nn1 {L} lanes x S=4096 x T={N_POINTS} (a verification "
        f"tranche of {B} lanes): exact (idx, d2); kernel {ms2:.4f} ms, bound "
        f"{b2:.4f} ms ({by2}), plain {pms2:.4f} ms")
    results.append(dict(
        name=f"nn1@{L}x4096x{N_POINTS}", route="cuda",
        source="lidar_slam_tpu_torch/csrc/knn.cu",
        replaces=knn_cuda.NN1.replaces, max_abs_err=err2, ms=ms2,
        plain_ms=pms2, bound_ms=b2, bound_by=by2, library_ms=None,
        shape=f"{L}x4096x{N_POINTS}", phase="cli-batch",
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
    with KernelShapes() as shapes:
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
    return dict(launches=launches, loops=m["loop_count"],
                verify_fired=m["verify_fired"], ate=ate1, spy=shapes)


class KernelShapes:
    """Launches of each kernel by ``lanes x sources``, counted while a
    ``with`` block runs (it wraps the kernels' ``launch`` and calls the
    originals): ``shapes["nn1"]["3x4096"]``."""

    def __init__(self):
        self.shapes = {"match_slab": {}, "nn1": {}}

    def __enter__(self):
        from lidar_slam_tpu_torch.ops import knn_cuda

        # the lanes and sources of a launch: lst_match_slab(src, lanes, S,
        # ...), lst_nn1(src, soa, lanes, S, ...)
        where = {"match_slab": 1, "nn1": 2}
        self._orig = {k: k.launch for k in knn_cuda.KERNELS}
        for k in knn_cuda.KERNELS:
            def launch(*args, k=k, orig=k.launch, at=where[k.name]):
                orig(*args)
                key = f"{args[at]}x{args[at + 1]}"
                counts = self.shapes[k.name]
                counts[key] = counts.get(key, 0) + 1
            k.launch = launch
        return self

    def __exit__(self, *exc):
        for k, orig in self._orig.items():
            k.launch = orig


class RunSpy(KernelShapes):
    """What a command-line run does not write to its artifacts, recorded
    while it runs in this process: the trajectory just before and after
    ``finalize``, the engine's counters, every optimize-on-find chunk (LM
    iterations and the largest pose move), and each kernel's launches by
    ``lanes x sources``. It patches the package's functions for the length
    of a ``with`` block and calls the originals."""

    def __init__(self):
        super().__init__()
        self.before = self.after = self.metrics = None
        self.chunks = []

    def __enter__(self):
        from lidar_slam_tpu_torch.models import pipeline

        super().__enter__()
        self._engine = (pipeline.SlamEngine.finalize, pipeline.optimize_on_find)
        fin, opt = self._engine
        spy = self

        def finalize(engine):
            spy.before = engine.trajectory()
            res = fin(engine)
            spy.after, spy.metrics = engine.trajectory(), engine.metrics()
            return res

        def optimize_on_find(state, config):
            old = state.poses[: state.n_poses, :3, 3].clone()
            res = opt(state, config)
            move = (state.poses[: state.n_poses, :3, 3] - old).norm(dim=1).max()
            spy.chunks.append(dict(iterations=res.iterations,
                                   converged=res.converged, moved=float(move)))
            return res

        pipeline.SlamEngine.finalize = finalize
        pipeline.optimize_on_find = optimize_on_find
        return self

    def __exit__(self, *exc):
        from lidar_slam_tpu_torch.models import pipeline

        pipeline.SlamEngine.finalize, pipeline.optimize_on_find = self._engine
        super().__exit__(*exc)


def run_cli(tag, argv, n_frames, dev):
    """One ``run`` of the command line in this process, with the kernels'
    counts set to 0 just before and read just after; checks the exit code
    and the artifacts and returns what the phase checks need."""
    import numpy as np
    import torch

    from lidar_slam_tpu_torch import cli
    from lidar_slam_tpu_torch.ops import knn_cuda
    from lidar_slam_tpu_torch.utils.io import load_ply

    out_dir = argv[argv.index("--out-dir") + 1]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    for k in knn_cuda.KERNELS:
        k.launches = 0
    with RunSpy() as spy:
        rc = cli.main(argv)
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in knn_cuda.KERNELS}
    peak = torch.cuda.max_memory_allocated(dev)
    check(rc == 0, f"[{tag}] the command line returned {rc}")
    for name in ARTIFACTS:
        path = os.path.join(out_dir, name)
        check(os.path.isfile(path) and os.path.getsize(path) > 0,
              f"[{tag}] artifact {name} is missing or empty")
    traj = np.loadtxt(os.path.join(out_dir, "trajectory.txt"))
    check(traj.shape == (n_frames, 12) and bool(np.isfinite(traj).all()),
          f"[{tag}] trajectory.txt is not one finite pose per frame")
    cloud = load_ply(os.path.join(out_dir, "map.ply"))
    check(cloud.ndim == 2 and cloud.shape[1] == 3 and len(cloud) > 0
          and bool(np.isfinite(cloud).all()), f"[{tag}] map.ply does not read back")
    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    summary = rows.pop()
    check(summary.get("summary") is True and len(rows) == n_frames,
          f"[{tag}] metrics.jsonl is not one row per frame and a summary")
    with np.load(os.path.join(out_dir, "occupancy.npz")) as occ:
        check(occ["data"].size > 0 and int((occ["data"] > 0).sum()) > 0,
              f"[{tag}] the occupancy grid is empty")
    times = {k: summary[k] for k in ("prep_sec", "upload_sec", "device_sec",
                                     "push_sec", "finalize_sec") if k in summary}
    log(f"[{tag}] {summary['scans_per_sec']:.3f} scans/s over "
        f"{summary['wall_sec']:.3f} s; "
        + ", ".join(f"{k} {v:.3f}" for k, v in times.items())
        + f"; peak device memory {peak / 2**30:.3f} GiB; ATE "
        f"{summary['ate_rmse']:.4f} m; loops {summary['loop_count']}; launches "
        f"{launches}, by lanes x sources {spy.shapes}; map.ply "
        f"{len(cloud)} points")
    return dict(summary=summary, rows=rows, launches=launches, spy=spy,
                out_dir=out_dir)


def run_cli_fast(raw, gt, engine, work, dev):
    """[cli-fast]: the engine phase's route from files, through the command
    line; the two must agree."""
    from lidar_slam_tpu_torch.utils.dataset import save_poses_kitti
    from lidar_slam_tpu_torch.utils.io import save_ply

    data = os.path.join(work, "route500")
    os.makedirs(data)
    for i, pts in enumerate(raw):
        save_ply(os.path.join(data, f"{i:06d}.ply"), pts)
    save_poses_kitti(os.path.join(data, "poses_gt.txt"), gt)
    out = run_cli("cli-fast", [
        "run", "--data-dir", data, "--out-dir", os.path.join(work, "out_fast"),
        "--mode", "fast", "--resident",
    ], N_FRAMES, dev)
    s, spy = out["summary"], out["spy"]
    check(out["launches"]["match_slab"] > 0 and out["launches"]["nn1"] > 0,
          f"[cli-fast] a kernel was not launched: {out['launches']}")
    # The command line sizes the keyframe DB to the dataset (508 frames
    # against the engine phase's 4,608) and the cloud pad to the prepared
    # maximum; neither may change what is found. ATE to 1e-4 m: the DB's
    # capacity is the length of the f64 pose-graph solve's prefix sums.
    check(s["loop_count"] == engine["loops"],
          f"[cli-fast] loops {s['loop_count']} != engine phase {engine['loops']}")
    check(spy.metrics["verify_fired"] == engine["verify_fired"],
          f"[cli-fast] verify_fired {spy.metrics['verify_fired']} != engine "
          f"phase {engine['verify_fired']}")
    check(out["launches"] == engine["launches"],
          f"[cli-fast] launches {out['launches']} != engine phase "
          f"{engine['launches']}")
    check(abs(s["ate_rmse"] - engine["ate"]) < 1e-4,
          f"[cli-fast] ATE {s['ate_rmse']} != engine phase {engine['ate']}")
    check(not spy.chunks, "[cli-fast] fast mode optimized mid-run")
    return out


def run_cli_fidelity(work, dev):
    """[cli-fidelity] and [cli-resume]: fidelity mode, streaming, raw scans
    through the device voxelizer, with a checkpoint on the way; then the
    same command from the checkpoint."""
    import numpy as np

    from lidar_slam_tpu_torch.config import SlamConfig
    from lidar_slam_tpu_torch.utils.dataset import load_gt_poses, make_dataset
    from lidar_slam_tpu_torch.utils.io import load_ply, save_ply
    from lidar_slam_tpu_torch.utils.metrics import ate_rmse
    from lidar_slam_tpu_torch.utils.native import voxel_downsample_host

    data = os.path.join(work, "route120")
    t0 = time.perf_counter()
    make_dataset(data, n_frames=FID_FRAMES, seed=0, max_points=RAW_POINTS)
    sparse = os.path.join(data, f"{FID_SPARSE:06d}.ply")
    save_ply(sparse, load_ply(sparse)[::4])
    log(f"[prep] {FID_FRAMES}-frame dataset written in "
        f"{time.perf_counter() - t0:.1f} s")
    gt = load_gt_poses(os.path.join(data, "poses_gt.txt"))
    base = ["run", "--data-dir", data, "--mode", "fidelity",
            "--no-host-voxelize"]
    out = run_cli("cli-fidelity", base + [
        "--out-dir", os.path.join(work, "out_fid"),
        "--checkpoint-every", str(FID_CHECKPOINT),
        "--export-every", str(FID_SNAPSHOT),
    ], FID_FRAMES, dev)
    s, spy = out["summary"], out["spy"]
    check(s["loop_count"] >= 1, "[cli-fidelity] no loop closed on the revisit")
    check(out["launches"]["nn1"] > 0 and out["launches"]["match_slab"] == 0,
          f"[cli-fidelity] expected K2 only: {out['launches']}")
    check(set(spy.shapes["nn1"]) == {f"1x{N_POINTS}", f"3x{N_POINTS}"},
          f"[cli-fidelity] K2 ran at other shapes: {spy.shapes['nn1']}")
    check(len(spy.chunks) >= 1 and max(c["moved"] for c in spy.chunks) > 1e-4,
          f"[cli-fidelity] optimize-on-find did not move a pose: {spy.chunks}")
    ate0, ate1 = ate_rmse(spy.before, gt), ate_rmse(spy.after, gt)
    check(ate1 <= ate0 + 0.05,
          f"[cli-fidelity] finalize made ATE worse: {ate0} -> {ate1}")
    # frame_npts is the count of occupied voxels (at most the cloud pad);
    # only the thinned frame's lies below the pad
    npts = [r["npts"] for r in out["rows"]]
    for i in sorted({*range(0, FID_FRAMES, 7), FID_SPARSE}):
        raw = load_ply(os.path.join(data, f"{i:06d}.ply"))
        want = min(len(voxel_downsample_host(raw, VOXEL)), N_POINTS)
        check(npts[i] == want, f"[cli-fidelity] frame_npts[{i}] = {npts[i]}, "
              f"{want} voxels are occupied")
    check(SlamConfig().min_points <= npts[FID_SPARSE] < N_POINTS,
          f"[cli-fidelity] the thinned frame has {npts[FID_SPARSE]} voxels, "
          "not a count below the pad")
    iters = [r["icp_iters"] for r in out["rows"][1:]]
    log(f"[cli-fidelity] ATE {ate0:.4f} m before finalize, {ate1:.4f} m after; "
        f"optimize-on-find chunks {spy.chunks}; mean icp_iters "
        f"{float(np.mean(iters)):.3f}; npts {min(npts)}-{max(npts)}")

    ckpt = os.path.join(out["out_dir"], "checkpoint.npz")
    check(os.path.isfile(ckpt), "[cli-fidelity] no checkpoint was written")
    with np.load(ckpt) as c:
        frame, max_frames = int(c["__extra__/frame"]), c["poses"].shape[0]
    check(frame == FID_CHECKPOINT + 1, f"checkpoint at frame {frame}")
    res = run_cli("cli-resume", base + [
        "--out-dir", os.path.join(work, "out_resume"), "--resume", ckpt,
        "--max-frames", str(max_frames), "--max-points", str(N_POINTS),
    ], FID_FRAMES, dev)
    same = bool(np.array_equal(res["spy"].after, spy.after))
    diff = float(np.abs(res["spy"].after - spy.after).max())
    log(f"[cli-resume] resumed at frame {frame}: final trajectory "
        f"{'bit-identical' if same else 'DIFFERS'} (max abs diff {diff:.3e}); "
        f"loops {res['summary']['loop_count']}")
    check(same, f"[cli-resume] the resumed run differs by {diff}")
    check(res["summary"]["loop_count"] == s["loop_count"],
          "[cli-resume] the resumed run found other loops")
    return out, res



def render_lane(b: int, data: str, n_frames: int, raw_points: int) -> None:
    """Lane ``b`` of [cli-batch] as ``.ply`` frames with ``poses_gt.txt``:
    world ``b`` on the shared route of ``n_frames``."""
    import numpy as np

    from lidar_slam_tpu_torch.utils.dataset import (
        ScanRenderer,
        generate_trajectory,
        generate_world,
        route_half_for,
        save_poses_kitti,
    )
    from lidar_slam_tpu_torch.utils.io import save_ply

    half = route_half_for(n_frames)
    gt = generate_trajectory(n_frames, half=half)
    renderer = ScanRenderer(generate_world(b, route_half=half, corridor=60.0))
    rng = np.random.default_rng(b)
    os.makedirs(data)
    for i in range(n_frames):
        save_ply(os.path.join(data, f"{i:06d}.ply"),
                 renderer.render(gt[i], rng, max_points=raw_points))
    save_poses_kitti(os.path.join(data, "poses_gt.txt"), gt)


def run_cli_batch(work, dev):
    """[cli-batch]: ``run-batch --mode fast --resident`` on 4 lanes of
    different worlds, in this process; then the port's single engine on each
    lane's prepared scans (those the command line handed the batched engine)
    with the same configuration. Each lane must close a loop and give the
    single run's loops and firing ticks, its ATE within 0.01 m; the batched
    run must launch K1 fewer times than the four single runs together."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    import numpy as np
    import torch

    from lidar_slam_tpu_torch import cli
    from lidar_slam_tpu_torch.models.pipeline import SlamEngine
    from lidar_slam_tpu_torch.ops import knn_cuda
    from lidar_slam_tpu_torch.parallel import batched
    from lidar_slam_tpu_torch.utils.dataset import load_gt_poses
    from lidar_slam_tpu_torch.utils.metrics import ate_rmse

    B, N = BATCH_LANES, BATCH_FRAMES
    names = [f"lane{b}" for b in range(B)]
    dirs = [os.path.join(work, n) for n in names]
    t0 = time.perf_counter()
    spawn = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(B, mp_context=spawn) as pool:
        list(pool.map(render_lane, range(B), dirs, [N] * B, [RAW_POINTS] * B))
    log(f"[prep] {B} x {N} frames rendered and written as .ply in "
        f"{time.perf_counter() - t0:.1f} s ({B} processes)")
    gt = load_gt_poses(os.path.join(dirs[0], "poses_gt.txt"))

    # the command line's batched engine, the prepared scans it is given and
    # its trajectories before finalize
    seen = {}
    Engine = batched.BatchedSlamEngine
    preload, finalize = Engine.preload, Engine.finalize

    def spy_preload(engine, seqs, frame0=0):
        seen.update(engine=engine, seqs=seqs)
        return preload(engine, seqs, frame0)

    def spy_finalize(engine):
        seen["odometry"] = engine.trajectories()
        return finalize(engine)

    out_dir = os.path.join(work, "out_batch")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    for k in knn_cuda.KERNELS:
        k.launches = 0
    Engine.preload, Engine.finalize = spy_preload, spy_finalize
    try:
        with KernelShapes() as spy:
            rc = cli.main(["run-batch", "--data-dirs", ",".join(dirs),
                           "--out-dir", out_dir, "--mode", "fast", "--resident"])
        torch.cuda.synchronize()
    finally:
        Engine.preload, Engine.finalize = preload, finalize
    launches = {k.name: k.launches for k in knn_cuda.KERNELS}
    peak = torch.cuda.max_memory_allocated(dev)
    check(rc == 0, f"[cli-batch] the command line returned {rc}")
    files = ["metrics.json"] + [f"trajectory_{n}.txt" for n in names]
    check(sorted(os.listdir(out_dir)) == sorted(files),
          f"[cli-batch] wrote {sorted(os.listdir(out_dir))}")
    with open(os.path.join(out_dir, "metrics.json")) as f:
        m = json.load(f)
    check(m["sequences"] == B and m["frames"] == N and m["mode"] == "fast",
          f"[cli-batch] metrics.json: {m}")
    for n in names:
        t = np.loadtxt(os.path.join(out_dir, f"trajectory_{n}.txt"))
        check(t.shape == (N, 12) and bool(np.isfinite(t).all()),
              f"[cli-batch] trajectory_{n}.txt is not one finite pose per frame")
    check(all(n >= 1 for n in m["loops"]),
          f"[cli-batch] a lane closed no loop: {m['loops']}")
    check(launches["match_slab"] > 0 and launches["nn1"] > 0,
          f"[cli-batch] a kernel was not launched: {launches}")
    eng = seen.pop("engine")
    lanes_m, lanes_t, cfg = eng.metrics(), eng.trajectories(), eng.config
    del eng  # the single runs' peak memory is their own
    odo_b = [ate_rmse(t, gt) for t in seen["odometry"]]
    r = m["resident"]
    log(f"[cli-batch] {B} lanes x {N} frames: {m['scans_per_sec_aggregate']:.3f} "
        f"scans/s aggregate, {m['scans_per_sec_per_lane']:.3f} per lane over "
        f"{m['wall_sec']:.3f} s; prep {r['prep_sec']:.3f}, upload "
        f"{r['upload_sec']:.3f}, device {r['device_sec']:.3f} s "
        f"({r['scans_per_sec_device_aggregate']:.3f} scans/s device-side "
        f"aggregate, {N / r['device_sec']:.3f} per lane); peak device memory "
        f"{peak / 2**30:.3f} GiB; loops {m['loops']}, verify_fired "
        f"{[x['verify_fired'] for x in lanes_m]}; ATE before finalize "
        f"{[round(a, 4) for a in odo_b]}, after {m['ate_rmse']}; launches "
        f"{launches}, by lanes x sources {spy.shapes}")

    # the same prepared scans and configuration through the single engine
    one_launches = {k.name: 0 for k in knn_cuda.KERNELS}
    t_up = t_dev = 0.0
    one_peak = 0
    with KernelShapes() as one_spy:
        for b in range(B):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            for k in knn_cuda.KERNELS:
                k.launches = 0
            one = SlamEngine(cfg, dev)
            t0 = time.perf_counter()
            one.preload(seen["seqs"][b])
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            one.run_preloaded()
            odo = one.trajectory()
            one.finalize()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            t_up, t_dev = t_up + (t1 - t0), t_dev + (t2 - t1)
            one_peak = max(one_peak, torch.cuda.max_memory_allocated(dev))
            for k in knn_cuda.KERNELS:
                one_launches[k.name] += k.launches
            om, traj = one.metrics(), one.trajectory()
            ate, ate_b = ate_rmse(traj, gt), m["ate_rmse"][names[b]]
            diff = float(np.abs(traj - lanes_t[b]).max())
            log(f"[cli-batch] lane {b} alone: {N / (t2 - t1):.3f} scans/s "
                f"device-side ({t2 - t1:.3f} s); loops {om['loop_count']} "
                f"(batched {lanes_m[b]['loop_count']}), verify_fired "
                f"{om['verify_fired']} (batched {lanes_m[b]['verify_fired']}), "
                f"ATE {ate_rmse(odo, gt):.4f} m before finalize, {ate:.4f} "
                f"after (batched {ate_b:.4f}); largest pose "
                f"difference from the batched lane {diff:.3e}"
                + (" (bit-identical)" if diff == 0.0 else ""))
            check(om["loop_count"] == lanes_m[b]["loop_count"],
                  f"[cli-batch] lane {b}: loops differ from the single engine")
            check(om["verify_fired"] == lanes_m[b]["verify_fired"],
                  f"[cli-batch] lane {b}: verify_fired differs from the "
                  "single engine")
            check(abs(ate - ate_b) <= 0.01,
                  f"[cli-batch] lane {b}: ATE {ate_b} batched, {ate} alone")
    log(f"[cli-batch] the {B} lanes alone, one after another: "
        f"{B * N / t_dev:.3f} scans/s device-side ({t_dev:.3f} s), upload "
        f"{t_up:.3f} s, peak device memory {one_peak / 2**30:.3f} GiB; "
        f"launches {one_launches}, by lanes x sources {one_spy.shapes}")
    check(launches["match_slab"] < one_launches["match_slab"],
          f"[cli-batch] K1 launches {launches['match_slab']} batched, "
          f"{one_launches['match_slab']} in the single runs")
    return dict(launches=launches, spy=spy,
                singles=dict(launches=one_launches, spy=one_spy))


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
    scans, gt, raw = prepare_route()
    log(f"[prep] {N_FRAMES} scans rendered and voxelized on the host in "
        f"{time.perf_counter() - t0:.1f} s (set-up, not timed below)")

    results = check_kernels(scans, dev)
    engine = run_engine(scans, gt, dev)
    del scans
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        fast = run_cli_fast(raw, gt, engine, work, dev)
        del raw
        fid, resumed = run_cli_fidelity(work, dev)
        batch = run_cli_batch(work, dev)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    # launches by phase: the whole kernel's for the unshaped entries, this
    # shape's (lanes x sources) for the others; "launches" is the count in
    # the phase whose main path gives the entry its shape
    runs = {"engine": engine, "cli-fast": fast, "cli-fidelity": fid,
            "cli-resume": resumed, "cli-batch": batch,
            "cli-batch-singles": batch["singles"]}
    for r in results:
        name, _, shape = r["name"].partition("@")
        if shape:
            key = "x".join(shape.split("x")[:2])
            r["launches_by_phase"] = {
                tag: run["spy"].shapes[name].get(key, 0)
                for tag, run in runs.items()
            }
        else:
            r["launches_by_phase"] = {
                tag: run["launches"][name] for tag, run in runs.items()
            }
        r["launches"] = r["launches_by_phase"][r["phase"]]
        check(r["launches"] > 0,
              f"{r['name']} was not launched in the {r['phase']} run")
    print(json.dumps({"kernels": results}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
