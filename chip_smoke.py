#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``lidar_slam_tpu_torch``) on one NVIDIA GPU.

Run from the repository root, with no install and no arguments:

    python3 chip_smoke.py

Phases, one line each (plus details):

1. environment: torch and CUDA versions, the card, nvcc, the power limit;
2. kernel build: ``csrc/knn.cu`` and ``csrc/icp_step.cu`` compiled by
   nvcc for sm_90a;
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
   (fidelity odometry, full-density verification); at the coarse
   verification's 3 x 512; and at the batched engine's: K1 over 4 ICP
   lanes in one launch (each lane exact against the plain version and
   bit-identical to a one-lane launch on it), K2 over 12 lanes of 4,096 and
   of 512 sources (a verification tranche of 4 lanes);
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
   device times, peak device memory and launches;
6. the ring-pattern raycast world (``make_rings_dataset``: 64 beams x
   1,024 azimuths, 65,536 rays, two 160-frame routes with a revisit, seeds
   0 and 1, written as ``.bin`` by two spawned processes that start after the
   build and render while the card works): K2 first at these phases'
   shapes (3 and 6 lanes x 4,096 and 512 sources x 16,384 targets), exact
   and timed as in phase 3; **cli-rings-knn**: ``run
   --mode fast --resident --normal-method knn --knn-backend grid`` on route
   0 (device k-NN normals, grid odometry, K2 verification; K1 must not
   run); **rings-engine**: the same prepared scans through ``SlamEngine``
   with ``knn_backend="slab"``, ``normal_stride=2`` and
   ``lc.ring_key_prefilter=64`` (the prefilter must run); **rings-batch**:
   routes 0 and 1 as two lanes of ``BatchedSlamEngine`` in cli-rings-knn's
   configuration, then each lane alone: loops and firing ticks equal, poses
   within 1e-3 m. Every run must close a loop with finite poses and prints
   its ATE before and after finalize;
7. the modules of phase 6 on the card, on three ring clouds and a corridor
   cloud padded to 32,768 rows: the exact k-NN against the same function on
   the CPU (neighbour sets equal except at a tie at rank k: distances
   closer than the matrix form's rounding), the k-NN PCA
   normals against the host's float64 KD-tree normals (median angle below
   0.01 degrees), the slab and grid searches against K2 at 4,096 x 32,768
   (equal on every row whose K2 neighbour lies inside their search), the
   ring-key prefilter's survivors against the CPU's on a 4,608-frame DB;
   then each module's ms per call on the card;
8. the port's multi-device code (``parallel/``), shard i on ``cuda:(i %
   card count)`` (on one card every shard shares it, and no copy between
   cards is measured): **sharded-search**: ``nn1_target_sharded`` over 4
   shards at 1 x 4,096 x 131,072 (ties across each shard boundary),
   ``nn1_source_sharded`` at 131,072 x 32,768 and ``sc_topk_sharded`` on a
   4,608-frame DB, each equal bit for bit to the unsharded call, with both
   calls' ms; **sharded-dense**: ``examples/sharded_dense_pipeline.py`` at
   full width (6 frames of 131,072 points through ``init_frame``, ``step``
   and ``loop_tick`` with ``make_sharded_nn1`` over 4 shards): ATE below
   1.0 m and the trajectory of unsharded K2 bit for bit; **dryrun**:
   ``dryrun_multichip(4)`` at 131,072 points; **batch-default**: ``run-batch
   --mode default --resident`` on [cli-batch]'s lanes 0 and 1, then the
   same prepared scans through ``BatchedSlamEngine(mesh=make_mesh({"seq":
   2, "pts": 1}))`` (the same loops, firing ticks and mid-run chunks, poses
   within 1e-5 m) and each lane alone through a batch of 1 (the same loops
   and ticks, poses within 1e-3 m); **batch-fidelity**: the same for
   ``--mode fidelity --no-host-voxelize`` on two raw 64-frame routes with a
   revisit, rendered by two spawned processes from the start;
9. **pg-cg**, the pose graph's CG solver: ``SlamEngine`` in default mode
   with ``PoseGraphConfig(solver="cg")`` on [batch-default]'s lane-0 scans
   (200 frames, K2 odometry at 32,768^2), every optimize-on-find chunk and
   the finalize ladder (float32 CG chunks, float64 Woodbury backstop) timed
   by stage (``finalize(timing=)``), beside the Woodbury lane; then
   ``optimize_chunked`` with ``relative_param=False`` on [engine]'s final
   graph (500 poses, 4,608 capacity), beside the float64 Woodbury LM on the
   same graph.

Every phase counts each kernel's launches by launch shape (lanes x sources
x targets, and K1's window; lanes x rows for ``icp_step``); every launch
must fall in a kernel row measured at its own shape: a K2 shape that no
row of phases 3 and 6 covers gets a row measured on the first inputs the
main path gave it there (``missing_k2_rows``), and every ``icp_step`` shape
a row on the first operands of its first launch other than ``apply``
(``icp_step_rows``: against ``icp_step_torch``, its CUDA-graph time, the
plain version's and its bytes bound). The last lines are a JSON line of per-kernel
results, the card's name and power limit, and ``{"ok": true, "device": {...}}``. Any failed check raises,
and the script exits non-zero without printing the result lines. There is
no CPU fallback: without CUDA it exits with code 2.
"""

from __future__ import annotations

import json
import multiprocessing
import os
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ProcessPoolExecutor

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
# [rings]: the ring-pattern raycast world at full width (64 beams x 1,024
# azimuths, 65,536 rays), two routes of 160 frames whose last eighth
# re-drives the start (seeds 0 and 1: [rings-batch]'s two lanes)
RING_FRAMES = 160
RING_BEAMS, RING_AZIMUTHS = 64, 1024
RING_SEEDS = (0, 1)
RING_PREFILTER = 64
# the rows a ring scan is padded to: ~8,900 points at 0.5 m, the command
# line's power-of-two pad (the loop verification's K2 targets)
RING_PAD = 16384
PREFILTER_DB = 4608  # the slice config's keyframe-DB capacity
# [sharded-*], [dryrun]: the pts axis, and examples/sharded_dense_pipeline.py's
# 131,072-point dense scans (its default 6 frames)
SHARDS = 4
DENSE_POINTS = 131072
DENSE_FRAMES = 6
# [batch-fidelity]: two raw lanes of 64 frames (the tick of frame 60 can
# close a loop on the revisit of the route's last eighth)
FIDB_FRAMES = 64
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


def k2_row(s, t, m, phase, rates, what, reps=10, plain_reps=3):
    """K2 at one launch shape, (L, S, 3) sources against (L, T, 3) targets:
    exact against its plain version (indices and distances equal), its
    device time, the plain time and its bound; the JSON row, named
    ``nn1@LxSxT`` after the launch it stands for and counted in ``phase``.
    The bound counts the distances this input needs: every source row
    against every valid target row. ``T`` is named padded to K2's 512-row
    tile, as the launch is."""
    import torch

    from lidar_slam_tpu_torch.ops import knn_cuda

    got, want = knn_cuda.nn1(s, t, m), knn_cuda.nn1_torch(s, t, m)
    torch.cuda.synchronize()
    for x, y in zip(got, want):
        check(x.shape == y.shape and torch.equal(x, y),
              f"K2 ({what}) differs from the plain version")
    err = float((got[1] - want[1]).abs().max())
    query = knn_cuda.nn1.prepare(t, m)
    ms = time_graph_ms(lambda: query(s), reps=reps)
    pms = time_ms(lambda: knn_cuda.nn1_torch(s, t, m), reps=plain_reps)
    L, S, T = s.shape[0], s.shape[1], t.shape[1]
    Tp = -(-T // knn_cuda._NN1_TILE) * knn_cuda._NN1_TILE
    valid = int(m.sum())
    b, by = bound_ms(S * valid, _nbytes(s, t, m, *got), rates)
    splits, tiles_per = knn_cuda._nn1_plan(L, S, Tp, rates["sms"])
    shape = f"{L}x{S}x{Tp}"  # the launch's shape: T padded to the tile
    log(f"[kernels] K2 nn1 {shape} ({what}; {T} targets, {valid} valid): exact "
        f"(idx, d2); plan {splits} splits x {tiles_per} tiles; kernel "
        f"{ms:.4f} ms, bound {b:.4f} ms ({by}), plain {pms:.4f} ms")
    return dict(
        name=f"nn1@{shape}", route="cuda",
        source="lidar_slam_tpu_torch/csrc/knn.cu",
        replaces=knn_cuda.NN1.replaces, max_abs_err=err, ms=ms,
        plain_ms=pms, bound_ms=b, bound_by=by, library_ms=None,
        shape=shape, phase=phase,
    )


def odometry_source(pts, mask, rows):
    """A cloud as an ICP's source: invalid rows at the sentinel, strided
    to ``rows`` rows."""
    import torch

    from lidar_slam_tpu_torch.types import PointCloud

    pts = torch.where(mask[:, None], pts, torch.full_like(pts, 1.0e6))
    return PointCloud(pts, mask).subsample(rows).points.contiguous()


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
        name=f"match_slab@1x4096x{N}w4096", route="cuda",
        source="lidar_slam_tpu_torch/csrc/knn.cu",
        replaces=knn_cuda.MATCH_SLAB.replaces, max_abs_err=err1,
        ms=ms1, plain_ms=pms1, bound_ms=b1, bound_by=by1, library_ms=None,
        call_ms=call1, shape=f"1x4096x{N}w4096", phase="engine",
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
    b2, by2 = bound_ms(4096 * int(m3.sum()), _nbytes(s3, t3, m3, i_k, d_k),
                       rates)
    log(f"[kernels] K2 nn1 3 lanes x S=4096 x T=32768: exact (idx, d2; masked "
        f"tail; 1 lane; ragged S, T; ties at split boundaries; "
        f"prepare/query); kernel {ms2:.4f} ms, bound {b2:.4f} ms ({by2}), "
        f"plain {pms2:.4f} ms; single call with layout {call2:.4f} ms")
    results.append(dict(
        name=f"nn1@3x4096x{N}", route="cuda",
        source="lidar_slam_tpu_torch/csrc/knn.cu",
        replaces=knn_cuda.NN1.replaces, max_abs_err=err2,
        ms=ms2, plain_ms=pms2, bound_ms=b2, bound_by=by2, library_ms=None,
        call_ms=call2, shape=f"3x4096x{N}", phase="engine",
    ))
    # the coarse pass of the same verification: 512 sources a lane
    s3c = torch.stack([odometry_source(*cloud(frames[1]), 512)] * 3)
    results.append(k2_row(s3c, t3, m3, "engine", rates,
                          "coarse verification, 3 candidates"))

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
        check(splits * tiles_per >= N // 512 and (splits - 1) * tiles_per < N // 512,
              f"K2 plan at {n_lanes}x{N}x{N} does not cover the target")
        check(splits <= 65535 and n_lanes <= 65535, "K2 grid out of range")
        results.append(k2_row(
            s_big, t_b, m_b, "cli-fidelity", rates,
            "fidelity odometry" if n_lanes == 1 else "full-density verification",
            reps=5, plain_reps=2))
    results += check_lane_kernels(scans, cloud, rates, dev)
    return results


def check_lane_kernels(scans, cloud, rates, dev):
    """The batched engine's shapes: K1 over 4 ICP lanes in one launch (each
    lane against its own target, LUT and scale), exact against the plain
    version and bit-identical, lane by lane, to a one-lane launch; K2 over a
    verification tranche of 4 lanes (12 ICP lanes), 4,096 and 512 sources
    a lane."""
    import torch

    from lidar_slam_tpu_torch.ops import knn_cuda
    from lidar_slam_tpu_torch.ops.normals import estimate_normals_adaptive

    def source(i):
        """Frame i as the odometry ICP's source."""
        return odometry_source(*cloud(i), 4096)

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
        name=f"match_slab@{B}x4096x{N_POINTS}w4096", route="cuda",
        source="lidar_slam_tpu_torch/csrc/knn.cu",
        replaces=knn_cuda.MATCH_SLAB.replaces, max_abs_err=err1, ms=ms1,
        plain_ms=pms1, bound_ms=b1, bound_by=by1, library_ms=None,
        shape=f"{B}x4096x{N_POINTS}w4096", phase="cli-batch",
    )]

    # K2: a tranche of every lane, 3 candidates each against its query
    L = 3 * B
    cands = [cloud(f) for f in range(30, 30 + 30 * L, 30)]
    t12 = torch.stack([c for c, _ in cands])
    m12 = torch.stack([m for _, m in cands])
    s12 = src.repeat_interleave(3, dim=0).contiguous()
    results.append(k2_row(s12, t12, m12, "cli-batch", rates,
                          f"verification tranche of {B} lanes"))
    # the tranche's coarse pass: 512 sources a lane
    s12c = torch.stack([odometry_source(*cloud(i + 1), 512)
                        for i in frames]).repeat_interleave(3, dim=0)
    results.append(k2_row(s12c.contiguous(), t12, m12, "cli-batch", rates,
                          f"coarse verification tranche of {B} lanes"))
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
    for k in kernels():  # count only the main path's launches
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
    launches = {k.name: k.launches for k in kernels()}
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
    # the final graph (its factors and the finalized poses), for [pg-cg]
    graph = eng.state.pg.replace(poses=eng.state.poses.clone())
    return dict(launches=launches, loops=m["loop_count"],
                verify_fired=m["verify_fired"], ate=ate1, spy=shapes,
                graph=graph, gt=gt)


def kernels() -> tuple:
    """The hand-written kernels, whose launches every phase counts: K1 and
    K2 (``csrc/knn.cu``), ``icp_step`` (``csrc/icp_step.cu``) and
    ``knn_topk`` (``csrc/knn_topk.cu``)."""
    from lidar_slam_tpu_torch.ops import icp_cuda, knn_cuda, knn_topk_cuda

    return knn_cuda.KERNELS + icp_cuda.KERNELS + knn_topk_cuda.KERNELS


def launch_shape(name: str, args) -> str:
    """A launch's shape from its C arguments: ``LxSxT`` for K2
    (``lst_nn1(src, soa, lanes, S, T, ...)``, T padded to the tile),
    ``LxSxTwW`` for K1 (``lst_match_slab(src, lanes, S, tgt8, T, ...)``,
    the window ``W`` at argument 10), ``LxN`` (lanes x source rows) for
    ``icp_step`` (``lst_icp_step(&args, stream)``, every mode) and ``LxNkK``
    for ``knn_topk`` (``lst_knn_topk(pts, lanes, N, k, ...)``); the kernel
    rows' ``shape``."""
    if name == "match_slab":
        return f"{args[1]}x{args[2]}x{args[4]}w{args[10]}"
    if name == "knn_topk":
        return f"{args[1]}x{args[2]}k{args[3]}"
    if name == "icp_step":
        a = args[0].contents
        return f"{a.lanes}x{a.rows}"
    return f"{args[2]}x{args[3]}x{args[4]}"


def icp_snapshot(mode, st, cur, mask, match) -> dict:
    """A copy of one ``icp_step`` launch's operands, taken before it runs:
    the state, ``cur``, the mask and the matches (row-aligned matches
    repacked as K1 writes them, 8 floats a row)."""
    import torch

    pts, nrm, idx = match
    if idx is None:
        q = torch.zeros((*pts.shape[:2], 8), dtype=pts.dtype, device=pts.device)
        q[..., 0:3], q[..., 3:6] = pts, nrm
        pts, nrm = q[..., 0:3], q[..., 3:6]
    else:
        pts, nrm, idx = pts.clone(), nrm.clone(), idx.clone()
    return dict(mode=mode, state=clone_state(st), cur=cur.clone(),
                mask=mask.clone(), match=(pts, nrm, idx))


def clone_state(st):
    import dataclasses

    return dataclasses.replace(st, args=None, part=None, **{
        f: getattr(st, f).clone() for f in
        ("T", "err", "ticks", "it", "prev_err", "converged", "hist")
        if getattr(st, f) is not None})


class KernelShapes:
    """Launches of each kernel by its launch shape (``launch_shape``),
    counted while a ``with`` block runs (it wraps the kernels' ``launch``
    and calls the originals): ``shapes["nn1"]["3x4096x32768"]``. It also
    keeps a copy of the first inputs K2 was given at each launch shape
    (``inputs[shape] = (src, tgt, mask)``, lanes first), and of the first
    ``icp_step`` launch other than ``apply`` at each of its shapes
    (``icp_inputs[shape]``, ``icp_snapshot``) and of ``knn_topk``'s first
    inputs at each of its shapes (``topk_inputs[shape] = (pts, mask, k)``),
    so that a shape no kernel row covers yet can be measured on the main
    path's own data (``missing_k2_rows``, ``icp_step_rows``,
    ``knn_topk_rows``)."""

    def __init__(self):
        self.shapes = {k.name: {} for k in kernels()}
        self.inputs = {}
        self.icp_inputs = {}
        self.topk_inputs = {}

    def __enter__(self):
        from lidar_slam_tpu_torch.ops import icp_cuda, knn_cuda, knn_topk_cuda

        self._orig = {k: k.launch for k in kernels()}
        for k in kernels():
            def launch(*args, k=k, orig=k.launch):
                orig(*args)
                key = launch_shape(k.name, args)
                counts = self.shapes[k.name]
                counts[key] = counts.get(key, 0) + 1
            k.launch = launch
        self._prepare = prepare = knn_cuda._nn1_prepare_cuda
        inputs = self.inputs

        def spy_prepare(tgt, mask):
            query = prepare(tgt, mask)

            def spy_query(src):
                T = tgt.shape[-2]
                t, m = tgt.reshape(-1, T, 3), mask.reshape(-1, T)
                s3 = src.reshape(-1, src.shape[-2], 3)
                Tp = -(-T // knn_cuda._NN1_TILE) * knn_cuda._NN1_TILE
                key = f"{t.shape[0]}x{s3.shape[1]}x{Tp}"
                if key not in inputs:
                    inputs[key] = (s3.clone(), t.clone(), m.clone())
                return query(src)

            return spy_query

        knn_cuda._nn1_prepare_cuda = spy_prepare
        self._icp_launch = icp_launch = icp_cuda.launch
        icp_inputs = self.icp_inputs

        def spy_icp_launch(mode, st, cur, src=None, mask=None, match=None):
            key = f"{cur.shape[0]}x{cur.shape[1]}"
            if mode != "apply" and key not in icp_inputs:
                icp_inputs[key] = icp_snapshot(mode, st, cur, mask, match)
            icp_launch(mode, st, cur, src=src, mask=mask, match=match)

        icp_cuda.launch = spy_icp_launch
        self._topk = topk = knn_topk_cuda._knn_topk_cuda
        topk_inputs = self.topk_inputs

        def spy_topk(pts, mask, k):
            N = pts.shape[-2]
            p, m = pts.reshape(-1, N, 3), mask.reshape(-1, N)
            key = f"{p.shape[0]}x{N}k{k}"
            if key not in topk_inputs:
                topk_inputs[key] = (p.clone(), m.clone(), k)
            return topk(pts, mask, k)

        knn_topk_cuda._knn_topk_cuda = spy_topk
        return self

    def __exit__(self, *exc):
        from lidar_slam_tpu_torch.ops import icp_cuda, knn_cuda, knn_topk_cuda

        for k, orig in self._orig.items():
            k.launch = orig
        knn_cuda._nn1_prepare_cuda = self._prepare
        icp_cuda.launch = self._icp_launch
        knn_topk_cuda._knn_topk_cuda = self._topk


class RunSpy(KernelShapes):
    """What a command-line run does not write to its artifacts, recorded
    while it runs in this process: the trajectory just before and after
    ``finalize``, the engine's counters, every optimize-on-find chunk (LM
    iterations and the largest pose move), and each kernel's launches by
    launch shape. It patches the package's functions for the length
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

        def finalize(engine, timing=None):
            spy.before = engine.trajectory()
            res = fin(engine, timing)
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
    for k in kernels():
        k.launches = 0
    with RunSpy() as spy:
        rc = cli.main(argv)
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in kernels()}
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
        f"{launches}, by shape {spy.shapes}; map.ply "
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
    check(set(spy.shapes["nn1"]) == {f"1x{N_POINTS}x{N_POINTS}",
                                     f"3x{N_POINTS}x{N_POINTS}"},
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
    for k in kernels():
        k.launches = 0
    Engine.preload, Engine.finalize = spy_preload, spy_finalize
    try:
        with KernelShapes() as spy:
            rc = cli.main(["run-batch", "--data-dirs", ",".join(dirs),
                           "--out-dir", out_dir, "--mode", "fast", "--resident"])
        torch.cuda.synchronize()
    finally:
        Engine.preload, Engine.finalize = preload, finalize
    launches = {k.name: k.launches for k in kernels()}
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
        f"{launches}, by shape {spy.shapes}")

    # the same prepared scans and configuration through the single engine
    one_launches = {k.name: 0 for k in kernels()}
    t_up = t_dev = 0.0
    one_peak = 0
    with KernelShapes() as one_spy:
        for b in range(B):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            for k in kernels():
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
            for k in kernels():
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
        f"launches {one_launches}, by shape {one_spy.shapes}")
    check(launches["match_slab"] < one_launches["match_slab"],
          f"[cli-batch] K1 launches {launches['match_slab']} batched, "
          f"{one_launches['match_slab']} in the single runs")
    return dict(launches=launches, spy=spy,
                singles=dict(launches=one_launches, spy=one_spy))


# ---------------------------------------------------------------------------
# [rings]: the ring-pattern raycast world (64 beams x 1,024 azimuths)
# ---------------------------------------------------------------------------


def render_rings(seed: int, data: str) -> float:
    """The [rings] route of ``seed`` as ``.bin`` frames with ``poses_gt.txt``
    (``make_rings_dataset``; one random sequence, so one process a seed);
    returns the seconds it took. One BLAS thread: the process renders while
    the host drives the card, and must leave it the cores."""
    for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = "1"
    from lidar_slam_tpu_torch.utils.dataset import make_rings_dataset

    t0 = time.perf_counter()
    make_rings_dataset(data, n_frames=RING_FRAMES, seed=seed,
                       n_beams=RING_BEAMS, n_azimuth=RING_AZIMUTHS, fmt="bin")
    return time.perf_counter() - t0


def start_ring_renders(work):
    """Render the [rings] routes in spawned processes, one a seed, while the
    kernel and engine phases run: ``(pool, futures, dirs)``."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    dirs = [os.path.join(work, f"rings{s}") for s in RING_SEEDS]
    pool = ProcessPoolExecutor(len(RING_SEEDS),
                               mp_context=multiprocessing.get_context("spawn"))
    futures = [pool.submit(render_rings, s, d) for s, d in zip(RING_SEEDS, dirs)]
    return pool, futures, dirs


def prepare_bins(data: str, cap: int) -> list:
    """A [rings] route's scans as the command line prepares them: the
    native loader's 0.5 m voxelizer into at most ``cap`` rows."""
    from lidar_slam_tpu_torch.utils.io import discover_frames
    from lidar_slam_tpu_torch.utils.native import FrameLoader

    paths = [p for _, p in discover_frames(data)]
    with FrameLoader(paths, cap=cap, voxel=VOXEL, raw_cap=RAW_POINTS) as ld:
        return [ld.get(i) for i in range(len(paths))]


def check_ring_kernels(ring_dirs, dev):
    """K2 at the [rings] phases' shapes: the loop verification's 3
    candidates a lane (one lane in [cli-rings-knn] and [rings-engine], two
    in [rings-batch]), 4,096 sources a lane and 512 in the coarse pass,
    against ring scans padded to ``RING_PAD`` rows: exact against the plain
    version, timed, with their bounds. A revisit frame near a route's end
    is the query, three frames near its start the candidates."""
    import numpy as np
    import torch

    from lidar_slam_tpu_torch.utils.io import load_scan
    from lidar_slam_tpu_torch.utils.native import voxel_downsample_host

    rates = card_rates(dev)

    def cloud(data, i):
        v = voxel_downsample_host(
            load_scan(os.path.join(data, f"{i:06d}.bin")), VOXEL, RING_PAD)
        pts = np.zeros((RING_PAD, 3), np.float32)
        pts[: len(v)] = v
        return (torch.from_numpy(pts).to(dev),
                torch.from_numpy(np.arange(RING_PAD) < len(v)).to(dev))

    queries = [cloud(d, RING_FRAMES - 8) for d in ring_dirs]
    cands = [[cloud(d, i) for i in (2, 4, 6)] for d in ring_dirs]
    results = []
    for lanes, phase in ((1, "cli-rings-knn"), (2, "rings-batch")):
        t = torch.stack([c for b in range(lanes) for c, _ in cands[b]])
        m = torch.stack([c for b in range(lanes) for _, c in cands[b]])
        for rows in (4096, 512):
            s = torch.stack([odometry_source(*queries[b], rows)
                             for b in range(lanes) for _ in range(3)])
            results.append(k2_row(
                s, t, m, phase, rates,
                f"verification of {lanes} ring lane{'s' if lanes > 1 else ''}"
                f"{', coarse' if rows == 512 else ''}"))
    return results


def _ring_ate(tag, before, after, gt):
    """ATE before and after finalize; a finalize that makes it worse by more
    than 0.05 m is reported by name (``PERF.md`` attributes it)."""
    from lidar_slam_tpu_torch.utils.metrics import ate_rmse

    a0, a1 = ate_rmse(before, gt), ate_rmse(after, gt)
    worse = a1 > a0 + 0.05
    log(f"[{tag}] ATE {a0:.4f} m before finalize, {a1:.4f} m after"
        + (" (finalize made it WORSE by more than 0.05 m)" if worse else ""))
    return a0, a1


def run_rings(ring_dirs, dev):
    """[cli-rings-knn], [rings-engine] and [rings-batch] on the ring world.

    - [cli-rings-knn]: ``run --mode fast --resident --normal-method knn
      --knn-backend grid`` on route 0: device k-NN normals, grid odometry,
      K2 verification;
    - [rings-engine]: the same prepared scans through ``SlamEngine`` with
      ``knn_backend="slab"``, ``normal_stride=2`` (adaptive normals) and
      ``lc.ring_key_prefilter=64``;
    - [rings-batch]: routes 0 and 1 as two lanes of ``BatchedSlamEngine``
      in [cli-rings-knn]'s configuration, then each lane alone through
      ``SlamEngine``: loops and firing ticks equal, poses within 1e-3 m.

    Every run must close a loop and keep every pose finite; each prints its
    ATE before and after finalize."""
    import dataclasses

    import numpy as np
    import torch

    from lidar_slam_tpu_torch.models import loop_closure as lc
    from lidar_slam_tpu_torch.models import pipeline
    from lidar_slam_tpu_torch.ops import knn_cuda
    from lidar_slam_tpu_torch.parallel import BatchedSlamEngine
    from lidar_slam_tpu_torch.utils.dataset import load_gt_poses

    gts = [load_gt_poses(os.path.join(d, "poses_gt.txt")) for d in ring_dirs]
    out = {}

    # [cli-rings-knn] ------------------------------------------------------
    seen = {}
    preload = pipeline.SlamEngine.preload

    def spy_preload(engine, scans, *a, **kw):
        seen.update(cfg=engine.config, scans=list(scans))
        return preload(engine, scans, *a, **kw)

    pipeline.SlamEngine.preload = spy_preload
    try:
        cli_run = run_cli("cli-rings-knn", [
            "run", "--data-dir", ring_dirs[0], "--out-dir",
            os.path.join(os.path.dirname(ring_dirs[0]), "out_rings"),
            "--mode", "fast", "--resident", "--normal-method", "knn",
            "--knn-backend", "grid",
        ], RING_FRAMES, dev)
    finally:
        pipeline.SlamEngine.preload = preload
    cfg, scans0 = seen["cfg"], seen["scans"]
    spy = cli_run["spy"]
    check((cfg.normal_method, cfg.knn_backend) == ("knn", "grid"),
          f"[cli-rings-knn] ran {cfg.normal_method} / {cfg.knn_backend}")
    check(cli_run["summary"]["loop_count"] >= 1,
          "[cli-rings-knn] no loop closed on the revisit")
    check(cli_run["launches"]["nn1"] > 0 and cli_run["launches"]["match_slab"] == 0,
          f"[cli-rings-knn] expected K2 only: {cli_run['launches']}")
    _ring_ate("cli-rings-knn", spy.before, spy.after, gts[0])
    log(f"[cli-rings-knn] max_points {cfg.max_points} (prepared "
        f"{min(map(len, scans0))}-{max(map(len, scans0))} points), "
        f"verify_fired {spy.metrics['verify_fired']}, mean icp_iters "
        f"{float(np.mean(spy.metrics['icp_iters'][1:])):.3f}")
    out["cli-rings-knn"] = cli_run

    def engine_run(tag, config, scans):
        """One ``SlamEngine`` run with the counts set to 0 just before."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        for k in kernels():
            k.launches = 0
        eng = pipeline.SlamEngine(config, dev)
        eng.preload(scans)
        torch.cuda.synchronize()
        with KernelShapes() as shapes:
            t0 = time.perf_counter()
            eng.run_preloaded()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            odo = eng.trajectory()
            eng.finalize()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
        launches = {k.name: k.launches for k in kernels()}
        traj, m = eng.trajectory(), eng.metrics()
        check(bool(np.isfinite(traj).all()), f"[{tag}] non-finite poses")
        check(m["loop_count"] >= 1, f"[{tag}] no loop closed on the revisit")
        log(f"[{tag}] {len(scans)} frames: run_preloaded {t1 - t0:.3f} s, "
            f"finalize {t2 - t1:.3f} s -> {len(scans) / (t2 - t0):.3f} scans/s; "
            f"peak device memory "
            f"{torch.cuda.max_memory_allocated(dev) / 2**30:.3f} GiB; loops "
            f"{m['loop_count']} {eng.loop_pairs()}, verify_fired "
            f"{m['verify_fired']}, mean icp_iters "
            f"{float(np.mean(m['icp_iters'][1:])):.3f}; launches {launches}, "
            f"by shape {shapes.shapes}")
        return dict(odo=odo, traj=traj, metrics=m, launches=launches,
                    spy=shapes, seconds=t2 - t0)

    # [rings-engine] -------------------------------------------------------
    cfg_e = cfg.replace(
        knn_backend="slab", normal_method="adaptive", normal_stride=2,
        lc=dataclasses.replace(cfg.lc, ring_key_prefilter=RING_PREFILTER))
    calls = [0]
    prefiltered = lc.sc_distances_ring_prefiltered

    def counted(*a, **kw):
        calls[0] += 1
        return prefiltered(*a, **kw)

    lc.sc_distances_ring_prefiltered = counted
    try:
        eng = engine_run("rings-engine", cfg_e, scans0)
    finally:
        lc.sc_distances_ring_prefiltered = prefiltered
    check(calls[0] > 0, "[rings-engine] the ring-key prefilter did not run")
    check(eng["launches"]["nn1"] > 0 and eng["launches"]["match_slab"] == 0,
          f"[rings-engine] expected K2 only: {eng['launches']}")
    log(f"[rings-engine] prefiltered retrievals {calls[0]} (k = "
        f"{RING_PREFILTER})")
    _ring_ate("rings-engine", eng["odo"], eng["traj"], gts[0])
    out["rings-engine"] = eng

    # [rings-batch] --------------------------------------------------------
    scans1 = prepare_bins(ring_dirs[1], cfg.max_points)
    lanes = [scans0, scans1]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    for k in kernels():
        k.launches = 0
    beng = BatchedSlamEngine(cfg, len(lanes), dev,
                             optimize_midrun=cfg.optimize_midrun)
    beng.preload(lanes)
    torch.cuda.synchronize()
    with KernelShapes() as bshapes:
        t0 = time.perf_counter()
        beng.run_preloaded()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        b_odo = beng.trajectories()
        beng.finalize()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    b_launch = {k.name: k.launches for k in kernels()}
    b_traj, b_m = beng.trajectories(), beng.metrics()
    del beng
    check(bool(np.isfinite(b_traj).all()), "[rings-batch] non-finite poses")
    check(b_launch["nn1"] > 0, f"[rings-batch] K2 was not launched: {b_launch}")
    log(f"[rings-batch] {len(lanes)} lanes x {RING_FRAMES} frames: "
        f"run_preloaded {t1 - t0:.3f} s, finalize {t2 - t1:.3f} s -> "
        f"{len(lanes) * RING_FRAMES / (t2 - t0):.3f} scans/s aggregate; peak "
        f"device memory {torch.cuda.max_memory_allocated(dev) / 2**30:.3f} "
        f"GiB; loops {[m['loop_count'] for m in b_m]}, verify_fired "
        f"{[m['verify_fired'] for m in b_m]}; launches {b_launch}, by shape "
        f"{bshapes.shapes}")
    singles = dict(launches={k.name: 0 for k in kernels()})
    with KernelShapes() as one_shapes:
        for b, scans in enumerate(lanes):
            one = engine_run(f"rings-batch lane {b} alone", cfg, scans)
            for name, n in one["launches"].items():
                singles["launches"][name] += n
            diff = float(np.abs(one["traj"] - b_traj[b]).max())
            log(f"[rings-batch] lane {b}: largest pose difference from the "
                f"lane alone {diff:.3e} m")
            _ring_ate(f"rings-batch lane {b}", b_odo[b], b_traj[b], gts[b])
            check(b_m[b]["loop_count"] == one["metrics"]["loop_count"] >= 1,
                  f"[rings-batch] lane {b}: loops {b_m[b]['loop_count']} "
                  f"batched, {one['metrics']['loop_count']} alone")
            check(b_m[b]["verify_fired"] == one["metrics"]["verify_fired"],
                  f"[rings-batch] lane {b}: verify_fired differs from the "
                  "lane alone")
            check(diff <= 1e-3, f"[rings-batch] lane {b}: poses differ by "
                  f"{diff} m from the lane alone")
    singles["spy"] = one_shapes
    out["rings-batch"] = dict(launches=b_launch, spy=bshapes)
    out["rings-batch-singles"] = singles
    return out


def check_modules(ring_dirs, corridor, dev):
    """The plain-torch modules of the [rings] phases on the card, on three
    ring clouds (route 0, frames 0, 60 and 120; ~8,900 points each) and
    one corridor cloud, each padded to 32,768 rows: the exact k-NN against
    the same function on the CPU, the k-NN PCA normals against the host's
    float64 KD-tree normals, the slab and grid searches against K2 (equal
    wherever K2's neighbour lies inside their search), the ring-key
    prefilter's survivors against the CPU's on a 4,608-frame DB; and each
    module's time on the card."""
    import numpy as np
    import torch

    from lidar_slam_tpu_torch.ops import grid_nn, knn_cuda, knn_topk_cuda, slab_nn
    from lidar_slam_tpu_torch.ops import knn as knn_mod
    from lidar_slam_tpu_torch.ops import scan_context as sc
    from lidar_slam_tpu_torch.ops.normals import estimate_normals
    from lidar_slam_tpu_torch.types import PointCloud
    from lidar_slam_tpu_torch.utils.io import load_scan
    from lidar_slam_tpu_torch.utils.native import (
        normals_knn_host,
        voxel_downsample_host,
    )

    N, K = N_POINTS, 20
    frames = (0, RING_FRAMES * 3 // 8, RING_FRAMES * 3 // 4)

    def ring_scan(i):
        raw = load_scan(os.path.join(ring_dirs[0], f"{i:06d}.bin"))
        return voxel_downsample_host(raw, VOXEL, N)

    clouds = [(f"ring{i}", ring_scan(i), ring_scan(i + 1)) for i in frames]
    clouds.append(("corridor", corridor[0], corridor[1]))

    def padded(v, pad=N):
        pts = np.zeros((pad, 3), np.float32)
        pts[: len(v)] = v
        return torch.from_numpy(pts), torch.from_numpy(np.arange(pad) < len(v))

    # the corridor cloud's search first: the 1 x 32,768 launch's kernel row
    # (knn_topk_rows, on the first inputs at a shape) then measures a frame
    # the size of the main path's, not a ring cloud's ~9,000 rows
    knn_topk_cuda.knn_topk(*(x.to(dev) for x in padded(corridor[0])), K)
    res = {}
    for name, tgt_np, src_np in clouds:
        n = len(tgt_np)
        pts, mask = padded(tgt_np)
        pts_d, mask_d = pts.to(dev), mask.to(dev)
        # k-NN: card at the pad against the CPU on the valid rows padded to
        # a multiple of 1,024 (masked targets sit at the sentinel and never
        # enter a top-k; the pad keeps the CPU's chunks wide)
        m = min(-(-n // 1024) * 1024, N)
        i_g, d_g = knn_mod.knn(pts_d, pts_d, mask_d, k=K)
        i_c, d_c = knn_mod.knn(pts[:m], pts[:m], mask[:m], k=K + 1)
        i_g, d_g = i_g[:n].cpu().numpy(), d_g[:n].cpu().numpy()
        i_c, d_c = i_c[:n].numpy(), d_c[:n].numpy()
        differ = np.any(np.sort(i_g, 1) != np.sort(i_c[:, :K], 1), axis=1)
        # a tie at rank K: the K-th and (K+1)-th distances closer than the
        # matrix form's rounding, 1e-5 relative + 16 f32 ulps of the row's
        # |p|^2 (|s|^2 + |t|^2 - 2 s.t cancels to that; the card's and the
        # CPU's matmuls round differently)
        sq = np.sum(tgt_np.astype(np.float64) ** 2, axis=1)
        gap = np.abs(d_c[:, K] - d_c[:, K - 1])
        tie = gap <= 1e-5 * d_c[:, K - 1] + 16 * np.finfo(np.float32).eps * sq
        check(not np.any(differ & ~tie),
              f"[modules] {name}: k-NN sets differ from the CPU's in "
              f"{int(np.sum(differ & ~tie))} rows without a tie at rank {K}")
        # k-NN PCA normals against the host's float64 KD-tree normals
        nrm = estimate_normals(pts_d, mask_d, k=K)[:n].cpu().numpy()
        ang = np.degrees(np.arccos(np.clip(
            np.abs(np.sum(nrm * normals_knn_host(tgt_np, K), axis=1)), 0, 1)))
        check(np.median(ang) < 0.01,
              f"[modules] {name}: k-NN normals' median angle to the host's "
              f"{np.median(ang)} deg")
        # slab and grid against K2 at the odometry ICP's shape
        s_pts, s_mask = padded(src_np)
        s_pts = torch.where(s_mask[:, None], s_pts, torch.full_like(s_pts, 1.0e6))
        src = PointCloud(s_pts, s_mask).subsample(4096).points.to(dev)
        i_k, d_k = knn_cuda.nn1(src, pts_d, mask_d)
        i_s, d_s = slab_nn.nn1_slab(src, pts_d, mask_d)
        _, starts, ts, win, _ = slab_nn.slab_windows(src, pts_d, mask_d)
        st = starts.repeat_interleave(ts)
        in_slab = (i_k.long() >= st) & (i_k.long() < st + win)
        cell = 2.0 * VOXEL
        grid = grid_nn.build_grid(pts_d, mask_d, cell)
        i_r, d_r = grid_nn.nn1_grid(src, grid)
        cand = grid.order.long()[grid_nn.grid_candidates(src, grid).long()]
        in_grid = (cand == i_k.long()[:, None]).any(dim=1)
        torch.cuda.synchronize()
        for tag, idx, d2, inside in (("slab", i_s, d_s, in_slab),
                                     ("grid", i_r, d_r, in_grid)):
            same = (idx == i_k) & (d2 == d_k)
            check(bool(same[inside].all()),
                  f"[modules] {name}: nn1_{tag} differs from K2 in "
                  f"{int((~same & inside).sum())} rows whose neighbour lies "
                  "inside its search")
            res[f"{name}/{tag}_equal_share"] = float(same.float().mean())
            res[f"{name}/{tag}_inside_share"] = float(inside.float().mean())
        res[f"{name}/points"] = n
        res[f"{name}/knn_tie_rows"] = int(np.sum(differ))
        res[f"{name}/knn_rows_within_1e-5"] = int(np.sum(
            differ & (gap <= 1e-5 * d_c[:, K - 1])))
        res[f"{name}/normals_median_deg"] = float(np.median(ang))
        res[f"{name}/normals_max_deg"] = float(ang.max())
        log(f"[modules] {name} ({n} points in {N}): k-NN sets equal to the "
            f"CPU's except {int(np.sum(differ))} rows with a tie at rank {K} "
            f"({res[f'{name}/knn_rows_within_1e-5']} within 1e-5 relative); "
            f"k-NN normals vs host f64: median {np.median(ang):.2e} deg, max "
            f"{ang.max():.2f} deg; equal to K2: slab "
            f"{res[f'{name}/slab_equal_share']:.4f} of rows (inside its "
            f"search {res[f'{name}/slab_inside_share']:.4f}), grid "
            f"{res[f'{name}/grid_equal_share']:.4f} (inside "
            f"{res[f'{name}/grid_inside_share']:.4f})")

    # times on the card ------------------------------------------------------
    ring_pts, ring_mask = (x.to(dev) for x in padded(clouds[0][1], 16384))
    cor_pts, cor_mask = (x.to(dev) for x in padded(clouds[3][1]))
    res["ms/knn_normals@16384"] = time_ms(
        lambda: estimate_normals(ring_pts, ring_mask, k=K), reps=5)
    res["ms/knn_normals@32768"] = time_ms(
        lambda: estimate_normals(cor_pts, cor_mask, k=K), reps=5)
    # the k-NN search over two ring lanes in one launch
    lanes = [padded(clouds[i][1], 16384) for i in (0, 1)]
    two = [torch.stack(x).to(dev) for x in zip(*lanes)]
    res["ms/knn_topk@2x16384"] = time_ms(
        lambda: knn_topk_cuda.knn_topk(*two, K), reps=5)
    s_pts, s_mask = padded(clouds[3][2])
    s_pts = torch.where(s_mask[:, None], s_pts, torch.full_like(s_pts, 1.0e6))
    src = PointCloud(s_pts, s_mask).subsample(4096).points.to(dev)
    grid = grid_nn.build_grid(cor_pts, cor_mask, 2.0 * VOXEL)
    res["ms/nn1_slab@4096x32768"] = time_ms(
        lambda: slab_nn.nn1_slab(src, cor_pts, cor_mask))
    res["ms/nn1_grid@4096x32768"] = time_ms(lambda: grid_nn.nn1_grid(src, grid))
    res["ms/build_grid@32768"] = time_ms(
        lambda: grid_nn.build_grid(cor_pts, cor_mask, 2.0 * VOXEL))
    query = knn_cuda.nn1.prepare(cor_pts[None], cor_mask[None])
    res["ms/K2_call@4096x32768"] = time_ms(lambda: query(src[None]))

    # the ring-key prefilter on a 4,608-frame DB: route 0's descriptors in
    # its first rows, the rest empty (their zero ring keys tie)
    descs = [sc.scan_context(*(x.to(dev) for x in padded(ring_scan(i))))
             for i in range(0, RING_FRAMES, 4)]
    db = torch.zeros((PREFILTER_DB, *descs[0].shape), device=dev)
    db[: len(descs)] = torch.stack(descs)
    norm = torch.sqrt(torch.sum(db * db, dim=(1, 2)))
    q = descs[-1]
    d_g, s_g = sc.sc_distances_ring_prefiltered(q, db, norm, RING_PREFILTER)
    d_c, s_c = sc.sc_distances_ring_prefiltered(q.cpu(), db.cpu(), norm.cpu(),
                                                RING_PREFILTER)
    surv_g, surv_c = torch.isfinite(d_g).cpu(), torch.isfinite(d_c)
    check(torch.equal(surv_g, surv_c) and torch.equal(s_g.cpu(), s_c),
          "[modules] the prefilter's survivors on the card differ from the CPU's")
    res["ms/prefiltered_retrieval@4608"] = time_ms(
        lambda: sc.sc_distances_ring_prefiltered(q, db, norm, RING_PREFILTER))
    res["ms/full_retrieval@4608"] = time_ms(lambda: sc.sc_distances(q, db, norm))
    log(f"[modules] prefilter on a {PREFILTER_DB}-frame DB ({len(descs)} "
        f"descriptors, k = {RING_PREFILTER}): survivors and shifts equal to "
        "the CPU's")
    log("[modules] ms per call on the card: " + ", ".join(
        f"{k[3:]} {v:.4f}" for k, v in res.items() if k.startswith("ms/")))
    print("[modules] " + json.dumps(res), flush=True)
    return res


# ---------------------------------------------------------------------------
# [sharded-search], [sharded-dense], [dryrun], [batch-modes]: the port's
# multi-device code (parallel/) with every shard on this host's cards
# ---------------------------------------------------------------------------


def shard_devices(n: int) -> list:
    """Shard i on ``cuda:(i % card count)``; prints the mapping."""
    import torch

    count = torch.cuda.device_count()
    devs = [f"cuda:{i % count}" for i in range(n)]
    log(f"[mesh] {n} shards on {count} card(s): "
        + ", ".join(f"shard {i} -> {d}" for i, d in enumerate(devs)))
    if count == 1:
        log("[mesh] one card: every shard shares it, so no copy between two "
            "cards was measured")
    return devs


def render_dense():
    """``examples/sharded_dense_pipeline.py``'s scans: its world (ground
    every 0.12 m) and route, the first ``DENSE_FRAMES`` frames rendered at
    ``DENSE_POINTS`` points; with their ground truth."""
    import numpy as np

    from lidar_slam_tpu_torch.utils.dataset import (
        generate_trajectory,
        generate_world,
        render_scan,
        route_half_for,
    )

    half = route_half_for(60)
    world = generate_world(0, route_half=half, ground_step=0.12)
    gt = generate_trajectory(60, half=half)[:DENSE_FRAMES]
    rng = np.random.default_rng(0)
    scans = [render_scan(world, gt[i], rng, max_range=45.0,
                         max_points=DENSE_POINTS) for i in range(DENSE_FRAMES)]
    return scans, gt


def pad_dense(scan, dev):
    """A dense scan x-sorted (the host-voxelized input contract) and
    padded to ``DENSE_POINTS`` rows on the card, with its row count."""
    import numpy as np
    import torch

    s = scan[np.argsort(scan[:, 0], kind="stable")]
    buf = np.zeros((DENSE_POINTS, 3), np.float32)
    n = min(len(s), DENSE_POINTS)
    buf[:n] = s[:n]
    return torch.from_numpy(buf).to(dev), n


def scan_context_db(scans, dev):
    """A ``PREFILTER_DB``-row keyframe DB of Scan Context descriptors: the
    engine route's scans in its first rows, the rest empty (distance 1.0
    to any query)."""
    import numpy as np
    import torch

    from lidar_slam_tpu_torch.ops.scan_context import scan_context

    descs = []
    for s in scans:
        pts = torch.from_numpy(np.ascontiguousarray(s, np.float32)).to(dev)
        descs.append(scan_context(pts, torch.ones(len(s), dtype=torch.bool,
                                                  device=dev)))
    db = torch.zeros((PREFILTER_DB, *descs[0].shape), device=dev)
    db[: len(descs)] = torch.stack(descs)
    return db


def check_sharded_search(dense, corridor, sc_db, devs, dev):
    """[sharded-search]: each sharded search against the unsharded call on
    the same inputs, bit for bit (rtol 0, atol 0), and both calls' ms:

    - ``nn1_target_sharded`` over 4 shards at 1 x 4,096 x 131,072 (a dense
      scan's odometry sample against another's), with equal target rows on
      both sides of each shard boundary: the lower index must win;
    - ``nn1_source_sharded`` at 131,072 x 32,768 over 4 shards;
    - ``sc_topk_sharded`` on a 4,608-frame DB against the unsharded
      stable-sorted top-k, k = 6 and k = 600 (into the empty rows' ties)."""
    import torch

    from lidar_slam_tpu_torch.ops import knn_cuda
    from lidar_slam_tpu_torch.ops import scan_context as sc
    from lidar_slam_tpu_torch.parallel import (
        make_mesh,
        nn1_source_sharded,
        nn1_target_sharded,
        sc_topk_sharded,
    )

    mesh = make_mesh({"pts": SHARDS}, devices=devs)
    out = {}

    def same(got, want, what):
        torch.cuda.synchronize()
        for x, y in zip(got, want):
            check(x.shape == y.shape and x.dtype == y.dtype and torch.equal(x, y),
                  f"[sharded-search] {what} differs from the unsharded call")
        return max(float((x.double() - y.double()).abs().max())
                   for x, y in zip(got, want))

    tgt, n_t = pad_dense(dense[0], dev)
    mask = torch.arange(DENSE_POINTS, device=dev) < n_t
    s_pts, n_s = pad_dense(dense[1], dev)
    src = odometry_source(s_pts, torch.arange(DENSE_POINTS, device=dev) < n_s,
                          4096)
    size = DENSE_POINTS // SHARDS
    bounds = [size * i for i in range(1, SHARDS)]
    for r, b in enumerate(bounds):  # a tie across each shard boundary
        p = torch.tensor([500.0 + r, -500.0, 250.0], device=dev)
        tgt[b - 1] = tgt[b] = p
        mask[b - 1] = mask[b] = True
        src[r] = p
    args = (src[None], tgt[None], mask[None])
    got = nn1_target_sharded(*args, mesh)
    want = knn_cuda.nn1(*args)
    err = same(got, want, "nn1_target_sharded 1x4096x131072")
    same(want, knn_cuda.nn1_torch(*args), "K2 1x4096x131072 (plain)")
    for r, b in enumerate(bounds):
        check(int(got[0][0, r]) == b - 1,
              f"[sharded-search] the tie at shard boundary {b} went to "
              f"{int(got[0][0, r])}")
    out["target"] = dict(
        max_abs_err=err, ms=time_ms(lambda: nn1_target_sharded(*args, mesh)),
        unsharded_ms=time_ms(lambda: knn_cuda.nn1(*args)))

    big = torch.where((torch.arange(DENSE_POINTS, device=dev) < n_s)[:, None],
                      s_pts, torch.full_like(s_pts, 1.0e6))
    t32 = torch.zeros((N_POINTS, 3), device=dev)
    t32[: len(corridor)] = torch.from_numpy(corridor).to(dev)
    m32 = torch.arange(N_POINTS, device=dev) < len(corridor)
    args = (big, t32, m32)
    err = same(nn1_source_sharded(*args, mesh), knn_cuda.nn1(*args),
               "nn1_source_sharded 131072x32768")
    out["source"] = dict(
        max_abs_err=err,
        ms=time_ms(lambda: nn1_source_sharded(*args, mesh), reps=5),
        unsharded_ms=time_ms(lambda: knn_cuda.nn1(*args), reps=5))

    norm = torch.sqrt(torch.sum(sc_db * sc_db, dim=(1, 2)))
    q = sc_db[N_FRAMES - 20]  # a revisit frame
    dist, shift = sc.sc_distances(q, sc_db, norm)
    order = torch.sort(dist, stable=True).indices
    errs = []
    for k in (6, 600):
        want = (dist[order[:k]], order[:k].to(torch.int32),
                shift[order[:k]].to(torch.int32))
        errs.append(same(sc_topk_sharded(q, sc_db, norm, k, mesh), want,
                         f"sc_topk_sharded k={k}"))
    out["sc_topk"] = dict(
        max_abs_err=max(errs), top=order[:6].tolist(),
        ms=time_ms(lambda: sc_topk_sharded(q, sc_db, norm, 6, mesh)),
        unsharded_ms=time_ms(
            lambda: torch.sort(sc.sc_distances(q, sc_db, norm)[0],
                               stable=True).indices[:6]))
    for name, r in out.items():
        log(f"[sharded-search] {name}: equal to the unsharded call "
            f"(max_abs_err {r['max_abs_err']}); {r['ms']:.4f} ms sharded over "
            f"{SHARDS}, {r['unsharded_ms']:.4f} ms unsharded")
    log(f"[sharded-search] retrieval top-6 of frame {N_FRAMES - 20}: "
        f"{out['sc_topk']['top']}")
    return out


def run_sharded_dense(dense, gt, devs, dev):
    """[sharded-dense]: ``examples/sharded_dense_pipeline.py`` at full
    width: its world, route and configuration, 131,072-point dense scans
    through ``pipeline.init_frame``, ``step`` and ``loop_tick`` with
    ``make_sharded_nn1`` over a 4-shard ``pts`` mesh, each run beside the
    same run with unsharded K2 (equal bit for bit).

    With the example's ICP budget of 8 iterations the first step (1.2 m
    from the identity start) does not converge, so every step is rejected
    and ATE is the route's spread: the JAX engine does the same on these
    scans. With the default budget of 50 the run tracks, and it must meet
    the example's check, ATE below 1.0 m; that run is the phase's main
    path (counted), after the example's own as the warm-up."""
    import dataclasses

    import numpy as np
    import torch

    from lidar_slam_tpu_torch.config import ICPConfig, LoopClosureConfig, SlamConfig
    from lidar_slam_tpu_torch.models import pipeline
    from lidar_slam_tpu_torch.ops import knn_cuda
    from lidar_slam_tpu_torch.parallel import make_mesh, make_sharded_nn1
    from lidar_slam_tpu_torch.utils.metrics import ate_rmse

    N = DENSE_POINTS
    example = SlamConfig(
        max_raw_points=N, max_points=N, lc_cloud_points=16384, max_frames=16,
        host_voxelize=True, min_points=1024,
        loop_check_every=DENSE_FRAMES - 1, loop_start_frame=1,
        icp=ICPConfig(max_iterations=8, tolerance=1e-4, sample_points=4096,
                      warm_start=True),
        lc=LoopClosureConfig(frame_gap=2, verify_sample=2048,
                             icp_max_iterations=4),
        normal_window=8192,
    )
    tracking = example.replace(
        icp=dataclasses.replace(example.icp,
                                max_iterations=ICPConfig().max_iterations))
    scans = [pad_dense(s, dev) for s in dense]
    sharded = make_sharded_nn1(make_mesh({"pts": SHARDS}, devices=devs), "pts")

    def drive(cfg, nn1_fn):
        state = pipeline.init_state(cfg, dev)
        pipeline.init_frame(state, cfg, *scans[0])
        torch.cuda.synchronize()
        ms, found = [], 0
        for f in range(1, DENSE_FRAMES):
            t0 = time.perf_counter()
            pipeline.step(state, cfg, *scans[f], f, nn1_fn)
            if f == cfg.loop_check_every and f > cfg.loop_start_frame:
                found += int(pipeline.loop_tick(state, cfg, f).accepted.sum())
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        m = pipeline.state_metrics(state)
        traj = state.poses[: state.n_poses].cpu().numpy().copy()
        return dict(traj=traj, ms=ms, found=found, ate=ate_rmse(traj, gt),
                    iters=m["icp_iters"][1:].tolist(),
                    accepted=int(m["icp_converged"][1:].sum()))

    out = {}
    for tag, cfg in (("example", example), ("tracking", tracking)):
        if tag == "tracking":
            for k in kernels():
                k.launches = 0
        with KernelShapes() as spy:
            run = drive(cfg, sharded)
        launches = {k.name: k.launches for k in kernels()}
        with KernelShapes() as ref_spy:
            ref = drive(cfg, knn_cuda.nn1)
        same = bool(np.array_equal(run["traj"], ref["traj"]))
        log(f"[sharded-dense] {tag} (ICP budget {cfg.icp.max_iterations}): "
            f"{DENSE_FRAMES} frames x {N} points, K2 over {SHARDS} shards "
            f"{np.mean(run['ms']):.1f} ms a frame ({', '.join(f'{x:.1f}' for x in run['ms'])}), "
            f"unsharded K2 {np.mean(ref['ms']):.1f} ms "
            f"({', '.join(f'{x:.1f}' for x in ref['ms'])}); ICP iterations "
            f"{run['iters']}, {run['accepted']} of {DENSE_FRAMES - 1} steps "
            f"converged; ATE {run['ate']:.4f} m; loops accepted {run['found']}; "
            f"trajectory {'bit-identical to' if same else 'DIFFERS from'} the "
            f"unsharded run; K2 launches by shape {spy.shapes['nn1']} "
            f"(unsharded: {ref_spy.shapes['nn1']})")
        check(bool(np.isfinite(run["traj"]).all()),
              f"[sharded-dense] {tag}: non-finite poses")
        check(same, f"[sharded-dense] {tag}: the sharded run differs from the "
              f"unsharded one by {float(np.abs(run['traj'] - ref['traj']).max())}")
        out[tag] = dict(run, launches=launches, spy=spy, ref_ms=ref["ms"])
    check(out["tracking"]["ate"] < 1.0,
          f"[sharded-dense] ATE {out['tracking']['ate']} m, the example "
          "needs < 1.0")
    check(out["tracking"]["launches"]["nn1"] > 0,
          "[sharded-dense] K2 was not launched")
    return out["tracking"]


def run_dryrun(devs):
    """[dryrun]: ``dryrun_multichip(4)`` over the shard devices, at the
    flagship's 131,072 points."""
    import numpy as np

    from lidar_slam_tpu_torch.ops import knn_cuda
    from lidar_slam_tpu_torch.parallel.dryrun import dryrun_multichip

    for k in kernels():
        k.launches = 0
    t0 = time.perf_counter()
    with KernelShapes() as spy:
        out = dryrun_multichip(SHARDS, devices=devs, flagship_points=DENSE_POINTS)
    secs = time.perf_counter() - t0
    launches = {k.name: k.launches for k in kernels()}
    log(f"[dryrun] {secs:.2f} s: mesh {out['mesh']}, lanes {out['batch']}, "
        f"n_poses {out['n_poses']}, retrieval top-1 {out['top1']}, flagship "
        f"{out['flagship_points']} points; launches {launches}, by shape "
        f"{spy.shapes}")
    check(out["top1"] == 3 and np.isfinite(out["flagship_poses"]).all(),
          "[dryrun] the dry run's checks failed")
    check(launches["nn1"] > 0, "[dryrun] K2 was not launched")
    return dict(launches=launches, spy=spy)


def run_batch_mode(tag, mode, dirs, extra, work, devs, dev, keep=None):
    """``run-batch --mode <mode> --resident`` on two lanes, in this process;
    then ``BatchedSlamEngine(mesh=make_mesh({"seq": 2, "pts": 1}))`` on the
    prepared scans the command line handed its engine (the same loops,
    firing ticks and mid-run chunks; poses within 1e-5 m), and each lane
    alone through a batch of 1 (the same loops and firing ticks; poses
    within 1e-3 m, the lane rule). Returns the three runs (launches and
    shapes)."""
    import numpy as np
    import torch

    from lidar_slam_tpu_torch import cli
    from lidar_slam_tpu_torch.ops import knn_cuda
    from lidar_slam_tpu_torch.parallel import batched, make_mesh
    from lidar_slam_tpu_torch.utils.dataset import load_gt_poses
    from lidar_slam_tpu_torch.utils.metrics import ate_rmse

    Engine = batched.BatchedSlamEngine
    preload, finalize, gated = Engine.preload, Engine.finalize, batched.gated_optimize
    seen, chunks = {}, [0]

    def spy_preload(engine, seqs, frame0=0):
        seen.setdefault("engine", engine)
        seen.setdefault("seqs", seqs)
        return preload(engine, seqs, frame0)

    def spy_finalize(engine):
        seen.setdefault("odometry", engine.trajectories())
        return finalize(engine)

    def counted(state, config):
        chunks[0] += sum(bool(p) for p in state.pending_optimize)
        return gated(state, config)

    def reset():
        torch.cuda.synchronize()
        for k in kernels():
            k.launches = 0
        chunks[0] = 0

    def summary(eng, odo, t):
        return dict(pairs=eng.loop_pairs(), metrics=eng.metrics(),
                    traj=eng.trajectories(), odo=odo, seconds=t,
                    chunks=chunks[0],
                    launches={k.name: k.launches for k in kernels()})

    Engine.preload, Engine.finalize = spy_preload, spy_finalize
    batched.gated_optimize = counted
    out_dir = os.path.join(work, f"out_{tag}")
    try:
        reset()
        with KernelShapes() as spy:
            rc = cli.main(["run-batch", "--data-dirs", ",".join(dirs),
                           "--out-dir", out_dir, "--mode", mode, "--resident",
                           *extra])
        Engine.preload, Engine.finalize = preload, finalize
        check(rc == 0, f"[{tag}] the command line returned {rc}")
        with open(os.path.join(out_dir, "metrics.json")) as f:
            m = json.load(f)
        eng, seqs = seen.pop("engine"), seen.pop("seqs")
        cfg = eng.config
        base = summary(eng, seen.pop("odometry"), m["resident"]["device_sec"])
        base["spy"] = spy
        del eng
        check(m["mode"] == mode and all(n >= 1 for n in m["loops"]),
              f"[{tag}] a lane closed no loop: {m['loops']}")

        reset()
        with KernelShapes() as mspy:
            meng = Engine(cfg, len(dirs),
                          mesh=make_mesh({"seq": len(dirs), "pts": 1},
                                         devices=devs[: len(dirs)]),
                          optimize_midrun=cfg.optimize_midrun)
            meng.preload(seqs)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            meng.run_preloaded()
            m_odo = meng.trajectories()
            meng.finalize()
            torch.cuda.synchronize()
            meshed = summary(meng, m_odo, time.perf_counter() - t0)
        meshed["spy"] = mspy
        del meng

        reset()
        singles = []
        with KernelShapes() as sspy:
            for b in range(len(dirs)):
                one = Engine(cfg, 1, dev, optimize_midrun=cfg.optimize_midrun)
                one.preload([seqs[b]])
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                one.run_preloaded()
                o_odo = one.trajectories()
                one.finalize()
                torch.cuda.synchronize()
                singles.append(summary(one, o_odo, time.perf_counter() - t0))
                del one
        s_launch = {k.name: k.launches for k in kernels()}
    finally:
        Engine.preload, Engine.finalize = preload, finalize
        batched.gated_optimize = gated

    gts = [load_gt_poses(os.path.join(d, "poses_gt.txt")) for d in dirs]
    n = m["frames"]
    fired = [x["verify_fired"] for x in base["metrics"]]
    log(f"[{tag}] run-batch --mode {mode}: {len(dirs)} lanes x {n} frames, "
        f"device {m['resident']['device_sec']:.3f} s "
        f"({m['resident']['scans_per_sec_device_aggregate']:.3f} scans/s "
        f"aggregate); loops {m['loops']} {base['pairs']}, verify_fired "
        f"{fired}, mid-run chunks {base['chunks']}; ATE before finalize "
        f"{[round(ate_rmse(t, g), 4) for t, g in zip(base['odo'], gts)]}, "
        f"after {[round(ate_rmse(t, g), 4) for t, g in zip(base['traj'], gts)]}; "
        f"launches {base['launches']}, by shape {spy.shapes}")
    diff = max(float(np.abs(meshed[k] - base[k]).max()) for k in ("odo", "traj"))
    log(f"[{tag}] the same scans over a (seq {len(dirs)}, pts 1) mesh: "
        f"{meshed['seconds']:.3f} s; loops {meshed['pairs']}, mid-run chunks "
        f"{meshed['chunks']}; largest pose difference from run-batch "
        f"{diff:.3e} m; launches {meshed['launches']}, by shape {mspy.shapes}")
    if keep is not None:  # lane 0 for [pg-cg]: its scans, config and result
        one = singles[0]
        keep.update(seq=seqs[0], cfg=cfg, gt=gts[0], loops=one["pairs"][0],
                    verify_fired=one["metrics"][0]["verify_fired"],
                    chunks=one["chunks"], seconds=one["seconds"],
                    ate_odo=ate_rmse(one["odo"][0], gts[0]),
                    ate=ate_rmse(one["traj"][0], gts[0]))
    check(meshed["pairs"] == base["pairs"]
          and [x["verify_fired"] for x in meshed["metrics"]] == fired
          and meshed["chunks"] == base["chunks"],
          f"[{tag}] the meshed engine found other loops, ticks or chunks")
    check(diff <= 1e-5, f"[{tag}] the meshed engine's poses differ by {diff} m")
    for b, one in enumerate(singles):
        d = max(float(np.abs(one[k][0] - base[k][b]).max()) for k in ("odo", "traj"))
        log(f"[{tag}] lane {b} alone (a batch of 1): {one['seconds']:.3f} s; "
            f"loops {one['pairs'][0]}, verify_fired "
            f"{one['metrics'][0]['verify_fired']}; largest pose difference "
            f"from its run-batch lane {d:.3e} m")
        check(one["pairs"][0] == base["pairs"][b]
              and one["metrics"][0]["verify_fired"] == fired[b],
              f"[{tag}] lane {b} alone found other loops or ticks")
        check(d <= 1e-3, f"[{tag}] lane {b} alone differs by {d} m")
    return {tag: dict(launches=base["launches"], spy=spy),
            f"{tag}-mesh": dict(launches=meshed["launches"], spy=mspy),
            f"{tag}-singles": dict(launches=s_launch, spy=sspy)}


def run_pg_cg(lane, engine, dev):
    """[pg-cg]: the pose graph's CG solver on the card. (1) ``SlamEngine``
    in default mode with ``PoseGraphConfig(solver="cg")`` over
    [batch-default]'s lane-0 scans (200 frames, K2 odometry at 32,768^2):
    every optimize-on-find chunk and the finalize (float32 CG chunks, then
    the float64 Woodbury backstop if they do not converge) run the CG step;
    printed beside the Woodbury lane of [batch-default] (a batch of 1).
    Poses finite, a loop closed, ATE after finalize no worse than before +
    0.05 m. (2) ``optimize_chunked`` with ``relative_param=False`` on
    [engine]'s final graph (500 poses at their finalized values, 4,608
    capacity), beside the float64 Woodbury LM on the same graph. (From
    [engine]'s raw chain the absolute chunks do not stall and take minutes
    of host-bound CG products: ``tools/bench_pg_cg.py``.)"""
    import dataclasses

    import numpy as np
    import torch

    from lidar_slam_tpu_torch.config import slice_config
    from lidar_slam_tpu_torch.models import pipeline
    from lidar_slam_tpu_torch.models import pose_graph as pg
    from lidar_slam_tpu_torch.ops import knn_cuda
    from lidar_slam_tpu_torch.utils.metrics import ate_rmse

    cfg = lane["cfg"].replace(pg=dataclasses.replace(lane["cfg"].pg, solver="cg"))
    chunks = []
    orig = pipeline.optimize_on_find

    def spy(state, config):
        t0 = time.perf_counter()
        res = orig(state, config)
        chunks.append((res, time.perf_counter() - t0))
        return res

    eng = pipeline.SlamEngine(cfg, dev)
    eng.preload(lane["seq"])
    torch.cuda.synchronize()
    for k in kernels():
        k.launches = 0
    pipeline.optimize_on_find = spy
    try:
        with KernelShapes() as shapes:
            t0 = time.perf_counter()
            eng.run_preloaded()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            odo = eng.trajectory()
            timing = {}
            res = eng.finalize(timing=timing)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
    finally:
        pipeline.optimize_on_find = orig
    launches = {k.name: k.launches for k in kernels()}
    traj, m, gt = eng.trajectory(), eng.metrics(), lane["gt"]
    ate0, ate1 = ate_rmse(odo, gt), ate_rmse(traj, gt)
    lm = sum(r.iterations for r, _ in chunks)
    mv = sum(r.cg_matvecs for r, _ in chunks)
    log(f"[pg-cg] SlamEngine, default mode, solver cg: {len(odo)} frames, "
        f"run_preloaded {t1 - t0:.3f} s, finalize {t2 - t1:.3f} s; loops "
        f"{eng.loop_pairs()}, verify_fired {m['verify_fired']}, mid-run "
        f"chunks {len(chunks)} ({lm} LM iterations, {mv} CG matvecs, "
        f"{sum(t for _, t in chunks):.3f} s, converged "
        f"{[r.converged for r, _ in chunks]}); ATE {ate0:.4f} m before "
        f"finalize, {ate1:.4f} after; finalize {res.iterations} LM "
        f"iterations, {res.cg_matvecs} CG matvecs, converged {res.converged}, "
        f"error {res.final_error:.6f}; timing "
        + json.dumps({k: round(v, 6) for k, v in timing.items()})
        + f"; launches {launches}, by shape {shapes.shapes}")
    log(f"[pg-cg] beside the Woodbury lane ([batch-default], lane 0 as a batch "
        f"of 1, whose mid-run chunk is gated and over the whole graph): loops "
        f"{lane['loops']}, verify_fired {lane['verify_fired']}, mid-run chunks "
        f"{lane['chunks']}, ATE {lane['ate_odo']:.4f} m before finalize, "
        f"{lane['ate']:.4f} after, {lane['seconds']:.3f} s")
    check(bool(np.isfinite(traj).all()), "[pg-cg] non-finite poses")
    check(m["loop_count"] >= 1, "[pg-cg] no loop closed")
    check(launches["nn1"] > 0, f"[pg-cg] K2 was not launched: {launches}")
    check(mv + res.cg_matvecs > 0, "[pg-cg] the CG solver never ran")
    check(ate1 <= ate0 + 0.05, f"[pg-cg] finalize made ATE worse: {ate0} -> {ate1}")
    del eng

    graph = engine["graph"]
    n = graph.n_poses
    pcfg = slice_config().pg
    t0 = time.perf_counter()
    wood = pg.optimize(pg.compact_loops(graph).to(torch.float64), pcfg)
    t_wood = time.perf_counter() - t0
    acfg = dataclasses.replace(pcfg, relative_param=False)
    tim = {}
    t0 = time.perf_counter()
    res = pg.optimize_chunked(graph, acfg, chunk=acfg.inline_max_iterations,
                              timing=tim)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    poses = res.poses[:n].cpu().numpy()
    log(f"[pg-cg] optimize_chunked, relative_param=False, on [engine]'s final "
        f"graph ({n} poses at their finalized values, {graph.poses.shape[0]} "
        f"capacity, {graph.n_loops} loops): {t1 - t0:.3f} s; float32 chunks "
        f"{tim['f32_it']} LM iterations ({res.cg_matvecs} CG matvecs, "
        f"{tim['f32_s']:.3f} s); backstop "
        + (f"ran, {tim['f64_it']} iterations, {tim['f64_s']:.3f} s"
           if "f64_it" in tim else "did not run")
        + f"; converged {res.converged}, error {res.final_error:.6f}, ATE "
        f"{ate_rmse(poses, engine['gt']):.4f} m; the float64 Woodbury LM on "
        f"the same graph: {wood.iterations} iterations, {t_wood:.3f} s, "
        f"error {wood.final_error:.6f}, ATE {engine['ate']:.4f} m")
    check(bool(np.isfinite(poses).all()), "[pg-cg] optimize_chunked gave "
          "non-finite poses")
    return dict(launches=launches, spy=shapes)


def missing_k2_rows(results, runs, rates) -> list:
    """A K2 row for each launch shape of ``runs`` that no row of ``results``
    measured yet, on the first inputs the main path gave K2 at that shape
    (``KernelShapes.inputs``), counted in the first phase that launched
    it."""
    have = {r["name"] for r in results}
    rows = []
    for tag, run in runs.items():
        for shape in run["spy"].shapes["nn1"]:
            if f"nn1@{shape}" in have:
                continue
            s, t, m = run["spy"].inputs[shape]
            big = s.shape[0] * s.shape[1] * t.shape[1] > 2**31
            rows.append(k2_row(s, t, m, tag, rates, f"{tag}'s own inputs",
                               reps=5 if big else 10, plain_reps=2 if big else 3))
            have.add(f"nn1@{shape}")
    return rows


def icp_step_row(inp, phase, rates, what) -> dict:
    """``icp_step`` at one launch shape, on the operands the main path gave
    it there (``icp_snapshot``): the launch against its plain version
    (``icp_step_torch``) from the same state (T within 1e-5 m and 1e-6 per
    rotation entry, ``it``, ``converged`` and the flags equal, the errors
    within 1e-6 relative), its device time (a CUDA graph of launches; the
    ``apply`` mode's too), the plain version's time, and its bound: the
    bytes a launch needs (each row's point, weight and match once, the
    state) at the memory rate; its ~60 FP32 operations a row are further
    below the card's rate. The JSON row, ``icp_step@LxN``."""
    import torch

    from lidar_slam_tpu_torch.ops import icp_cuda
    from lidar_slam_tpu_torch.ops.icp import icp_step_torch

    mode, cur, mask, match = inp["mode"], inp["cur"], inp["mask"], inp["match"]
    st_k, st_p = clone_state(inp["state"]), clone_state(inp["state"])
    icp_cuda.launch(mode, st_k, cur, mask=mask, match=match)
    icp_step_torch(mode, st_p, cur, mask=mask, match=match)
    torch.cuda.synchronize()
    gap_t = float((st_k.T[:, :3, 3] - st_p.T[:, :3, 3]).abs().max())
    gap_r = float((st_k.T[:, :3, :3] - st_p.T[:, :3, :3]).abs().max())
    check(gap_t <= 1e-5 and gap_r <= 1e-6,
          f"icp_step {mode} ({what}): T differs from the plain version by "
          f"{gap_t:.3e} m, {gap_r:.3e}")

    def rel_gap(a, b):
        # equal entries (a frozen lane's inf, an unused slot's 0) count 0
        return float(torch.where(a == b, 0.0, (a - b).abs() / b.abs()).max())

    rel = 0.0
    if mode == "final":
        rel = rel_gap(st_k.err, st_p.err)
    if mode == "step":
        for name in ("it", "converged", "flags"):
            check(torch.equal(getattr(st_k, name), getattr(st_p, name)),
                  f"icp_step {mode} ({what}): {name} differs from the plain "
                  "version")
        rel = max(rel_gap(st_k.prev_err, st_p.prev_err),
                  rel_gap(st_k.hist, st_p.hist))
    check(rel <= 1e-6, f"icp_step {mode} ({what}): errors differ from the "
          f"plain version by {rel:.3e} relative")
    st_g, st_a = clone_state(inp["state"]), clone_state(inp["state"])
    out = torch.empty_like(cur)
    ms = time_graph_ms(lambda: icp_cuda.launch(mode, st_g, cur, mask=mask,
                                               match=match))
    apply_ms = time_graph_ms(lambda: icp_cuda.launch("apply", st_a, out,
                                                     src=cur))
    st_q = clone_state(inp["state"])
    pms = time_ms(lambda: icp_step_torch(mode, st_q, cur, mask=mask,
                                         match=match), reps=5)
    L, N = cur.shape[0], cur.shape[1]
    pts, nrm, idx = match
    row = 12 + 1 + 24 + (4 if idx is not None else 0)
    b, by = bound_ms(0, L * N * row + _nbytes(inp["state"].T), rates)
    route = "K2 index" if idx is not None else "K1 rows"
    shape = f"{L}x{N}"
    log(f"[kernels] icp_step {shape} ({what}; {mode}, {route}): T within "
        f"{gap_t:.2e} m / {gap_r:.2e} of the plain version, errors within "
        f"{rel:.2e}; kernel {ms:.4f} ms (apply {apply_ms:.4f} ms), bound "
        f"{b:.6f} ms ({by}), plain {pms:.4f} ms")
    return dict(
        name=f"icp_step@{shape}", route="cuda",
        source="lidar_slam_tpu_torch/csrc/icp_step.cu",
        replaces=icp_cuda.ICP_STEP.replaces, max_abs_err=gap_t, ms=ms,
        apply_ms=apply_ms, plain_ms=pms, bound_ms=b, bound_by=by,
        library_ms=None, shape=shape, phase=phase, mode=mode, match=route,
    )


def icp_step_rows(results, runs, rates) -> list:
    """An ``icp_step`` row for each of its launch shapes in ``runs``, on
    the first operands the main path gave it there, counted in the first
    phase that launched it."""
    have = {r["name"] for r in results}
    rows = []
    for tag, run in runs.items():
        for shape, inp in run["spy"].icp_inputs.items():
            if f"icp_step@{shape}" in have:
                continue
            rows.append(icp_step_row(inp, tag, rates, f"{tag}'s own operands"))
            have.add(f"icp_step@{shape}")
    return rows


def ptxas_usage(log: str) -> dict:
    """``{list length K: "N registers, S bytes spill stores, L bytes spill
    loads"}`` of each ``knn_topk_kernel<K>`` in an nvcc ``-Xptxas=-v`` log
    (``knn_topk_cuda.build_log``; where this process loaded a library built
    before, ``csrc/knn_topk.cu`` compiled again into a scratch directory)."""
    import re

    if not log:
        from lidar_slam_tpu_torch.ops import knn_cuda, knn_topk_cuda

        with tempfile.TemporaryDirectory() as tmp:
            r = subprocess.run(
                [knn_cuda._nvcc(), *knn_cuda.NVCC_FLAGS, "-o",
                 os.path.join(tmp, "t.so"), str(knn_topk_cuda.KERNEL_SOURCE)],
                capture_output=True, text=True, timeout=600)
        log = r.stdout + r.stderr
    out, key = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '\w*knn_topk_kernelILi(\d+)E", ln)
        if m:
            key = int(m.group(1))
        elif key is not None and "spill" in ln:
            out.setdefault(key, []).append(ln.split(":", 1)[-1].strip())
        elif key is not None and "registers" in ln:
            out.setdefault(key, []).append(
                re.search(r"Used \d+ registers", ln).group(0))
            key = None
    return {k: ", ".join(v) for k, v in out.items()}


def knn_topk_row(pts, mask, k, phase, rates, what) -> dict:
    """``knn_topk`` at one launch shape, (L, N, 3) points: exact against its
    plain version (indices and distances equal), its time (a CUDA-event
    loop of the whole call: masking and the launch), the plain version's,
    the ATen route that ``knn.knn`` runs (the library yardstick: full-f32
    matmuls, int64 keys, ``torch.topk``), its bound and ptxas's registers
    and spill for its list length. The bound counts the distances this
    input needs: every valid row against every valid row of its lane. The
    JSON row, ``knn_topk@LxNkK``."""
    import torch

    from lidar_slam_tpu_torch.ops import knn, knn_topk_cuda

    got = knn_topk_cuda.knn_topk(pts, mask, k)
    want = knn_topk_cuda.knn_topk_torch(pts, mask, k)
    torch.cuda.synchronize()
    for x, y in zip(got, want):
        check(x.shape == y.shape and torch.equal(x, y),
              f"knn_topk ({what}) differs from the plain version")
    ms = time_ms(lambda: knn_topk_cuda.knn_topk(pts, mask, k), reps=10)
    pms = time_ms(lambda: knn_topk_cuda.knn_topk_torch(pts, mask, k), reps=2)
    lms = time_ms(lambda: knn.knn(pts, pts, mask, k=k), reps=2)
    L, N = pts.shape[0], pts.shape[1]
    valid = mask.sum(dim=1).double()
    b, by = bound_ms(int((valid * valid).sum()), _nbytes(pts, mask, *got), rates)
    K = knn_topk_cuda.list_length(k)
    usage = ptxas_usage(knn_topk_cuda.build_log).get(K, "not in this build's log")
    n_split, tiles_per = knn_topk_cuda.plan(
        L, N, rates["sms"] * knn_topk_cuda._blocks_per_sm(pts.device, k))
    shape = f"{L}x{N}k{k}"
    log(f"[kernels] knn_topk {shape} ({what}; {int(valid.sum())} valid rows): "
        f"exact (idx, d2); plan {n_split} splits x {tiles_per} tiles; kernel "
        f"{ms:.4f} ms, bound {b:.4f} ms ({by}), plain {pms:.4f} ms, knn.knn "
        f"{lms:.4f} ms; ptxas (K = {K}): {usage}")
    return dict(
        name=f"knn_topk@{shape}", route="cuda",
        source="lidar_slam_tpu_torch/csrc/knn_topk.cu",
        replaces=knn_topk_cuda.KNN_TOPK.replaces, max_abs_err=0.0, ms=ms,
        plain_ms=pms, bound_ms=b, bound_by=by, library_ms=lms, ptxas=usage,
        shape=shape, phase=phase,
    )


def knn_topk_rows(results, runs, rates) -> list:
    """A ``knn_topk`` row for each of its launch shapes in ``runs``, on the
    first inputs the path gave it there, counted in the first phase that
    launched it."""
    have = {r["name"] for r in results}
    rows = []
    for tag, run in runs.items():
        for shape, (pts, mask, k) in run["spy"].topk_inputs.items():
            if f"knn_topk@{shape}" in have:
                continue
            rows.append(knn_topk_row(pts, mask, k, tag, rates,
                                     f"{tag}'s own inputs"))
            have.add(f"knn_topk@{shape}")
    return rows


def count_launches(results, runs) -> None:
    """Give each kernel row its launches by phase at the row's launch shape
    (``runs``: phase -> its ``launches`` and ``spy``); ``launches`` is the
    count in the phase whose main path gives the row its shape. Every
    launch of every phase must fall in a row measured at its own shape."""
    rows = {r["name"] for r in results}
    for tag, run in runs.items():
        for name, counts in run["spy"].shapes.items():
            check(sum(counts.values()) == run["launches"][name],
                  f"[{tag}] {name}: launches by shape {counts} do not sum to "
                  f"its {run['launches'][name]} launches")
            missing = sorted(k for k in counts if f"{name}@{k}" not in rows)
            check(not missing, f"[{tag}] launched {name} at shapes that no "
                  f"kernel row measured: {missing}")
    for r in results:
        name = r["name"].partition("@")[0]
        r["launches_by_phase"] = {
            tag: run["spy"].shapes[name].get(r["shape"], 0)
            for tag, run in runs.items()
        }
        r["launches"] = r["launches_by_phase"][r["phase"]]
        check(r["launches"] > 0,
              f"{r['name']} was not launched in the {r['phase']} run")


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
    from lidar_slam_tpu_torch.ops import icp_cuda, knn_cuda, knn_topk_cuda

    dev = torch.device("cuda:0")
    smi = nvidia_smi()
    log(f"[env] torch {torch.__version__} cuda {torch.version.cuda}; device "
        f"{torch.cuda.get_device_name(0)} (count {torch.cuda.device_count()}); "
        f"nvcc: {nvcc_version(knn_cuda._nvcc())}; nvidia-smi: {smi}")

    t0 = time.perf_counter()
    knn_cuda.load_library()
    icp_cuda.load_library()
    knn_topk_cuda.load_library()
    ptxas = [ln.strip() for ln in
             (knn_cuda.build_log + icp_cuda.build_log
              + knn_topk_cuda.build_log).splitlines()
             if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
    log(f"[build] {time.perf_counter() - t0:.2f} s -> {knn_cuda.library_path()}"
        f", {icp_cuda.library_path()}, {knn_topk_cuda.library_path()}"
        + "".join(f"\n  {ln}" for ln in ptxas))

    work = tempfile.mkdtemp(prefix="chip_smoke_")
    ring_pool = fid_pool = None
    try:
        # the [rings] routes render on the host while the card works
        ring_pool, ring_jobs, ring_dirs = start_ring_renders(work)
        fid_dirs = [os.path.join(work, f"fid{b}") for b in range(2)]
        fid_pool = ProcessPoolExecutor(
            2, mp_context=multiprocessing.get_context("spawn"))
        fid_jobs = [fid_pool.submit(render_lane, b, d, FIDB_FRAMES, RAW_POINTS)
                    for b, d in enumerate(fid_dirs)]
        t0 = time.perf_counter()
        scans, gt, raw = prepare_route()
        log(f"[prep] {N_FRAMES} scans rendered and voxelized on the host in "
            f"{time.perf_counter() - t0:.1f} s (set-up, not timed below)")

        results = check_kernels(scans, dev)
        engine = run_engine(scans, gt, dev)
        corridor = (scans[KERNEL_FRAMES[0]], scans[KERNEL_FRAMES[1]])
        sc_db = scan_context_db(scans, dev)
        del scans
        fast = run_cli_fast(raw, gt, engine, work, dev)
        del raw
        fid, resumed = run_cli_fidelity(work, dev)
        batch = run_cli_batch(work, dev)
        t0 = time.perf_counter()
        secs = [f.result() for f in ring_jobs]
        log(f"[prep] [rings] {len(RING_SEEDS)} x {RING_FRAMES} frames of "
            f"{RING_BEAMS} x {RING_AZIMUTHS} rays rendered in "
            f"{', '.join(f'{x:.1f}' for x in secs)} s (one process a seed; "
            f"waited {time.perf_counter() - t0:.1f} s here)")
        results += check_ring_kernels(ring_dirs, dev)
        rings = run_rings(ring_dirs, dev)
        with KernelShapes() as mod_spy:
            check_modules(ring_dirs, corridor, dev)
        modules = dict(spy=mod_spy, launches={
            name: sum(c.values()) for name, c in mod_spy.shapes.items()})

        devs = shard_devices(SHARDS)
        dense, dense_gt = render_dense()
        check_sharded_search(dense, corridor[0], sc_db, devs, dev)
        del sc_db
        sharded = run_sharded_dense(dense, dense_gt, devs, dev)
        del dense
        dry = run_dryrun(devs)
        lane0 = {}
        modes = run_batch_mode(
            "batch-default", "default",
            [os.path.join(work, f"lane{b}") for b in range(2)], [], work,
            devs, dev, keep=lane0)
        modes["pg-cg"] = run_pg_cg(lane0, engine, dev)
        del lane0
        for f in fid_jobs:
            f.result()
        modes.update(run_batch_mode("batch-fidelity", "fidelity", fid_dirs,
                                    ["--no-host-voxelize"], work, devs, dev))
    finally:
        for pool in (ring_pool, fid_pool):
            if pool is not None:
                pool.shutdown(cancel_futures=True)
        shutil.rmtree(work, ignore_errors=True)
    runs = {"engine": engine, "cli-fast": fast, "cli-fidelity": fid,
            "cli-resume": resumed, "cli-batch": batch,
            "cli-batch-singles": batch["singles"],
            **{tag: rings[tag] for tag in ("cli-rings-knn", "rings-engine",
                                           "rings-batch",
                                           "rings-batch-singles")},
            "sharded-dense": sharded, "dryrun": dry, **modes,
            "modules": modules}
    results += missing_k2_rows(results, runs, card_rates(dev))
    results += icp_step_rows(results, runs, card_rates(dev))
    results += knn_topk_rows(results, runs, card_rates(dev))
    count_launches(results, runs)
    print(json.dumps({"kernels": results}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
