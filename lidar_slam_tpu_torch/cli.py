"""Command line of the PyTorch port (counterpart of
``lidar_slam_tpu/cli.py``, same subcommands and flags, same artifacts).

Replaces the reference's ROS2 launch + node entry point (slam.launch.py,
slam_node.cpp:341-350). Flags mirror the ROS parameter names
(slam_node.cpp:17-25): data_dir, voxel_size, playback_rate, max_iterations,
tolerance, grid_resolution, height_min, height_max, max_range. Instead of
RViz topics, results are exported as artifacts (trajectory / map.ply /
occupancy / metrics.jsonl).

Subcommands:
  run           full SLAM over a directory of .ply/.bin frames
  run-batch     several sequences at once on one device (BatchedSlamEngine)
  convert       KITTI .bin -> .ply
  make-dataset  generate the synthetic loop dataset

``run`` and ``run-batch`` work on an NVIDIA GPU unless ``--cpu`` is given;
without CUDA and without ``--cpu`` they exit with an error instead of moving
to the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

from .config import MODES

KNN_BACKENDS = ("auto", "pallas", "xla", "slab", "grid", "slab_pallas")
DISPATCH_BLOCK_NOTICE = (
    "--dispatch-block has no effect here: this engine runs every scan, and "
    "every loop tick right after its frame, as one sequence of device "
    "launches")


def _device(cpu: bool, cmd: str):
    """The run's device: the CPU with ``--cpu``, else the card; ``None``
    (after a message) when there is no card."""
    import torch

    if cpu:
        return torch.device("cpu")
    if torch.cuda.is_available():
        return torch.device("cuda")
    print(f"error: CUDA is not available; `{cmd}` works on an NVIDIA GPU "
          "unless --cpu is given", file=sys.stderr)
    return None


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _build_config(args):
    from .config import OccupancyGridConfig, SlamConfig, apply_mode, tiny_config

    base = tiny_config() if args.preset == "tiny" else SlamConfig()
    base = apply_mode(base, args.mode)
    cfg = base.replace(
        voxel_size=args.voxel_size,
        icp=dataclasses.replace(
            base.icp,
            max_iterations=(
                args.max_iterations if args.max_iterations is not None
                else base.icp.max_iterations
            ),
            tolerance=(
                args.tolerance if args.tolerance is not None
                else base.icp.tolerance
            ),
        ),
        grid=OccupancyGridConfig(
            resolution=args.grid_resolution,
            height_min=args.height_min,
            height_max=args.height_max,
            max_range=args.max_range,
            grid_dim=base.grid.grid_dim,
        ),
    )
    if args.max_points:
        # full-size verification clouds unless --lc-points narrows them
        cfg = cfg.replace(max_points=args.max_points, lc_cloud_points=0)
    if args.lc_points:
        cfg = cfg.replace(lc_cloud_points=args.lc_points)
    if args.max_raw_points:
        cfg = cfg.replace(max_raw_points=args.max_raw_points)
    if args.max_frames:
        cfg = cfg.replace(max_frames=args.max_frames)
    if args.knn_backend:
        cfg = cfg.replace(knn_backend=args.knn_backend)
    if args.icp_sample is not None:
        cfg = cfg.replace(
            icp=dataclasses.replace(cfg.icp, sample_points=args.icp_sample)
        )
    if args.warm_start:
        cfg = cfg.replace(icp=dataclasses.replace(cfg.icp, warm_start=True))
    if args.normal_method:
        cfg = cfg.replace(normal_method=args.normal_method)
    if args.probe_stride:
        cfg = cfg.replace(normal_probe_stride=args.probe_stride)
    if args.normal_stride:
        cfg = cfg.replace(normal_stride=args.normal_stride)
    if args.no_midrun_optimize:
        cfg = cfg.replace(optimize_midrun=False)
    return cfg


def _make_loader(cfg, frames, start_frame: int = 0):
    """The readahead loader of a run: voxelizing (and, under
    ``host_normals``, estimating normals) in its workers when the config
    voxelizes on the host, else handing out raw scans."""
    from .utils.native import FrameLoader

    paths = [p for _, p in frames]
    if cfg.host_voxelize:
        return FrameLoader(
            paths, cap=cfg.max_points, window=8, threads=4,
            voxel=cfg.voxel_size, raw_cap=cfg.max_raw_points,
            normals_radius=(
                cfg.effective_normal_radius if cfg.host_normals else 0.0
            ),
            start=start_frame,
        )
    return FrameLoader(paths, cap=cfg.max_raw_points, window=8, threads=2,
                       start=start_frame)


def cmd_run(args) -> int:
    import numpy as np

    from .models.pipeline import SlamEngine
    from .utils import export
    from .utils.io import discover_frames, load_scan

    device = _device(args.cpu, "run")
    if device is None:
        return 2

    def sync():
        _sync(device)

    frames = discover_frames(args.data_dir)
    if not frames:
        print(f"No frames found in {args.data_dir}", file=sys.stderr)
        return 1
    if args.frames:
        frames = frames[: args.frames]

    os.makedirs(args.out_dir, exist_ok=True)
    cfg = _build_config(args)
    if args.dispatch_block is not None:
        print(DISPATCH_BLOCK_NOTICE, file=sys.stderr)
    if not args.resume and (not args.max_frames
                            or cfg.max_frames < len(frames)):
        # right-size the keyframe-DB capacity to the dataset (+ slack): the
        # DB-linear costs (SC retrieval matmul, candidate gathers, finalize
        # occupancy rebuild) and the DB's device memory otherwise pay for
        # empty rows. Not on resume: the checkpoint's arrays pin every
        # capacity, so pass --max-frames (and --max-points) to match it
        cfg = cfg.replace(max_frames=len(frames) + 8)
    if not args.no_host_voxelize:
        # voxelize (and estimate radius normals) in the loader workers, off
        # the device's critical path
        cfg = cfg.replace(host_voxelize=True)
        if cfg.normal_method == "radius":
            cfg = cfg.replace(host_normals=True)
    if not args.max_raw_points:
        # auto-size the raw capacity from the first frame (truncation would
        # spatially bias the scan: the sensor's point order is not shuffled)
        n0 = len(load_scan(frames[0][1]))
        cap = 1 << max(int(np.ceil(np.log2(max(n0, 1024)))), 10)
        if cap != cfg.max_raw_points:
            cfg = cfg.replace(max_raw_points=cap)
    engine = None
    start_frame = 0
    if args.resume:
        # the checkpoint requires an identical config, so auto-sizing from
        # the data is skipped on resume
        engine = SlamEngine(cfg, device, debug_nans=args.debug_nans)
        engine.load_checkpoint(args.resume)
        start_frame = engine.n_frames
        print(f"resumed from {args.resume} at frame {start_frame}")

    def new_engine():
        eng = SlamEngine(cfg, device, debug_nans=args.debug_nans)
        print(
            f"config: voxel={cfg.voxel_size} max_points={cfg.max_points} "
            f"frames={len(frames)} backend={cfg.knn_backend} device={device}"
        )
        return eng

    prof = None
    if args.profile:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.start()
        # profiler clock ns = perf_counter ns + offset (the engine's spans
        # are on perf_counter)
        clock_offset_ns = time.time_ns() - time.perf_counter_ns()

    if args.warmup_run and start_frame:
        print("--warmup-run ignored with --resume (reset would discard "
              "the restored state)", file=sys.stderr)
    warmup = args.warmup_run and not start_frame
    period = 1.0 / args.playback_rate if args.playback_rate > 0 else 0.0
    loader = _make_loader(cfg, frames, start_frame)
    n_run = len(frames) - start_frame
    extra = {}
    t_warm = 0.0
    t_start = time.perf_counter()
    if args.resident:
        # One upfront upload, then no host-to-device transfer per scan. Host
        # prep (load / voxelize / normals) is timed and reported separately;
        # the total wall below includes it.
        for flag, name in (
            (args.checkpoint_every, "--checkpoint-every"),
            (args.export_every, "--export-every"),
            (args.playback_rate, "--playback-rate"),
        ):
            if flag:
                print(
                    f"{name} only applies to the streaming path and is "
                    "ignored with --resident (the resident run processes "
                    "the whole dataset without per-frame host control)",
                    file=sys.stderr,
                )
        t0 = time.perf_counter()
        prepared, prep_normals = [], [] if cfg.host_normals else None
        for i in range(start_frame, len(frames)):
            if cfg.host_normals:
                p, nr = loader.get_with_normals(i)
                prep_normals.append(nr)
            else:
                p = loader.get(i)
            prepared.append(p)
        loader.close()
        t_prep = time.perf_counter() - t0
        print(f"prep: {t_prep:.1f}s", file=sys.stderr, flush=True)
        if engine is None and not args.max_points:
            # right-size the cloud pad to the ACTUAL prepared maximum (next
            # power of two, floor 4096 to keep the slab/normal windows
            # covered): sparse-sensor scans otherwise pay every 1-NN /
            # normals / verify kernel for phantom pad rows
            mx = max(len(p) for p in prepared) if prepared else 1024
            cap = max(4096, 1 << int(np.ceil(np.log2(max(mx, 1)))))
            if cap < cfg.max_points:
                print(f"auto-sized max_points: {cfg.max_points} -> {cap} "
                      f"(max prepared cloud {mx})", file=sys.stderr)
                cfg = cfg.replace(max_points=cap)
        if engine is None:
            engine = new_engine()
        t0 = time.perf_counter()
        engine.preload(prepared, normals=prep_normals, frame0=start_frame)
        sync()
        t_up = time.perf_counter() - t0
        print(f"upload: {t_up:.1f}s", file=sys.stderr, flush=True)
        if warmup:
            # one untimed pass absorbs what a process pays once (the CUDA
            # context, the kernel build, library handles), then the timed
            # pass measures the steady state
            t0 = time.perf_counter()
            engine.run_preloaded()
            engine.finalize()
            sync()
            t_warm = time.perf_counter() - t0
            print(f"warmup run (build/load + run): {t_warm:.1f}s",
                  file=sys.stderr, flush=True)
            engine.reset()
        t0 = time.perf_counter()
        engine.run_preloaded()
        engine.finalize()
        sync()
        t_dev = time.perf_counter() - t0
        print(
            f"resident run: prep {t_prep:.1f}s + upload {t_up:.1f}s + device "
            f"{t_dev:.1f}s ({n_run / t_dev:.1f} scans/s device-side)"
        )
        extra.update(prep_sec=t_prep, upload_sec=t_up, device_sec=t_dev)
    else:
        if engine is None:
            engine = new_engine()
        if warmup:
            # push enough frames to build and load everything the steady
            # state uses (the first step builds the kernels), then reset
            t0 = time.perf_counter()
            wn = min(len(frames), cfg.loop_check_every + 2)
            _push_frames(args, cfg, engine, loader, range(wn))
            sync()
            engine.reset()
            loader.close()  # its prefetch window has been consumed
            loader = _make_loader(cfg, frames)
            t_warm = time.perf_counter() - t0
            print(f"warmup ({wn} frames, build/load): {t_warm:.1f}s",
                  file=sys.stderr, flush=True)
        t0 = time.perf_counter()
        _push_frames(args, cfg, engine, loader, range(start_frame, len(frames)),
                     period=period, live=True, n_total=len(frames))
        loader.close()
        sync()  # split push and finalize honestly
        t_push = time.perf_counter() - t0
        t0 = time.perf_counter()
        engine.finalize()
        sync()
        t_fin = time.perf_counter() - t0
        print(
            f"streaming: push {t_push:.1f}s ({n_run / t_push:.1f} scans/s), "
            f"finalize {t_fin:.1f}s"
        )
        extra.update(push_sec=t_push, finalize_sec=t_fin)
    if prof is not None:
        prof.stop()
        os.makedirs(args.profile, exist_ok=True)
        trace = os.path.join(args.profile, "trace.json")
        prof.export_chrome_trace(trace)
        print(f"profiler trace -> {trace}")
        # the engine traced itself while the profiler ran (utils/tracing.py)
        spans = os.path.join(args.profile, "spans.json")
        with open(spans, "w") as f:
            json.dump(dict(clock_offset_ns=clock_offset_ns,
                           **engine.metrics().get("trace", {})), f)
        print(f"program spans -> {spans}")
    wall = time.perf_counter() - t_start
    wall -= t_warm  # the untimed --warmup-run pass (0.0 without it)
    sps = n_run / wall
    extra.update(scans_per_sec=sps, wall_sec=wall)

    gt = None
    gt_path = os.path.join(args.data_dir, "poses_gt.txt")
    if os.path.exists(gt_path):
        from .utils.dataset import load_gt_poses
        from .utils.metrics import ate_rmse, rpe

        gt = load_gt_poses(gt_path)
        traj = engine.trajectory()
        extra["ate_rmse"] = ate_rmse(traj, gt)
        extra["rpe_trans"], extra["rpe_rot"] = rpe(traj, gt)
        print(f"ATE RMSE: {extra['ate_rmse']:.3f} m")
    export.export_all(args.out_dir, engine, extra, gt=gt)
    print(
        f"done: {len(frames)} scans in {wall:.1f}s ({sps:.1f} scans/s), "
        f"loops={engine.state.loop_count} -> {args.out_dir}"
    )
    return 0


def _push_frames(args, cfg, engine, loader, indices, period: float = 0.0,
                 live: bool = False, n_total: int = 0) -> None:
    """Stream frames ``indices`` through ``engine.push_scan``; with ``live``
    also the per-frame services of the run: ``--checkpoint-every``,
    ``--export-every``, ``--verbose`` and the ``--playback-rate`` throttle."""
    from .utils import export

    for i in indices:
        t0 = time.perf_counter()
        sync_info = live and args.verbose
        if cfg.host_normals:
            pts_i, nrm_i = loader.get_with_normals(i)
            info = engine.push_scan(pts_i, sync_info=sync_info, normals=nrm_i)
        else:
            info = engine.push_scan(loader.get(i), sync_info=sync_info)
        if not live:
            continue
        if args.checkpoint_every and i and i % args.checkpoint_every == 0:
            engine.save_checkpoint(os.path.join(args.out_dir, "checkpoint.npz"))
        if args.export_every and i and i % args.export_every == 0:
            # live observability (slam_node.cpp:154-157 analog); each
            # snapshot copies the map to the host, so keep the cadence coarse
            export.export_snapshot(args.out_dir, engine)
        if info:
            print(f"Loop: {info['query']} <-> {info['matches']}")
        if args.verbose and i % 10 == 0 and i > 0:
            # mirror slam_node.cpp:169-174 cadence (each read syncs the device)
            err = float(engine.state.icp_error[i])
            ms = (time.perf_counter() - t0) * 1e3
            print(
                f"Frame {i}/{n_total - 1}: {ms:.1f}ms, err={err:.2e}, "
                f"loops={engine.state.loop_count}"
            )
        if period:
            dt = time.perf_counter() - t0
            if dt < period:
                time.sleep(period - dt)


def _lane_names(dirs: list) -> list:
    """Per-lane export names from sequence directories; a basename that
    occurs twice is told apart by the lane index (or the two lanes would
    write one trajectory file and one ATE entry)."""
    base = [os.path.basename(os.path.normpath(d)) or f"seq{b}"
            for b, d in enumerate(dirs)]
    return [f"lane{b}_{n}" if base.count(n) > 1 else n
            for b, n in enumerate(base)]


def cmd_run_batch(args) -> int:
    """Several sequences at once (BASELINE.md configuration ladder #4): the
    same modes, host-voxelize prep in loader workers, ``--resident`` with
    ``--warmup-run``, per-lane ATE and trajectories, as ``lidar_slam_tpu
    run-batch``. Lanes are cut to the shortest sequence."""
    import numpy as np

    from .config import SlamConfig, apply_mode
    from .parallel import BatchedSlamEngine
    from .utils import export
    from .utils.io import discover_frames, load_scan
    from .utils.native import FrameLoader

    device = _device(args.cpu, "run-batch")
    if device is None:
        return 2
    dirs = [d for d in args.data_dirs.split(",") if d]
    seqs = [discover_frames(d) for d in dirs]
    if not all(seqs):
        print("empty sequence directory", file=sys.stderr)
        return 1
    n = min(len(s) for s in seqs)
    if args.frames:
        n = min(n, args.frames)

    cfg = apply_mode(SlamConfig(), args.mode)
    cfg = cfg.replace(
        voxel_size=args.voxel_size,
        max_frames=n + 8,  # right-size the DB-linear costs, as `run` does
    )
    if args.max_points:
        cfg = cfg.replace(max_points=args.max_points, lc_cloud_points=0)
    if args.lc_points:
        cfg = cfg.replace(lc_cloud_points=args.lc_points)
    if args.dispatch_block is not None:
        cfg = cfg.replace(dispatch_block=args.dispatch_block)
        print(DISPATCH_BLOCK_NOTICE, file=sys.stderr)
    if not args.no_host_voxelize:
        cfg = cfg.replace(host_voxelize=True)
    if args.max_raw_points:
        cfg = cfg.replace(max_raw_points=args.max_raw_points)
    else:
        n0 = max(len(load_scan(s[0][1])) for s in seqs)
        cap = 1 << max(int(np.ceil(np.log2(max(n0, 1024)))), 10)
        cfg = cfg.replace(max_raw_points=cap)
    if args.warmup_run and not args.resident:
        print("--warmup-run has no effect without --resident (the streaming "
              "batched run has no warm-up pass)", file=sys.stderr)

    loaders = [
        FrameLoader(
            [p for _, p in seq[:n]],
            cap=cfg.max_points if cfg.host_voxelize else cfg.max_raw_points,
            window=8, threads=2,
            voxel=cfg.voxel_size if cfg.host_voxelize else 0.0,
            raw_cap=cfg.max_raw_points,
        )
        for seq in seqs
    ]
    extra = {}
    t_warm = 0.0
    resident_split = None
    t_start = time.perf_counter()
    if args.resident:
        t0 = time.perf_counter()
        prepared = [[ld.get(i) for i in range(n)] for ld in loaders]
        for ld in loaders:
            ld.close()
        t_prep = time.perf_counter() - t0
        print(f"prep: {t_prep:.1f}s", file=sys.stderr, flush=True)
        if not args.max_points:
            # right-size the cloud pad to the prepared maximum (`run`'s
            # auto-sizing, over all lanes)
            mx = max(max(len(p) for p in lane) for lane in prepared)
            cap = max(4096, 1 << int(np.ceil(np.log2(max(mx, 1)))))
            if cap < cfg.max_points:
                print(f"auto-sized max_points: {cfg.max_points} -> {cap}",
                      file=sys.stderr)
                cfg = cfg.replace(max_points=cap)
        eng = BatchedSlamEngine(cfg, len(dirs), device,
                                optimize_midrun=cfg.optimize_midrun)
        t0 = time.perf_counter()
        eng.preload(prepared)
        _sync(device)
        t_up = time.perf_counter() - t0
        print(f"upload: {t_up:.1f}s", file=sys.stderr, flush=True)
        if args.warmup_run:
            t0 = time.perf_counter()
            eng.run_preloaded()
            eng.finalize()
            _sync(device)
            t_warm = time.perf_counter() - t0
            print(f"warmup run (build/load + run): {t_warm:.1f}s",
                  file=sys.stderr, flush=True)
            eng.reset()
        t0 = time.perf_counter()
        eng.run_preloaded()
        eng.finalize()
        _sync(device)
        t_dev = time.perf_counter() - t0
        print(
            f"resident run: prep {t_prep:.1f}s + upload {t_up:.1f}s + device "
            f"{t_dev:.1f}s ({n * len(dirs) / t_dev:.1f} scans/s aggregate "
            "device-side)"
        )
        resident_split = {
            "prep_sec": t_prep, "upload_sec": t_up, "device_sec": t_dev,
            "scans_per_sec_device_aggregate": n * len(dirs) / t_dev,
        }
    else:
        eng = BatchedSlamEngine(cfg, len(dirs), device,
                                optimize_midrun=cfg.optimize_midrun)
        for i in range(n):
            eng.push_scans([ld.get(i) for ld in loaders])
        for ld in loaders:
            ld.close()
        _sync(device)
        t_push = time.perf_counter() - t_start
        t0 = time.perf_counter()
        eng.finalize()
        _sync(device)
        extra.update(push_sec=t_push, finalize_sec=time.perf_counter() - t0)
    wall = time.perf_counter() - t_start - t_warm
    os.makedirs(args.out_dir, exist_ok=True)
    trajs = eng.trajectories()
    total = n * len(dirs)
    metrics = {
        "sequences": len(dirs), "frames": n,
        "wall_sec": wall, "scans_per_sec_aggregate": total / wall,
        "scans_per_sec_per_lane": n / wall,
        "loops": list(eng.state.loop_count),
        "mode": args.mode,
        **extra,
    }
    if resident_split is not None:
        metrics["resident"] = resident_split
    from .utils.dataset import load_gt_poses
    from .utils.metrics import ate_rmse

    lane_names = _lane_names(dirs)
    for b, d in enumerate(dirs):
        name = lane_names[b]
        export.save_trajectory_kitti(
            os.path.join(args.out_dir, f"trajectory_{name}.txt"), trajs[b]
        )
        gt_path = os.path.join(d, "poses_gt.txt")
        if os.path.exists(gt_path):
            gt = load_gt_poses(gt_path)
            m = min(len(gt), len(trajs[b]))
            metrics.setdefault("ate_rmse", {})[name] = float(
                ate_rmse(trajs[b][:m], gt[:m])
            )
    with open(os.path.join(args.out_dir, "metrics.json"), "w") as f:
        json.dump(metrics, f, indent=2)
    if "ate_rmse" in metrics:
        print("ATE RMSE: " + ", ".join(
            f"{k}={v:.3f} m" for k, v in metrics["ate_rmse"].items()
        ))
    print(
        f"done: {len(dirs)} sequences x {n} frames in {wall:.1f}s "
        f"({total / wall:.1f} scans/s aggregate, "
        f"{n / wall:.1f}/lane) -> {args.out_dir}"
    )
    return 0


def cmd_convert(args) -> int:
    from .utils.io import convert_bin_to_ply, convert_directory

    if args.directory:
        n = convert_directory(args.input, args.output)
        print(f"Converted {n} files -> {args.output}")
    else:
        n = convert_bin_to_ply(args.input, args.output)
        print(f"Converted: {args.input} -> {args.output} ({n} points)")
    return 0


def cmd_make_dataset(args) -> int:
    from .utils.dataset import make_dataset

    make_dataset(
        args.out, n_frames=args.frames, seed=args.seed,
        max_points=args.scan_points, fmt=args.format,
    )
    print(f"Wrote {args.frames} frames + poses_gt.txt -> {args.out}")
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="lidar_slam_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    r = sub.add_parser("run", help="run SLAM over a frame directory")
    r.add_argument("--data-dir", required=True)
    r.add_argument("--out-dir", default="slam_out")
    r.add_argument("--voxel-size", type=float, default=0.5)
    r.add_argument("--playback-rate", type=float, default=0.0,
                   help="Hz throttle; 0 = as fast as possible")
    r.add_argument("--max-iterations", type=int, default=None,
                   help="ICP iteration budget (default: mode's)")
    r.add_argument("--tolerance", type=float, default=None,
                   help="ICP |delta-error| tolerance (default: mode's)")
    r.add_argument(
        "--mode", choices=MODES, default="default",
        help="fast = the throughput configuration (warm-started subsampled "
        "ICP, the fused slab-match kernel, deferred optimization); fidelity "
        "= reference-exact runtime settings (50 iters, tol 1e-6, identity "
        "init, full density, exact 1-NN, optimize-on-find). Explicit flags "
        "override the mode.",
    )
    r.add_argument("--grid-resolution", type=float, default=0.2)
    r.add_argument("--height-min", type=float, default=0.3)
    r.add_argument("--height-max", type=float, default=2.0)
    r.add_argument("--max-range", type=float, default=40.0)
    r.add_argument("--frames", type=int, default=0, help="limit frame count")
    r.add_argument("--max-points", type=int, default=0)
    r.add_argument("--lc-points", type=int, default=0,
                   help="loop-closure DB cloud size (0 = same as max-points)")
    r.add_argument("--max-raw-points", type=int, default=0)
    r.add_argument("--max-frames", type=int, default=0)
    r.add_argument(
        "--knn-backend", choices=KNN_BACKENDS, default="",
        help="1-NN search backend: auto, pallas and xla are the exact "
        "brute-force kernel; slab_pallas is the fused slab-match kernel, "
        "exact under the warm-start motion bound; slab (x-slab window) and "
        "grid (sorted cells) are pruned plain-torch searches",
    )
    r.add_argument("--preset", choices=["default", "tiny"], default="default")
    r.add_argument("--dispatch-block", type=int, default=None,
                   help="accepted for compatibility with lidar_slam_tpu; it "
                   "has no effect here and says so")
    r.add_argument("--icp-sample", type=int, default=None,
                   help="ICP source subsample (0 = register every point)")
    r.add_argument("--warm-start", action="store_true",
                   help="seed ICP with the previous accepted delta "
                   "(constant-velocity model) instead of identity")
    r.add_argument("--normal-method",
                   choices=["adaptive", "radius", "knn"], default="",
                   help="normal estimator (see SlamConfig.normal_method)")
    r.add_argument("--probe-stride", type=int, default=0,
                   help="adaptive-normals count-probe stride (>1 replicates "
                   "the smooth radius field; moment PCA stays per-point)")
    r.add_argument("--normal-stride", type=int, default=0,
                   help=">1: normals on every Nth sorted point, replicated")
    r.add_argument("--no-midrun-optimize", action="store_true",
                   help="defer ALL pose-graph optimization to finalize "
                   "(detection- and final-ATE-exact; saves a bounded LM "
                   "chunk per firing tick, see SlamConfig.optimize_midrun)")
    r.add_argument("--resident", action="store_true",
                   help="upload the whole (prepared) dataset to the device "
                   "once and run without per-scan transfers (needs the "
                   "dataset to fit device memory)")
    r.add_argument("--warmup-run", action="store_true",
                   help="run untimed first to absorb what a process pays "
                   "once (CUDA context, kernel build): the whole dataset "
                   "with --resident, a few frames when streaming")
    r.add_argument("--cpu", action="store_true",
                   help="run on the CPU (the default is the GPU, and the "
                   "run fails without one)")
    r.add_argument("--no-host-voxelize", action="store_true",
                   help="voxelize on device instead of in the loader workers")
    r.add_argument("--verbose", action="store_true",
                   help="per-frame stats + loop prints (forces device syncs)")
    r.add_argument("--checkpoint-every", type=int, default=0,
                   help="save out_dir/checkpoint.npz every N frames")
    r.add_argument("--export-every", type=int, default=0,
                   help="dump trajectory/map/occupancy/metrics snapshots "
                   "every N frames (live observability; costs syncs)")
    r.add_argument("--resume", default="",
                   help="resume from a checkpoint.npz (same config required)")
    r.add_argument("--profile", default="",
                   help="write a torch.profiler trace (trace.json) and the "
                   "engine's own spans and counters (spans.json) to this "
                   "directory")
    r.add_argument("--debug-nans", action="store_true",
                   help="check every new pose and ICP error for finiteness "
                   "and stop at the first bad frame (a device sync per frame)")
    r.set_defaults(fn=cmd_run)

    b = sub.add_parser(
        "run-batch", help="run K sequences concurrently (lanes of one engine)"
    )
    b.add_argument("--data-dirs", required=True,
                   help="comma-separated frame directories")
    b.add_argument("--out-dir", default="slam_batch_out")
    b.add_argument("--voxel-size", type=float, default=0.5)
    b.add_argument("--max-points", type=int, default=0,
                   help="cloud pad (0 = auto-size from the data with "
                   "--resident, else the config default)")
    b.add_argument("--lc-points", type=int, default=0,
                   help="loop-closure DB cloud size (0 = same as max-points)")
    b.add_argument("--max-raw-points", type=int, default=0,
                   help="raw scan pad (0 = auto-size from the first frames)")
    b.add_argument("--frames", type=int, default=0)
    b.add_argument(
        "--mode", choices=MODES, default="default",
        help="same presets as `run` (fast = the throughput configuration: "
        "warm-started subsampled ICP, the fused slab-match kernel, deferred "
        "optimization)",
    )
    b.add_argument("--dispatch-block", type=int, default=None,
                   help="accepted for compatibility with lidar_slam_tpu; it "
                   "has no effect here and says so")
    b.add_argument("--resident", action="store_true",
                   help="upload every lane's prepared dataset to the device "
                   "once and run without per-scan transfers")
    b.add_argument("--warmup-run", action="store_true",
                   help="(with --resident) one untimed pass first to absorb "
                   "what a process pays once (CUDA context, kernel build)")
    b.add_argument("--no-host-voxelize", action="store_true",
                   help="voxelize on device instead of in the loader workers")
    b.add_argument("--cpu", action="store_true",
                   help="run on the CPU (the default is the GPU, and the "
                   "run fails without one)")
    b.set_defaults(fn=cmd_run_batch)

    c = sub.add_parser("convert", help="KITTI .bin -> .ply")
    c.add_argument("input")
    c.add_argument("output")
    c.add_argument("-d", "--directory", action="store_true")
    c.set_defaults(fn=cmd_convert)

    m = sub.add_parser("make-dataset", help="generate synthetic loop dataset")
    m.add_argument("--out", required=True)
    m.add_argument("--frames", type=int, default=120)
    m.add_argument("--seed", type=int, default=0)
    m.add_argument("--scan-points", type=int, default=20000)
    m.add_argument("--format", choices=["ply", "bin"], default="ply")
    m.set_defaults(fn=cmd_make_dataset)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
