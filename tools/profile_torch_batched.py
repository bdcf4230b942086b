#!/usr/bin/env python3
"""Where the time of the batched engine goes, on one NVIDIA GPU.

Runs ``chip_smoke.py``'s [cli-batch] configuration through
``BatchedSlamEngine`` directly: 4 lanes x 200 frames, lane b through world
b on one shared route with a revisit, rendered at 65,536 raw points and
voxelized on the host, fast mode at full width (32,768-point clouds, 8192^2
grids, a 208-frame DB a lane). It reports:

- per-stage wall time of ``preload -> run_preloaded -> finalize``, each
  stage bracketed by ``torch.cuda.synchronize`` (the odometry ICP over the
  lanes, the normals loop, occupancy, the DB write, loop ticks split firing
  / idle, finalize) and, for comparison, the same stages of the single
  engine on lane 0;
- a ``torch.profiler`` window over frames 100-140 of the batched run without
  the stage timers: device time by kernel and the device's busy share;
- where a lane of the batch parts from the lane alone: each float operation
  of one odometry ICP iteration on 4 lanes against the same operation on
  one lane (the single engine's ICP), as the largest difference.

Run from the repository root on a machine with a card:

    python3 tools/profile_torch_batched.py [--out build/profile/profile_batched.json]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from collections import defaultdict

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="build/profile/profile_batched.json")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke
    from lidar_slam_tpu_torch.config import SlamConfig, apply_mode
    from lidar_slam_tpu_torch.models import loop_closure as lc
    from lidar_slam_tpu_torch.models import pipeline
    from lidar_slam_tpu_torch.ops import knn_cuda
    from lidar_slam_tpu_torch.parallel import batched
    from lidar_slam_tpu_torch.utils.io import discover_frames, load_scan
    from lidar_slam_tpu_torch.utils.native import voxel_downsample_host

    dev = torch.device("cuda:0")
    knn_cuda.LIBRARY.load()
    B, n = chip_smoke.BATCH_LANES, chip_smoke.BATCH_FRAMES
    with tempfile.TemporaryDirectory() as work:
        seqs = []
        for b in range(B):
            d = os.path.join(work, f"lane{b}")
            chip_smoke.render_lane(b, d, n, chip_smoke.RAW_POINTS)
            seqs.append([voxel_downsample_host(load_scan(p), chip_smoke.VOXEL,
                                               chip_smoke.N_POINTS)
                         for _, p in discover_frames(d)])
    # the configuration `run-batch --mode fast --resident` gives these data
    cfg = apply_mode(SlamConfig(), "fast").replace(
        max_frames=n + 8, host_voxelize=True,
        max_raw_points=chip_smoke.RAW_POINTS)

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

    def tick(orig):
        def wrapper(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            det = orig(*a, **kw)
            torch.cuda.synchronize()
            dets = det if isinstance(det, list) else [det]
            fired = any(bool(torch.isfinite(d.sc_distance).any()) for d in dets)
            key = "loop_tick_firing" if fired else "loop_tick_idle"
            stage_s[key] += time.perf_counter() - t0
            stage_n[key] += 1
            return det
        return wrapper

    patches = [
        (batched, "icp_point_to_plane", "icp"), (batched, "_normals", "normals"),
        (batched, "update_occupancy", "occupancy"),
        (lc, "add_frame_lanes", "db_write"),
        (pipeline, "icp_point_to_plane", "icp"),
        (pipeline, "update_occupancy", "occupancy"),
        (lc, "add_frame", "db_write"),
    ]
    originals = [(m, a, getattr(m, a)) for m, a, _ in patches]
    originals += [(batched, "loop_tick_lanes", batched.loop_tick_lanes),
                  (pipeline, "loop_tick", pipeline.loop_tick),
                  (pipeline, "normals_fn", pipeline.normals_fn)]

    def restore():
        for m, a, f in originals:
            setattr(m, a, f)

    def run(make, label):
        """Stage times of one engine run, with the timers in place."""
        stage_s.clear()
        stage_n.clear()
        for m, a, name in patches:
            setattr(m, a, timed(name, getattr(m, a)))
        batched.loop_tick_lanes = tick(batched.loop_tick_lanes)
        pipeline.loop_tick = tick(pipeline.loop_tick)
        orig_nf = pipeline.normals_fn
        if label == "single":
            pipeline.normals_fn = lambda c: timed("normals", orig_nf(c))
        eng = make()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.run_preloaded()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        restore()  # finalize is one stage
        eng.finalize()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        stages = {k: {"s": stage_s[k], "calls": stage_n[k]} for k in stage_s}
        stages["finalize"] = {"s": t2 - t1, "calls": 1}
        accounted = sum(v["s"] for k, v in stages.items() if k != "finalize")
        stages["other_host"] = {"s": (t1 - t0) - accounted, "calls": n}
        return {"run_preloaded_s": t1 - t0, "finalize_s": t2 - t1,
                "stages": stages}

    def batched_engine():
        eng = batched.BatchedSlamEngine(cfg, B, dev, optimize_midrun=False)
        eng.preload(seqs)
        return eng

    def single_engine():
        eng = pipeline.SlamEngine(cfg, dev)
        eng.preload(seqs[0])
        return eng

    out = {"device": torch.cuda.get_device_name(0),
           "nvidia_smi": chip_smoke.nvidia_smi(), "lanes": B, "frames": n,
           "batched": run(batched_engine, "batched"),
           "single_lane0": run(single_engine, "single")}

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    a, b = n // 2, min(n, n // 2 + 40)
    eng = batched.BatchedSlamEngine(cfg, B, dev, optimize_midrun=False)
    eng.preload([s[:a] for s in seqs])
    eng.run_preloaded()
    eng.preload([s[a:b] for s in seqs], frame0=a)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        w0 = time.perf_counter()
        eng.run_preloaded()
        torch.cuda.synchronize()
        wall = time.perf_counter() - w0
    rows, dev_total = [], 0.0
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        d = getattr(e, "self_device_time_total", 0.0) or 0.0
        if d > 0:
            rows.append((e.key, d / 1e3, e.count))
            dev_total += d / 1e3
    rows.sort(key=lambda r: -r[1])
    out["window"] = {"frames": [a, b], "wall_ms": wall * 1e3,
                     "device_busy_ms": dev_total,
                     "device_busy_share": dev_total / (wall * 1e3),
                     "top_device_ms": [{"name": k[:120], "ms": ms, "count": c}
                                       for k, ms, c in rows[:15]]}

    out["lane_vs_alone"] = lane_vs_alone(B, cfg.icp.sample_points, dev)

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({k: out[k] for k in ("device", "nvidia_smi", "lanes",
                                          "frames")}))
    for label in ("batched", "single_lane0"):
        r = out[label]
        scans = n * (B if label == "batched" else 1)
        print(f"{label}: run_preloaded {r['run_preloaded_s']:.3f} s, finalize "
              f"{r['finalize_s']:.3f} s -> "
              f"{scans / (r['run_preloaded_s'] + r['finalize_s']):.3f} scans/s")
        for k, v in sorted(r["stages"].items(), key=lambda kv: -kv[1]["s"]):
            print(f"  stage {k:18s} {v['s']:9.3f} s  calls {v['calls']}")
    print("a lane of the batch against the same lane alone (max abs diff):")
    for k, v in out["lane_vs_alone"].items():
        print(f"   {k:34s} {v:.3e}")
    w = out["window"]
    print(f"batched window frames {w['frames']}: wall {w['wall_ms']:.1f} ms, "
          f"device busy {w['device_busy_ms']:.1f} ms "
          f"({100 * w['device_busy_share']:.1f}%)")
    for r in w["top_device_ms"][:10]:
        print(f"   {r['ms']:9.2f} ms  x{r['count']:6d}  {r['name']}")
    return 0


def lane_vs_alone(B: int, S: int, dev) -> dict:
    """Where a lane of the batched odometry ICP parts from the single
    engine's (which runs the same ICP with one lane): each float operation
    of one ICP iteration on B lanes of seeded points against the same
    operation on each lane alone; the largest difference over the lanes."""
    import torch

    from lidar_slam_tpu_torch.ops import se3
    from lidar_slam_tpu_torch.ops.icp import _plane_error, solve_point_to_plane

    g = torch.Generator().manual_seed(0)
    src = (torch.randn(B, S, 3, generator=g) * 20).to(dev)
    tgt = src + (torch.randn(B, S, 3, generator=g) * 0.05).to(dev)
    nrm = torch.nn.functional.normalize(torch.randn(B, S, 3, generator=g),
                                        dim=-1).to(dev)
    mask = (torch.rand(B, S, generator=g) > 0.05).to(dev)
    T = se3.from_rt(se3.exp_so3((torch.randn(B, 3, generator=g) * 0.02).to(dev)),
                    (torch.randn(B, 3, generator=g) * 0.5).to(dev))

    def pieces(T, s, t, n, m):
        w = m.to(s.dtype)
        cur = se3.apply(T, s)
        J = torch.cat([torch.linalg.cross(cur, n, dim=-1), n], dim=-1)
        r = torch.sum((t - cur) * n, dim=-1)
        Jw = (J * w[..., None]).transpose(-1, -2)
        denom = torch.clamp(torch.sum(w, dim=-1), min=1.0)
        return {
            "se3.apply (transform the source)": cur,
            "matmul J^T J (sum over rows)": torch.matmul(Jw, J),
            "matmul J^T r (sum over rows)": torch.matmul(Jw, r[..., None]),
            "plane error (sum over rows)": _plane_error(cur, t, n, w, denom),
            "solve_point_to_plane (delta)": solve_point_to_plane(cur, t, n, m),
        }

    batch = pieces(T, src, tgt, nrm, mask)
    worst = dict.fromkeys(batch, 0.0)
    for b in range(B):
        one = pieces(*(x[b : b + 1] for x in (T, src, tgt, nrm, mask)))
        for k in batch:
            worst[k] = max(worst[k], float((batch[k][b] - one[k][0]).abs().max()))
    return worst


if __name__ == "__main__":
    sys.exit(main())
