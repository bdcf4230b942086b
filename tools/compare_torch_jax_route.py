#!/usr/bin/env python3
"""Frame by frame, where the port's engine and the JAX engine part on one
of ``chip_smoke.py``'s routes, on the CPU.

``--route cli-batch`` (default): lane ``--lane`` of [cli-batch]
(``generate_world(lane, corridor=60)`` on the shared 200-frame route,
65,536 raw points a scan), prepared as ``run-batch`` does (the native
loader's 0.5 m voxelizer into 32,768-row clouds), fast mode with the
default ``slab_pallas`` odometry: the JAX engine runs its K1 in Pallas
interpret mode, the port K1's plain version.

``--route rings``: route ``--lane`` of [rings] (``make_rings_dataset``,
64 beams x 1,024 azimuths, 160 frames), prepared into the 16,384-row clouds
the command line sizes for it, fast mode with the options given
(``--knn-backend``, ``--normal-method``, ``--normal-stride``,
``--ring-key-prefilter``; [rings-engine] is ``--knn-backend slab
--normal-stride 2 --ring-key-prefilter 64``).

The same prepared scans go through both engines at full width. After every
frame it prints the gap between the two poses (translation m, rotation
deg), each engine's ICP iterations and the distance of each pose from the
ground truth (taken relative to frame 0, where both engines start at the
identity); at the end the loops of both and each engine's ATE before and
after finalize, its end-of-run state finalized by itself and, through a
checkpoint, by the other engine.

Not part of the tests (seconds a frame pair at full width). Run from the
repository root, where JAX is installed:

    python3 tools/compare_torch_jax_route.py [--route cli-batch|rings] [--lane 0] [--frames 40] [--out build/compare_route.json]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _rot_deg(R) -> float:
    import numpy as np

    return float(np.degrees(np.arccos(np.clip((np.trace(R) - 1) / 2, -1, 1))))


def _pairs(jeng) -> list:
    """The JAX engine's accepted (query, match) pairs."""
    import numpy as np

    g = jeng.state.pg
    n = int(g.n_loops)
    return list(zip(np.asarray(g.loop_to[:n]).tolist(),
                    np.asarray(g.loop_from[:n]).tolist()))


def port_config(jcfg):
    """The port's config with the field values of a JAX ``SlamConfig``."""
    from lidar_slam_tpu_torch import config

    subs = {"icp": config.ICPConfig, "sc": config.ScanContextConfig,
            "lc": config.LoopClosureConfig, "pg": config.PoseGraphConfig,
            "grid": config.OccupancyGridConfig}
    kw = {}
    for f in dataclasses.fields(jcfg):
        v = getattr(jcfg, f.name)
        kw[f.name] = subs[f.name](**dataclasses.asdict(v)) if f.name in subs else v
    return config.SlamConfig(**kw)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--route", choices=["cli-batch", "rings"],
                    default="cli-batch")
    ap.add_argument("--lane", type=int, default=0)
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--raw-points", type=int, default=65536)
    ap.add_argument("--knn-backend", default="slab_pallas")
    ap.add_argument("--normal-method", default="adaptive")
    ap.add_argument("--normal-stride", type=int, default=1)
    ap.add_argument("--ring-key-prefilter", type=int, default=0)
    ap.add_argument("--threads", type=int, default=4)
    ap.add_argument("--out", default="build/compare_route.json")
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    import numpy as np
    import torch

    torch.set_num_threads(args.threads)
    sys.path.insert(0, ROOT)
    import chip_smoke
    from lidar_slam_tpu import config as jconfig
    from lidar_slam_tpu.cli import _apply_mode
    from lidar_slam_tpu.models.pipeline import SlamEngine as JSlamEngine
    from lidar_slam_tpu_torch.models.pipeline import SlamEngine
    from lidar_slam_tpu_torch.utils.dataset import load_gt_poses
    from lidar_slam_tpu_torch.utils.io import discover_frames
    from lidar_slam_tpu_torch.utils.metrics import ate_rmse
    from lidar_slam_tpu_torch.utils.native import FrameLoader

    rings = args.route == "rings"
    n_route = chip_smoke.RING_FRAMES if rings else chip_smoke.BATCH_FRAMES
    pad = 16384 if rings else chip_smoke.N_POINTS
    with tempfile.TemporaryDirectory(prefix="compare_route_") as work:
        data = os.path.join(work, f"lane{args.lane}")
        if rings:
            chip_smoke.render_rings(args.lane, data)
        else:
            chip_smoke.render_lane(args.lane, data, n_route, args.raw_points)
        gt = load_gt_poses(os.path.join(data, "poses_gt.txt")).astype(np.float64)
        paths = [p for _, p in discover_frames(data)][: args.frames]
        with FrameLoader(paths, cap=pad, voxel=chip_smoke.VOXEL,
                         raw_cap=args.raw_points) as ld:
            scans = [ld.get(i) for i in range(len(paths))]
    gt_world = gt[: len(scans)]
    gt = np.linalg.inv(gt[0]) @ gt  # the engines start at the identity
    print(f"[prep] {args.route} {args.lane}: {len(scans)} prepared scans, "
          f"{min(map(len, scans))}-{max(map(len, scans))} points", flush=True)

    jcfg = _apply_mode(jconfig.SlamConfig(), "fast").replace(
        voxel_size=chip_smoke.VOXEL, max_frames=n_route + 8,
        host_voxelize=True, max_raw_points=args.raw_points,
        max_points=pad, dispatch_block=0, knn_backend=args.knn_backend,
        normal_method=args.normal_method, normal_stride=args.normal_stride)
    jcfg = jcfg.replace(lc=dataclasses.replace(
        jcfg.lc, ring_key_prefilter=args.ring_key_prefilter))
    jeng = JSlamEngine(jcfg)
    peng = SlamEngine(port_config(jcfg), "cpu")
    rows = []
    for f, s in enumerate(scans):
        t0 = time.perf_counter()
        jeng.push_scan(s)
        t1 = time.perf_counter()
        peng.push_scan(s)
        t2 = time.perf_counter()
        pj = np.asarray(jeng.trajectory()[f], np.float64)
        pp = np.asarray(peng.trajectory()[f], np.float64)
        gap = np.linalg.inv(pj) @ pp
        it_j = int(jeng.metrics()["icp_iters"][f])
        it_p = int(peng.metrics()["icp_iters"][f])
        row = dict(frame=f, gap_m=float(np.linalg.norm(gap[:3, 3])),
                   gap_deg=_rot_deg(gap[:3, :3]), iters_jax=it_j,
                   iters_port=it_p,
                   jax_gt_m=float(np.linalg.norm(pj[:3, 3] - gt[f, :3, 3])),
                   port_gt_m=float(np.linalg.norm(pp[:3, 3] - gt[f, :3, 3])),
                   jax_s=t1 - t0, port_s=t2 - t1)
        rows.append(row)
        print(f"[frame {f}] gap {row['gap_m']:.3e} m {row['gap_deg']:.3e} deg; "
              f"icp iters jax {it_j} port {it_p}; from gt: jax "
              f"{row['jax_gt_m']:.4f} m, port {row['port_gt_m']:.4f} m; "
              f"{t1 - t0:.1f} s + {t2 - t1:.1f} s", flush=True)
    res = dict(route=args.route, lane=args.lane, frames=len(scans), rows=rows,
               loops_jax=jeng.metrics()["loop_count"],
               loops_port=peng.metrics()["loop_count"])
    print(f"[loops] jax {res['loops_jax']} {_pairs(jeng)}, port "
          f"{res['loops_port']} {peng.loop_pairs()}; largest gap "
          f"{max(r['gap_m'] for r in rows):.3e} m", flush=True)
    # each engine's end-of-run state, finalized by itself and by the other
    # engine (through a checkpoint, which either package loads): does the
    # finalize or the state decide ATE after finalize?
    with tempfile.TemporaryDirectory(prefix="compare_ckpt_") as ck:
        for name, eng in (("jax", jeng), ("port", peng)):
            eng.save_checkpoint(os.path.join(ck, f"{name}.npz"))
        for name, eng in (("jax", jeng), ("port", peng)):
            odo = np.asarray(eng.trajectory())
            eng.finalize()
            fin = np.asarray(eng.trajectory())
            other = (SlamEngine(port_config(jcfg), "cpu") if name == "jax"
                     else JSlamEngine(jcfg))
            other.load_checkpoint(os.path.join(ck, f"{name}.npz"))
            other.finalize()
            cross = ate_rmse(np.asarray(other.trajectory()), gt_world)
            res[f"ate_{name}"] = [ate_rmse(odo, gt_world),
                                  ate_rmse(fin, gt_world), cross]
            print(f"[ate] {name} state: {res[f'ate_{name}'][0]:.4f} m before "
                  f"finalize, {res[f'ate_{name}'][1]:.4f} m after its own "
                  f"finalize, {cross:.4f} m after the "
                  f"{'port' if name == 'jax' else 'JAX'} engine's", flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(res, fh, indent=1)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
