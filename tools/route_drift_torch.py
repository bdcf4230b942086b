#!/usr/bin/env python3
"""Where the odometry drift of ``chip_smoke.py``'s [cli-batch] routes comes
from, on one NVIDIA GPU.

Renders the lanes of [cli-batch] (lane b: ``generate_world(b, corridor=60)``
on the shared 200-frame route, 65,536 raw points a scan, ``.ply``) and runs
each through the port's command line, ``run --mode fast --resident``, once
per odometry backend (``--knn-backend``): the default ``slab_pallas`` (K1),
``xla`` (K2, the exact brute-force search) and the pruned ``grid`` and
``slab``. For each run it prints:

- ATE before and after finalize, loops and firing ticks;
- each accepted loop's relative pose against the ground truth
  (``inv(gt[match]) @ gt[query]``): translation and rotation error;
- the odometry's per-frame delta error against the ground-truth delta
  (translation, m): its sum, its largest frames, and the ATE of the first
  50, 100 and 150 frames.

Run from the repository root:

    python3 tools/route_drift_torch.py [--lanes 0,2] [--backends slab_pallas,xla,grid,slab] [--out build/route_drift.json]

``--cpu`` runs it on the CPU (slow at full width).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _rot_deg(R) -> float:
    import numpy as np

    c = np.clip((np.trace(R) - 1.0) / 2.0, -1.0, 1.0)
    return float(np.degrees(np.arccos(c)))


def analyse(odo, final, pairs, rels, gt) -> dict:
    """Loop and odometry errors of one run against the ground truth."""
    import numpy as np

    from lidar_slam_tpu_torch.utils.metrics import ate_rmse

    inv = np.linalg.inv
    loops = []
    for (q, m), rel in zip(pairs, rels):
        true = inv(gt[m].astype(np.float64)) @ gt[q].astype(np.float64)
        err = inv(true) @ rel.astype(np.float64)
        loops.append(dict(query=q, match=m,
                          trans_err_m=float(np.linalg.norm(err[:3, 3])),
                          rot_err_deg=_rot_deg(err[:3, :3])))
    d_gt = [inv(gt[i - 1].astype(np.float64)) @ gt[i] for i in range(1, len(gt))]
    d_od = [inv(odo[i - 1].astype(np.float64)) @ odo[i] for i in range(1, len(gt))]
    step = np.array([np.linalg.norm((inv(a) @ b)[:3, 3])
                     for a, b in zip(d_gt, d_od)])
    rot = np.array([_rot_deg((inv(a) @ b)[:3, :3]) for a, b in zip(d_gt, d_od)])
    worst = np.argsort(-step)[:8]
    return dict(
        ate_before=ate_rmse(odo, gt), ate_after=ate_rmse(final, gt),
        ate_prefix={n: ate_rmse(odo[:n], gt[:n]) for n in (50, 100, 150)
                    if n <= len(gt)},
        loops=loops,
        step_err_sum_m=float(step.sum()), step_rot_sum_deg=float(rot.sum()),
        worst_steps=[dict(frame=int(i) + 1, trans_err_m=float(step[i]),
                          rot_err_deg=float(rot[i])) for i in worst],
    )


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--lanes", default="0,2")
    ap.add_argument("--backends", default="slab_pallas,xla,grid,slab")
    ap.add_argument("--frames", type=int, default=200)
    ap.add_argument("--raw-points", type=int, default=65536)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--out", default="build/route_drift.json")
    args = ap.parse_args()

    import numpy as np
    import torch

    if not args.cpu and not torch.cuda.is_available():
        print("needs an NVIDIA GPU (or --cpu)", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke
    from lidar_slam_tpu_torch import cli
    from lidar_slam_tpu_torch.models import pipeline
    from lidar_slam_tpu_torch.ops import knn_cuda
    from lidar_slam_tpu_torch.utils.dataset import load_gt_poses

    print(f"[env] {chip_smoke.nvidia_smi() if not args.cpu else 'cpu'}",
          flush=True)
    seen = {}
    fin = pipeline.SlamEngine.finalize

    def finalize(engine):
        seen["odo"] = engine.trajectory()
        res = fin(engine)
        st = engine.state.pg
        n = st.n_loops
        seen.update(final=engine.trajectory(), pairs=engine.loop_pairs(),
                    rels=st.loop_rel[:n].cpu().numpy().copy(),
                    metrics=engine.metrics())
        return res

    pipeline.SlamEngine.finalize = finalize
    out = {}
    with tempfile.TemporaryDirectory(prefix="route_drift_") as work:
        for b in [int(x) for x in args.lanes.split(",")]:
            data = os.path.join(work, f"lane{b}")
            t0 = time.perf_counter()
            chip_smoke.render_lane(b, data, args.frames, args.raw_points)
            print(f"[prep] lane {b}: {args.frames} frames in "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
            gt = load_gt_poses(os.path.join(data, "poses_gt.txt"))
            for be in args.backends.split(","):
                for k in knn_cuda.KERNELS:
                    k.launches = 0
                argv = ["run", "--data-dir", data, "--out-dir",
                        os.path.join(work, f"out{b}_{be}"), "--mode", "fast",
                        "--resident", "--knn-backend", be]
                argv += ["--cpu"] * args.cpu
                t0 = time.perf_counter()
                rc = cli.main(argv)
                wall = time.perf_counter() - t0
                if rc != 0:
                    raise SystemExit(f"lane {b} {be}: run returned {rc}")
                r = analyse(seen["odo"], seen["final"], seen["pairs"],
                            seen["rels"], gt)
                m = seen["metrics"]
                r.update(verify_fired=m["verify_fired"],
                         mean_icp_iters=float(np.mean(m["icp_iters"][1:])),
                         launches={k.name: k.launches for k in knn_cuda.KERNELS},
                         wall_s=wall)
                out[f"lane{b}/{be}"] = r
                print(f"[lane {b} {be}] ATE {r['ate_before']:.4f} -> "
                      f"{r['ate_after']:.4f} m (first 50/100/150 frames "
                      f"{[round(v, 3) for v in r['ate_prefix'].values()]}); "
                      f"loops {[(x['query'], x['match'], round(x['trans_err_m'], 3), round(x['rot_err_deg'], 2)) for x in r['loops']]} "
                      f"(query, match, m, deg); verify_fired "
                      f"{r['verify_fired']}; odometry step error sum "
                      f"{r['step_err_sum_m']:.3f} m, {r['step_rot_sum_deg']:.2f} "
                      f"deg; worst {[(w['frame'], round(w['trans_err_m'], 3)) for w in r['worst_steps'][:5]]}; "
                      f"mean icp_iters {r['mean_icp_iters']:.2f}; launches "
                      f"{r['launches']}; {wall:.1f} s", flush=True)
    pipeline.SlamEngine.finalize = fin
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
