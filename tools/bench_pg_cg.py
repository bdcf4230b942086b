#!/usr/bin/env python3
"""The pose graph's CG solver on one NVIDIA GPU, beside the Woodbury LM.

On a drifted synthetic graph (``tools/profile_pose_graph.build_graph``: a
circular route whose last eighth revisits the start, noisy odometry, exact
loops) held at the engine's capacity (4,608 poses, 512 loop slots), it
reports:

- one J^T J + lam I product of ``pose_graph._normal_equations`` (ms a
  call, median) and the linearization that builds it, in the relative and
  the absolute parameterisation, float32;
- one bounded CG chunk, ``optimize(solver="cg", max_iterations=3)`` (the
  optimize-on-find bound), and one bounded float32 Woodbury chunk;
- ``optimize_chunked`` with ``solver="cg"`` and with ``relative_param=False``
  (its stage times and iterations), and the float64 Woodbury LM that the
  default config's finalize runs, each with its final error.

Run from the repository root:

    python3 tools/bench_pg_cg.py [--poses 500] [--loops 12] [--skip chunked_absolute]
        [--out build/profile/pg_cg.json]

Each result is printed as it comes (``--skip`` leaves stages out: from the
raw chain ``chunked_absolute`` runs minutes).

``--cpu`` runs the same on the CPU (at a small ``--poses``/``--capacity``,
to try the script).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def build_state(n: int, n_loops: int, capacity: int, loop_slots: int, dev):
    import numpy as np
    import torch

    from lidar_slam_tpu_torch.models import pose_graph as pg
    from tools.profile_pose_graph import build_graph

    gt, rels, loops = build_graph(n, n_loops, seed=0)
    st = pg.init_state(capacity, loop_slots, dev)
    for k in range(1, n):
        pg.add_odometry(st, k, torch.from_numpy(rels[k].astype(np.float32)).to(dev),
                        torch.tensor(0.0, device=dev))
    for i, j, rel in loops:
        pg.add_loop(st, i, j, torch.from_numpy(rel.astype(np.float32)).to(dev))
    return st, gt


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--poses", type=int, default=500)
    ap.add_argument("--loops", type=int, default=12)
    ap.add_argument("--capacity", type=int, default=4608)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--skip", default="", help="comma-separated stages")
    ap.add_argument("--out", default="build/profile/pg_cg.json")
    args = ap.parse_args()

    import torch

    if not args.cpu and not torch.cuda.is_available():
        print("needs an NVIDIA GPU (or --cpu)", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from lidar_slam_tpu_torch.config import PoseGraphConfig
    from lidar_slam_tpu_torch.models import pose_graph as pg
    from lidar_slam_tpu_torch.utils.metrics import ate_rmse

    dev = torch.device("cpu" if args.cpu else "cuda:0")

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def wall(fn):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        return out, time.perf_counter() - t0

    st, gt = build_state(args.poses, args.loops, args.capacity, 512, dev)
    n = args.poses
    skip = set(filter(None, args.skip.split(",")))
    out = {}

    def put(key, val):
        out[key] = val
        print(json.dumps({key: val}), flush=True)

    if dev.type == "cuda":
        import chip_smoke

        put("card", chip_smoke.nvidia_smi())
    put("setup", dict(poses=n, capacity=args.capacity, loops=st.n_loops,
                      error0=pg.graph_error(st, PoseGraphConfig())))

    def ate(res):
        return ate_rmse(res.poses[:n].float().cpu().numpy(), gt)

    put("ate0", ate(st))
    pg._normal_equations(st, PoseGraphConfig(solver="cg"), 1e-5)  # warm-up
    for name, kw in (("relative", dict(solver="cg")),
                     ("absolute", dict(relative_param=False))):
        cfg = PoseGraphConfig(**kw)
        comp = pg.compact_loops(st)
        (g, matvec), t_lin = wall(lambda: pg._normal_equations(comp, cfg, 1e-5))
        x = torch.randn_like(g)
        matvec(x)
        times = []
        for _ in range(args.reps):
            _, t = wall(lambda: matvec(x))
            times.append(t * 1e3)
        put(name, dict(linearize_ms=t_lin * 1e3,
                       matvec_ms=statistics.median(times)))

    comp = pg.compact_loops(st)
    for name, kw in (("cg_chunk", dict(solver="cg")),
                     ("woodbury_chunk", dict())):
        res, t = wall(lambda: pg.optimize(comp, PoseGraphConfig(**kw),
                                          max_iterations=3))
        put(name, dict(s=t, iterations=res.iterations, matvecs=res.cg_matvecs,
                       error=res.final_error, ate=ate(res)))
    for name, kw in (("chunked_cg", dict(solver="cg")),
                     ("chunked_absolute", dict(relative_param=False))):
        if name in skip:
            continue
        timing = {}
        res, t = wall(lambda: pg.optimize_chunked(
            st, PoseGraphConfig(**kw), chunk=3, timing=timing))
        put(name, dict(s=t, timing=timing, iterations=res.iterations,
                       matvecs=res.cg_matvecs, converged=res.converged,
                       error=res.final_error, ate=ate(res)))
    res, t = wall(lambda: pg.optimize(comp.to(torch.float64), PoseGraphConfig()))
    put("woodbury_f64", dict(s=t, iterations=res.iterations,
                             converged=res.converged, error=res.final_error,
                             ate=ate(res)))
    os.makedirs(os.path.dirname(os.path.join(ROOT, args.out)), exist_ok=True)
    with open(os.path.join(ROOT, args.out), "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
