#!/usr/bin/env python3
"""The first odometry steps of ``examples/sharded_dense_pipeline.py`` in the
JAX engine and in the port, side by side, on the CPU.

Renders the example's world and route (ground every 0.12 m, 131,072-point
scans by default), runs ``init`` and the first ``--frames`` steps of both
packages with the example's configuration (``--max-iterations`` sets the ICP
budget, 8 in the example) and prints, per frame and package, the ICP
iterations, its final error, whether it converged and the pose's
translation next to the ground truth's. Needs JAX (the GPU host has none);
the port runs with its plain K2 on the CPU.

    python3 tools/dense_example_steps.py [--points 131072] [--frames 2] [--max-iterations 8]
"""

from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--points", type=int, default=131072)
    ap.add_argument("--frames", type=int, default=2)
    ap.add_argument("--max-iterations", type=int, default=8)
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np
    import torch

    sys.path.insert(0, ROOT)
    from lidar_slam_tpu import config as jconfig
    from lidar_slam_tpu.models import pipeline as jpipe
    from lidar_slam_tpu_torch import config
    from lidar_slam_tpu_torch.models import pipeline
    from lidar_slam_tpu_torch.ops import knn_cuda
    from lidar_slam_tpu_torch.utils.dataset import (
        generate_trajectory,
        generate_world,
        render_scan,
        route_half_for,
    )

    N = args.points
    half = route_half_for(60)
    world = generate_world(0, route_half=half, ground_step=0.12)
    gt = generate_trajectory(60, half=half)
    rng = np.random.default_rng(0)
    scans = []
    for i in range(args.frames + 1):
        s = render_scan(world, gt[i], rng, max_range=45.0, max_points=N)
        s = s[np.argsort(s[:, 0], kind="stable")]
        buf = np.zeros((N, 3), np.float32)
        buf[: min(len(s), N)] = s[:N]
        scans.append((buf, min(len(s), N)))

    def make(mod):
        return mod.SlamConfig(
            max_raw_points=N, max_points=N, lc_cloud_points=16384,
            max_frames=16, host_voxelize=True, min_points=1024,
            loop_check_every=5, loop_start_frame=1,
            icp=mod.ICPConfig(max_iterations=args.max_iterations,
                              tolerance=1e-4, sample_points=4096,
                              warm_start=True),
            lc=mod.LoopClosureConfig(frame_gap=2, verify_sample=2048,
                                     icp_max_iterations=4),
            normal_window=8192)

    jcfg, cfg = make(jconfig), make(config)
    jstate = jpipe.make_init_fn(jcfg)(jpipe.init_state(jcfg),
                                      jnp.asarray(scans[0][0]),
                                      jnp.int32(scans[0][1]))
    jstep = jpipe.make_step_fn(jcfg)
    state = pipeline.init_state(cfg, "cpu")
    pipeline.init_frame(state, cfg, torch.from_numpy(scans[0][0]), scans[0][1])
    for f in range(1, args.frames + 1):
        raw, n = scans[f]
        jstate = jstep(jstate, jnp.asarray(raw), jnp.int32(n), jnp.int32(f))
        pipeline.step(state, cfg, torch.from_numpy(raw), n, f, knn_cuda.nn1)
        rel = (np.linalg.inv(gt[0]) @ gt[f])[:3, 3]  # in frame 0's frame
        for name, it, err, conv, pose in (
            ("jax", jstate.icp_iters[f], jstate.icp_error[f],
             jstate.icp_converged[f], np.asarray(jstate.poses[f])),
            ("port", state.icp_iters[f], state.icp_error[f],
             state.icp_converged[f], state.poses[f].numpy())):
            print(f"frame {f} {name}: icp_iters {int(it)}, icp_error "
                  f"{float(err):.6f}, converged {bool(conv)}, translation "
                  f"{np.round(pose[:3, 3].astype(float), 4).tolist()} (ground truth from "
                  f"frame 0: {np.round(rel.astype(float), 4).tolist()})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
