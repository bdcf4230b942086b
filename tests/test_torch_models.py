"""Loop detection and the pose-graph backend of the port against the JAX
package on the same inputs."""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidar_slam_tpu.config import LoopClosureConfig as JLCConfig
from lidar_slam_tpu.config import PoseGraphConfig as JPGConfig
from lidar_slam_tpu.config import ScanContextConfig as JSCConfig
from lidar_slam_tpu.models import loop_closure as jlc
from lidar_slam_tpu.models import pose_graph as jpg
from lidar_slam_tpu.ops import normals as jnormals
from lidar_slam_tpu.types import PointCloud as JPointCloud
from lidar_slam_tpu_torch.config import LoopClosureConfig, PoseGraphConfig, ScanContextConfig
from lidar_slam_tpu_torch.models import loop_closure as lc
from lidar_slam_tpu_torch.models import pose_graph as pg
from lidar_slam_tpu_torch.types import PointCloud
from lidar_slam_tpu_torch.utils.dataset import generate_world, render_scan
from lidar_slam_tpu_torch.utils.metrics import ate_rmse
from lidar_slam_tpu_torch.utils.native import voxel_downsample_host

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from tools.profile_pose_graph import build_graph  # noqa: E402

torch.set_num_threads(2)


def _t(x):
    return torch.from_numpy(np.array(x))


def _revisit_scans():
    """Scans along a straight street, then two revisits of its start."""
    world = generate_world(0, route_half=8.0)
    poses = []
    for i in range(10):
        T = np.eye(4, dtype=np.float32)
        T[:3, 3] = [i * 1.5, 0, 1.8]
        poses.append(T)
    for k, yaw in ((1, 0.2), (2, -0.3)):
        T = np.eye(4, dtype=np.float32)
        c, s = np.cos(yaw), np.sin(yaw)
        T[:3, :3] = [[c, -s, 0], [s, c, 0], [0, 0, 1]]
        T[:3, 3] = poses[k][:3, 3]
        poses.append(T)
    rng = np.random.default_rng(0)
    scans = []
    for p in poses:
        s = render_scan(world, p, rng, max_range=25.0, max_points=4000)
        scans.append(voxel_downsample_host(s, 0.4, 2048))
    return scans


@pytest.mark.parametrize("fast", [False, True])
def test_detect_matches_jax(fast):
    scans = _revisit_scans()
    kw = dict(frame_gap=5, sc_distance_threshold=0.5, icp_fitness_threshold=0.6,
              icp_max_iterations=15, verify_tolerance=1e-3)
    if fast:  # the fast-mode verify: coarse phase + reject gate + yaw seed,
        # run to a 1e-5 tolerance: at fast mode's 3e-4 the stopping iterate
        # of an accepted lane moves by ~1 cm under the last-bit distance
        # differences of the two 1-NN forms (see below)
        kw.update(verify_tolerance=1e-5, verify_coarse_iterations=3,
                  verify_coarse_sample=512, yaw_seed=True,
                  verify_coarse_reject=0.6, verify_sample=1024)
    jcfg, cfg = JLCConfig(**kw), LoopClosureConfig(**kw)
    F, N = 16, 2048
    jdb = jlc.init_db(F, N, JSCConfig())
    db = lc.init_db(F, N, ScanContextConfig())
    for f, s in enumerate(scans):
        pts = np.zeros((N, 3), np.float32)
        pts[: len(s)] = s
        mask = np.arange(N) < len(s)
        nrm = np.asarray(jnormals.estimate_normals_adaptive(
            jnp.asarray(pts), jnp.asarray(mask), r_min=1.0, window=512))
        jdb = jlc.add_frame(jdb, JPointCloud(jnp.asarray(pts), jnp.asarray(mask)),
                            jnp.int32(f), JSCConfig(), normals=jnp.asarray(nrm))
        lc.add_frame(db, PointCloud(_t(pts), _t(mask)), f, ScanContextConfig(),
                     enabled=True, normals=_t(nrm))
    for name in ("desc", "clouds", "cloud_mask", "normals", "in_db"):
        np.testing.assert_array_equal(getattr(db, name).numpy(),
                                      np.asarray(getattr(jdb, name)))
    n_acc = 0
    for q in (len(scans) - 2, len(scans) - 1):
        det_j = jlc.detect(jdb, jcfg, JSCConfig(), query=jnp.int32(q))
        det_t = lc.detect(db, cfg, ScanContextConfig(), query=q)
        acc = det_t.accepted.numpy()
        n_acc += int(acc.sum())
        np.testing.assert_array_equal(acc, np.asarray(det_j.accepted))
        np.testing.assert_array_equal(det_t.match_frame.numpy(),
                                      np.asarray(det_j.match_frame))
        assert det_t.n_valid == int(det_j.n_valid)
        assert det_t.fine_fired == bool(det_j.fine_fired)
        fit_j = np.asarray(det_j.icp_fitness)
        np.testing.assert_array_equal(np.isfinite(det_t.icp_fitness.numpy()),
                                      np.isfinite(fit_j))
        # The JAX CPU path verifies with the expansion-form 1-NN
        # (|s|^2+|t|^2-2s.t), the port with the difference form, so
        # distances differ in the last bits: accepted lanes agree to 1e-4;
        # a lane that exhausts its budget unconverged compounds the
        # difference and is only held to the same (rejecting) verdict.
        np.testing.assert_allclose(det_t.transform.numpy()[acc],
                                   np.asarray(det_j.transform)[acc], atol=1e-4)
        np.testing.assert_allclose(det_t.icp_fitness.numpy()[acc], fit_j[acc],
                                   rtol=1e-4)
    assert n_acc > 0


def _graph(n, n_loops, seed):
    gt, rels, loops = build_graph(n, n_loops, seed=seed)
    chain = np.zeros((n, 4, 4))
    chain[0] = np.eye(4)
    for i in range(1, n):
        chain[i] = chain[i - 1] @ rels[i]
    cap, L = n + 8, 16
    jst = jpg.init_state(cap, L)
    st = pg.init_state(cap, L)
    chain32 = chain.astype(np.float32)
    jst = jst._replace(poses=jnp.asarray(np.concatenate(
        [chain32, np.tile(np.eye(4, dtype=np.float32), (8, 1, 1))])))
    st.poses[:n] = _t(chain32)
    fitness = np.random.default_rng(seed).uniform(0, 0.2, n).astype(np.float32)
    for k in range(1, n):
        rel = rels[k].astype(np.float32)
        jst = jpg.add_odometry(jst, jnp.int32(k), jnp.asarray(rel),
                               jnp.float32(fitness[k]))
        pg.add_odometry(st, k, _t(rel), torch.tensor(fitness[k]))
    for i, j, rel in loops:
        jst = jpg.add_loop(jst, jnp.int32(i), jnp.int32(j),
                           jnp.asarray(rel, jnp.float32))
        pg.add_loop(st, i, j, _t(rel.astype(np.float32)))
    # raw chain re-derived by add_odometry (f32 compose): both sides alike
    for name in ("poses", "odom_rel", "odom_valid", "odom_scale", "loop_from",
                 "loop_to", "loop_rel", "loop_valid"):
        np.testing.assert_allclose(getattr(st, name).numpy(),
                                   np.asarray(getattr(jst, name)), atol=1e-5)
    return gt, jst, st


def test_f64_optimize_matches_host_f64():
    """The port's float64 LM against the JAX package's NumPy-f64 LM: both run
    the same Woodbury steps in f64 and stop at the same iterate; they differ
    only in f64 rounding and the orthonormalisation method."""
    n = 300
    gt, jst, st = _graph(n, 6, seed=5)
    cfg = PoseGraphConfig()
    res_h = jpg.optimize_host(jst, JPGConfig())
    res_t = pg.optimize(pg.compact_loops(st).to(torch.float64), cfg)
    assert res_t.converged and bool(res_h.converged)
    # optimize_host hands back f32 poses: compare both rounded to f32, to
    # 1e-6 m plus one f32 ulp of the coordinate
    p_t = res_t.poses[:n].numpy().astype(np.float32)
    p_h = np.asarray(res_h.poses)[:n]
    dt = np.abs(p_t[:, :3, 3] - p_h[:, :3, 3])
    assert np.all(dt <= 1e-6 + np.spacing(np.abs(p_h[:, :3, 3]))), dt.max()
    assert abs(res_t.final_error - float(res_h.final_error)) <= 1e-6 * res_t.final_error + 1e-9
    raw = st.poses[:n].numpy()
    assert ate_rmse(p_t, gt) < 0.5 * ate_rmse(raw, gt)


def test_prefix_compose_equals_sequential(rng):
    M = torch.from_numpy(np.stack([
        np.asarray(jpg.se3.exp(jnp.asarray(rng.normal(size=6) * 0.3)))
        for _ in range(37)
    ]).astype(np.float64))
    P = pg._prefix_compose(M)
    acc = M[0]
    for k in range(1, 37):
        acc = acc @ M[k]
        torch.testing.assert_close(P[k], acc, rtol=0, atol=1e-12)


def test_residuals_match_jax():
    gt, jst, st = _graph(64, 3, seed=1)
    r_j = jpg._residuals(jst, jnp.zeros((72, 6), jnp.float32), JPGConfig())
    r_t = pg._residuals(st, torch.zeros((72, 6)), PoseGraphConfig())
    # f32 SE(3) logs of the same poses; whitened by sigmas down to 1e-3
    np.testing.assert_allclose(r_t.numpy(), np.asarray(r_j), rtol=1e-4, atol=2e-3)
