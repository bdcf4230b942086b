"""The port's ops against the JAX package's on the same numpy inputs.

Tolerances: float32 elementwise math that both sides evaluate in the same
order is held to 1e-6; where a reduction or matmul sums in another order
(XLA vs ATen) the tolerance says so."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from lidar_slam_tpu.config import ICPConfig as JICPConfig
from lidar_slam_tpu.config import OccupancyGridConfig as JGridConfig
from lidar_slam_tpu.config import ScanContextConfig as JSCConfig
from lidar_slam_tpu.ops import icp as jicp
from lidar_slam_tpu.ops import knn_pallas
from lidar_slam_tpu.ops import linalg as jlinalg
from lidar_slam_tpu.ops import normals as jnormals
from lidar_slam_tpu.ops import occupancy as jocc
from lidar_slam_tpu.ops import scan_context as jsc
from lidar_slam_tpu.ops import se3 as jse3
from lidar_slam_tpu.ops import voxel as jvoxel
from lidar_slam_tpu.types import PointCloud as JPointCloud
from lidar_slam_tpu_torch.config import ICPConfig, OccupancyGridConfig, ScanContextConfig
from lidar_slam_tpu_torch.ops import icp, knn_cuda, linalg, normals, occupancy
from lidar_slam_tpu_torch.ops import scan_context as sc
from lidar_slam_tpu_torch.ops import se3, voxel
from lidar_slam_tpu_torch.types import PointCloud
from lidar_slam_tpu_torch.utils.dataset import (
    generate_trajectory,
    generate_world,
    render_scan,
    route_half_for,
)
from lidar_slam_tpu_torch.utils.native import voxel_downsample_host

torch.set_num_threads(2)


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(a_torch, b_jax, **kw):
    np.testing.assert_allclose(a_torch.numpy(), np.asarray(b_jax), **kw)


def _rand_T(rng, max_angle=np.pi * 0.9):
    axis = rng.normal(size=3)
    axis /= np.linalg.norm(axis)
    R = Rotation.from_rotvec(axis * rng.uniform(-max_angle, max_angle)).as_matrix()
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = R
    T[:3, 3] = rng.normal(size=3)
    return T


# -- se3 ---------------------------------------------------------------------


def test_se3_compose_apply_inverse_adjoint(rng):
    A, B = _rand_T(rng), _rand_T(rng)
    pts = rng.normal(size=(10, 3)).astype(np.float32)
    _close(se3.compose(_t(A), _t(B)), jse3.compose(A, B), atol=1e-6)
    _close(se3.apply(_t(A), _t(pts)), jse3.apply(A, pts), atol=2e-6)
    _close(se3.inverse(_t(A)), jse3.inverse(A), atol=1e-6)
    _close(se3.adjoint(_t(A)), jse3.adjoint(A), atol=2e-6)


def test_se3_exp_so3(rng):
    for _ in range(20):
        w = rng.normal(size=3).astype(np.float32) * rng.uniform(0, 3)
        _close(se3.exp_so3(_t(w)), jse3.exp_so3(w), atol=1e-6)
    for w in (np.zeros(3, np.float32), np.array([1e-9, -1e-9, 1e-9], np.float32)):
        _close(se3.exp_so3(_t(w)), jse3.exp_so3(w), atol=1e-7)


@pytest.mark.parametrize("angle", [1e-7, 0.1, 1.5, np.pi - 1e-3, np.pi])
def test_se3_log_so3(rng, angle):
    axis = rng.normal(size=3)
    axis /= np.linalg.norm(axis)
    R = np.asarray(jse3.exp_so3(jnp.asarray((axis * angle).astype(np.float32))))
    _close(se3.log_so3(_t(R)), jse3.log_so3(R), atol=2e-5)


def test_se3_exp_log_batched(rng):
    xi = rng.normal(size=(20, 6)).astype(np.float32)
    T = se3.exp(_t(xi))
    _close(T, jse3.exp(xi), atol=2e-6)
    _close(se3.log(T), jse3.log(np.asarray(T)), atol=2e-5)


def test_se3_orthonormalize(rng):
    T = _rand_T(rng)
    T[:3, :3] += (rng.normal(size=(3, 3)) * 1e-3).astype(np.float32)
    _close(se3.orthonormalize(_t(T)), jse3.orthonormalize(T), atol=1e-6)


def test_solve_psd_small(rng):
    B = rng.normal(size=(8, 6, 6))
    A = (B @ np.swapaxes(B, 1, 2) + 0.1 * np.eye(6)).astype(np.float32)
    b = rng.normal(size=(8, 6)).astype(np.float32)
    x = linalg.solve_psd_small(_t(A), _t(b))
    # the same unrolled operations; matching rounding up to libm / fusion
    _close(x, jlinalg.solve_psd_small(A, b), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        np.einsum("bij,bj->bi", A, x.numpy()), b, rtol=1e-3, atol=1e-3
    )


# -- clouds from the native voxelizer ---------------------------------------


def _frames(n_pts=6000, frames=(3, 4), voxel=0.5, cap=2048):
    half = route_half_for(60)
    world = generate_world(0, route_half=half)
    gt = generate_trajectory(60, half=half)
    rng = np.random.default_rng(1)
    out = []
    for f in frames:
        s = render_scan(world, gt[f], rng, max_range=30.0, max_points=n_pts)
        out.append(voxel_downsample_host(s, voxel, cap))
    return out, gt


def _padded(pts, cap=2048):
    out = np.zeros((cap, 3), np.float32)
    out[: len(pts)] = pts
    return out, np.arange(cap) < len(pts)


def test_adaptive_normals_match_jax():
    (scan,), _ = _frames(frames=(5,))
    pts, mask = _padded(scan)
    kw = dict(k=20, r_probe=(2.0, 8.0), r_min=1.2, r_max=20.0, window=512,
              probe_stride=2)
    n_j = np.asarray(jnormals.estimate_normals_adaptive(
        jnp.asarray(pts), jnp.asarray(mask), **kw))
    n_t = normals.estimate_normals_adaptive(_t(pts), _t(mask), **kw).numpy()
    cos = np.clip(np.abs(np.sum(n_j * n_t, axis=1)), 0.0, 1.0)[mask]
    ang = np.degrees(np.arccos(cos))
    # f32 moments summed in another order than the TPU's bf16x3 split
    assert np.percentile(ang, 95) < 0.5, np.percentile(ang, 95)
    np.testing.assert_array_equal(n_t[~mask], n_j[~mask])


@pytest.mark.parametrize("window,per_point", [(512, False), (0, False),
                                              (512, True)])
def test_radius_normals_match_jax(window, per_point):
    """``estimate_normals_radius`` (the ``normal_method="radius"`` estimator)
    against the JAX one on the same x-sorted cloud: slab windows and the
    dense sweep, a scalar and a per-point radius. Same tolerance as the
    adaptive estimator's test: 95% of the valid normals within 0.5 degrees
    up to sign (f32 moments summed in another order); invalid rows equal."""
    (scan,), _ = _frames(frames=(5,))
    pts, mask = _padded(scan)
    radius = 1.5
    if per_point:
        radius = np.linspace(1.2, 3.0, len(pts)).astype(np.float32)
    n_j = np.asarray(jnormals.estimate_normals_radius(
        jnp.asarray(pts), jnp.asarray(mask), radius=jnp.asarray(radius),
        window=window))
    n_t = normals.estimate_normals_radius(
        _t(pts), _t(mask), radius=_t(np.asarray(radius, np.float32)),
        window=window).numpy()
    assert n_t.shape == n_j.shape == pts.shape
    np.testing.assert_allclose(np.linalg.norm(n_t[mask], axis=1), 1.0, atol=1e-4)
    cos = np.clip(np.abs(np.sum(n_j * n_t, axis=1)), 0.0, 1.0)[mask]
    ang = np.degrees(np.arccos(cos))
    assert np.percentile(ang, 95) < 0.5, np.percentile(ang, 95)
    np.testing.assert_array_equal(n_t[~mask], n_j[~mask])


def test_radius_counts_match_jax():
    (scan,), _ = _frames(frames=(5,))
    pts, mask = _padded(scan)
    pts_m = np.where(mask[:, None], pts, np.float32(1e6)).astype(np.float32)
    c_j = jnormals._radius_counts2(jnp.asarray(pts_m), (2.0, 8.0), 512, ts=128,
                                   tgt=jnp.asarray(pts_m[::2]))
    c_t = normals._radius_counts2(_t(pts_m), (2.0, 8.0), 512, ts=128,
                                  tgt=_t(pts_m[::2]))
    for a, b in zip(c_t, c_j):  # integer counts of exact f32 distances
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_icp_slab_backend_matches_jax():
    (s0, s1), _ = _frames()
    tgt, tmask = _padded(s0)
    src, smask = _padded(s1)
    nrm = np.asarray(jnormals.estimate_normals_adaptive(
        jnp.asarray(tgt), jnp.asarray(tmask), window=512, probe_stride=2,
        r_min=1.2))
    cfg = dict(max_iterations=20, tolerance=3e-4, sample_points=1024)
    res_j = jicp.icp_point_to_plane(
        JPointCloud(jnp.asarray(src), jnp.asarray(smask)),
        JPointCloud(jnp.asarray(tgt), jnp.asarray(tmask)),
        jnp.asarray(nrm), JICPConfig(**cfg),
        nn1_fn=knn_pallas.make_slab_pallas_backend(window=512, interpret=True),
    )
    res_t = icp.icp_point_to_plane(
        PointCloud(_t(src), _t(smask)), PointCloud(_t(tgt), _t(tmask)),
        _t(nrm), ICPConfig(**cfg),
        nn1_fn=knn_cuda.SlabBackend(window=512),
    )
    assert int(res_t.num_iterations) == int(res_j.num_iterations)
    assert bool(res_t.converged) == bool(res_j.converged)
    # same correspondences; the 6x6 normal equations sum in another order
    _close(res_t.transformation, res_j.transformation, atol=1e-5)
    _close(res_t.final_error, res_j.final_error, rtol=1e-4)


def test_icp_batched_lanes_equal_single_lanes():
    """Lanes of a batched ICP (loop verification) behave as independent
    single-lane runs: converged lanes stay frozen."""
    (s0, s1, s2), _ = _frames(frames=(3, 4, 5))
    src, smask = _padded(s1)
    tgts = [_padded(s) for s in (s0, s2, s1)]
    nrm = [normals.estimate_normals_adaptive(_t(p), _t(m), window=512,
                                             r_min=1.2) for p, m in tgts]
    cfg = ICPConfig(max_iterations=15, tolerance=3e-4)
    batch = icp.icp_point_to_plane(
        PointCloud(_t(src), _t(smask)),
        PointCloud(torch.stack([_t(p) for p, _ in tgts]),
                   torch.stack([_t(m) for _, m in tgts])),
        torch.stack(nrm), cfg, inactive=torch.tensor([False, False, True]),
    )
    for k in range(2):
        one = icp.icp_point_to_plane(
            PointCloud(_t(src), _t(smask)),
            PointCloud(_t(tgts[k][0]), _t(tgts[k][1])), nrm[k], cfg,
        )
        assert int(one.num_iterations) == int(batch.num_iterations[k])
        torch.testing.assert_close(one.transformation, batch.transformation[k],
                                   rtol=0, atol=1e-6)
    assert int(batch.num_iterations[2]) == 0 and bool(batch.converged[2])


# -- scan context -------------------------------------------------------------


def test_scan_context_exact():
    scans, _ = _frames(frames=(2, 9, 30))
    for s in scans:
        pts, mask = _padded(s)
        d_j = jsc.scan_context(jnp.asarray(pts), jnp.asarray(mask), JSCConfig())
        d_t = sc.scan_context(_t(pts), _t(mask), ScanContextConfig())
        np.testing.assert_array_equal(d_t.numpy(), np.asarray(d_j))


def test_sc_distances_match_jax():
    scans, _ = _frames(frames=(0, 2, 9, 30, 57))
    descs = np.stack([
        np.asarray(jsc.scan_context(*map(jnp.asarray, _padded(s)), JSCConfig()))
        for s in scans
    ] + [np.zeros((20, 60), np.float32)])
    norms = np.sqrt((descs ** 2).sum(axis=(1, 2))).astype(np.float32)
    for q in range(len(scans)):
        d_j, s_j = jsc.sc_distances(descs[q], descs, norms)
        d_t, s_t = sc.sc_distances(_t(descs[q]), _t(descs), _t(norms))
        # (60 x 1200) @ (1200 x F) in f32, summed in another order
        _close(d_t, d_j, atol=1e-6)
        np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
    yaw_j = jsc.shift_to_yaw(jnp.arange(60), 60)
    _close(sc.shift_to_yaw(torch.arange(60), 60), yaw_j, atol=1e-6)


# -- occupancy ----------------------------------------------------------------


@pytest.mark.parametrize("sensor_x", [3.0, 90.0])
def test_update_occupancy_exact(rng, sensor_x):
    """Grid and drop count equal, including a patch clipped at the grid edge
    (sensor_x=90: the patch is pushed inside and in-range points beyond it
    are dropped)."""
    kw = dict(resolution=0.2, max_range=40.0, grid_dim=1024)
    sensor = np.array([sensor_x, -2.0], np.float32)
    pts = np.concatenate([
        rng.uniform(-45, 45, size=(4000, 2)) + sensor,
        rng.uniform(0.0, 2.5, size=(4000, 1)),
    ], axis=1).astype(np.float32)
    mask = rng.uniform(size=4000) > 0.05
    grid0 = (rng.uniform(size=(1024, 1024)) > 0.999).astype(np.uint8)
    g_j, drop_j = jocc.update_occupancy(
        jnp.asarray(grid0), jnp.asarray(pts), jnp.asarray(mask),
        jnp.asarray(sensor), JGridConfig(**kw),
    )
    g_t = _t(grid0.copy())
    drop_t = occupancy.update_occupancy(g_t, _t(pts), _t(mask), _t(sensor),
                                        OccupancyGridConfig(**kw))
    assert int(drop_t) == int(drop_j)
    if sensor_x > 50:
        assert int(drop_t) > 0
    np.testing.assert_array_equal(g_t.numpy(), np.asarray(g_j))


# -- device voxelizer ----------------------------------------------------------


@pytest.mark.parametrize("case", ["fits", "over_capacity", "out_larger_than_n",
                                  "pass_through", "clamped", "all_masked"])
def test_voxel_downsample_matches_jax(rng, case):
    """Mask and the set of occupied voxels exactly, centroids to 1e-5 m
    (each voxel is summed over its sorted run, the order in which the JAX
    CPU scatter-add visits it); the over-capacity strided pick, the
    pass-through at ``voxel_size <= 0``, the +-511-voxel clamp."""
    N, out, vs, scale = {
        "fits": (4096, 2048, 0.5, 6.0),
        "over_capacity": (4096, 512, 0.5, 30.0),
        "out_larger_than_n": (1000, 2048, 0.5, 5.0),
        "pass_through": (4096, 1024, 0.0, 10.0),
        "clamped": (2048, 1024, 0.5, 400.0),
        "all_masked": (512, 256, 0.5, 5.0),
    }[case]
    pts = (rng.normal(size=(N, 3)) * scale).astype(np.float32)
    mask = np.arange(N) < (0 if case == "all_masked" else N - 300)
    want = jvoxel.voxel_downsample(jnp.asarray(pts), jnp.asarray(mask), vs, out)
    got = voxel.voxel_downsample(_t(pts), _t(mask), vs, out)
    assert got.points.shape == (out, 3) and got.mask.shape == (out,)
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    _close(got.points, want.points, rtol=0, atol=1e-5)
    n = int(got.mask.sum())
    if case == "over_capacity":
        assert n == out
    if vs > 0 and n:  # the same voxels, in ascending key order
        k_t = voxel.voxel_keys(got.points[:n], got.mask[:n], vs).numpy()
        k_j = voxel.voxel_keys(_t(np.asarray(want.points)[:n]), got.mask[:n],
                               vs).numpy()
        np.testing.assert_array_equal(k_t, k_j)
        if case != "clamped":  # clamped points' centroids leave their voxel
            assert np.all(np.diff(k_t) > 0)
    # twice the same bits: the reduction has a fixed order
    again = voxel.voxel_downsample(_t(pts), _t(mask), vs, out)
    assert torch.equal(again.points, got.points)
