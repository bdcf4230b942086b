"""The port's exact k-NN (``ops/knn.knn``), its k-NN PCA normals
(``ops/normals.estimate_normals``, ``normal_method="knn"``), the
reference-shaped ICP (``ops/icp.icp_point_to_plane_auto``) and the host
k-NN normals (``utils/native.normals_knn_host``) against the JAX package's.

Tolerances, stated per test: the neighbour sets are equal row by row, and
d2 agrees to 1e-5 relative plus 8 f32 ulps of the largest |p|^2 (the
matrix form |s|^2 + |t|^2 - 2 s.t cancels to that absolute error, and XLA
and ATen sum its matmul in other orders); normals within 1e-4 per component;
the ICP transform within 1e-4; the host normals bit for bit (both call the
same C library)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidar_slam_tpu.config import ICPConfig as JICPConfig
from lidar_slam_tpu.ops import icp as jicp
from lidar_slam_tpu.ops import knn as jknn
from lidar_slam_tpu.ops import normals as jnormals
from lidar_slam_tpu.types import PointCloud as JPointCloud
from lidar_slam_tpu.utils import native as jnative
from lidar_slam_tpu_torch.config import ICPConfig
from lidar_slam_tpu_torch.ops import icp, knn, normals
from lidar_slam_tpu_torch.types import PointCloud
from lidar_slam_tpu_torch.utils import native
from lidar_slam_tpu_torch.utils.dataset import (
    generate_trajectory,
    generate_world,
    render_scan,
    route_half_for,
)
from lidar_slam_tpu_torch.utils.native import voxel_downsample_host

from jax_native import jax_native  # noqa: F401  (autouse)

torch.set_num_threads(2)

N = 1000


@pytest.fixture(scope="module")
def scans():
    """Two voxelized scans of consecutive frames, padded to 1,000 rows with
    a masked tail."""
    half = route_half_for(60)
    world = generate_world(0, route_half=half)
    gt = generate_trajectory(60, half=half)
    rng = np.random.default_rng(5)
    out = []
    for f in (11, 12):
        s = render_scan(world, gt[f], rng, max_range=12.0, max_points=6000)
        v = voxel_downsample_host(s, 0.5, N - 60)
        pts = np.zeros((N, 3), np.float32)
        pts[: len(v)] = v
        out.append((pts, np.arange(N) < len(v)))
    return out


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _close_d2(d_t, d_j, *clouds):
    """1e-5 relative + 8 ulps of the largest squared norm (see above)."""
    sq = max(float(np.max(np.sum(c.astype(np.float64) ** 2, -1)))
             for c in clouds)
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), rtol=1e-5,
                               atol=8 * np.finfo(np.float32).eps * sq)


def _same_sets(i_t, i_j):
    a, b = np.sort(i_t.numpy(), axis=-1), np.sort(np.asarray(i_j), axis=-1)
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("k,chunk", [(20, 300), (8, 2048), (5, 7)])
def test_knn_matches_jax(scans, k, chunk):
    """Same neighbour set per row (the effective chunk 250, 1000 or 5 of
    T = 1000: the requested one does not divide T); d2 as stated above."""
    pts, mask = scans[0]
    src = scans[1][0]
    i_t, d_t = knn.knn(_t(src), _t(pts), _t(mask), k=k, chunk=chunk)
    i_j, d_j = jknn.knn(jnp.asarray(src), jnp.asarray(pts), jnp.asarray(mask),
                        k=k, chunk=chunk, exact=True)
    assert i_t.dtype == torch.int32 and i_t.shape == (N, k)
    _same_sets(i_t, i_j)
    _close_d2(d_t, d_j, src, pts[mask])
    assert int(i_t.max()) < int(mask.sum())  # never a masked target
    assert bool((d_t[:, 1:] >= d_t[:, :-1]).all())  # nearest first


def test_knn_prime_target_count_matches_jax(scans):
    """T = 997 (prime): the chunk shrinks to 1 column, fewer than k, and the
    accumulator's k starting candidates carry the first chunks, as in JAX."""
    pts, mask = scans[0]
    n = 997
    i_t, d_t = knn.knn(_t(pts[:n]), _t(pts[:n]), _t(mask[:n]), k=8)
    i_j, d_j = jknn.knn(jnp.asarray(pts[:n]), jnp.asarray(pts[:n]),
                        jnp.asarray(mask[:n]), k=8, exact=True)
    _same_sets(i_t, i_j)
    _close_d2(d_t, d_j, pts[:n])


def test_knn_ties_keep_the_lower_index(scans):
    """Every point four times over: each row meets ties at every rank, and
    both packages keep the lower indices (lax.top_k's rule)."""
    pts, mask = scans[0]
    n = int(mask.sum()) // 4
    base = pts[:n]
    dup = np.zeros_like(pts)
    dup[: 4 * n] = np.concatenate([base, base, base, base])
    dmask = np.arange(N) < 4 * n
    i_t, d_t = knn.knn(_t(dup), _t(dup), _t(dmask), k=6, chunk=128)
    i_j, d_j = jknn.knn(jnp.asarray(dup), jnp.asarray(dup), jnp.asarray(dmask),
                        k=6, chunk=128, exact=True)
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
    _close_d2(d_t, d_j, dup)
    # the four copies of a point at distance 0, in index order
    row = np.arange(4 * n)
    want = np.sort(np.stack([row % n + c * n for c in range(4)], 1), axis=1)
    np.testing.assert_array_equal(i_t.numpy()[: 4 * n, :4], want)


def test_knn_lanes_equal_each_lane(scans):
    pts = np.stack([s[0] for s in scans])
    mask = np.stack([s[1] for s in scans])
    i_b, d_b = knn.knn(_t(pts), _t(pts), _t(mask), k=10, chunk=256)
    for b in range(2):
        i_1, d_1 = knn.knn(_t(pts[b]), _t(pts[b]), _t(mask[b]), k=10, chunk=256)
        assert torch.equal(i_b[b], i_1) and torch.equal(d_b[b], d_1)


def test_knn_matmuls_are_full_f32_whatever_the_caller_set(scans, monkeypatch):
    """The k-NN's matmuls run at "highest" float32 precision even when the
    caller allows TF32, and the caller's setting is back afterwards; the
    result equals the one under the caller's "highest"."""
    pts, mask = scans[0]
    seen = []
    matmul = torch.matmul

    def spy(*a, **kw):
        seen.append(torch.get_float32_matmul_precision())
        return matmul(*a, **kw)

    prev = torch.get_float32_matmul_precision()
    want = knn.knn(_t(pts), _t(pts), _t(mask), k=8, chunk=256)
    monkeypatch.setattr(knn.torch, "matmul", spy)
    try:
        torch.set_float32_matmul_precision("high")
        got = knn.knn(_t(pts), _t(pts), _t(mask), k=8, chunk=256)
        after = torch.get_float32_matmul_precision()
    finally:
        torch.set_float32_matmul_precision(prev)
    assert seen and set(seen) == {"highest"}
    assert after == "high"
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_estimate_normals_matches_jax(scans):
    """Against the JAX engine's call (``exact=False``; on the CPU its
    approximate top-k returns the exact one): each component within 1e-4;
    the (0, 0, 1) rows (invalid, or < 3 valid neighbours) equal."""
    pts, mask = scans[0]
    for k in (20, 8):
        n_t = normals.estimate_normals(_t(pts), _t(mask), k=k).numpy()
        n_j = np.asarray(jnormals.estimate_normals(
            jnp.asarray(pts), jnp.asarray(mask), k=k))
        np.testing.assert_allclose(n_t, n_j, rtol=0, atol=1e-4)
        np.testing.assert_array_equal(n_t[~mask], n_j[~mask])
        np.testing.assert_allclose(np.linalg.norm(n_t, axis=1), 1.0, atol=1e-5)
    # a cloud of 2 valid points: every row degenerate
    few = np.arange(N) < 2
    np.testing.assert_array_equal(
        normals.estimate_normals(_t(pts), _t(few), k=8).numpy(),
        np.asarray(jnormals.estimate_normals(jnp.asarray(pts),
                                             jnp.asarray(few), k=8)))


def test_estimate_normals_lanes_equal_each_lane(scans):
    pts = np.stack([s[0] for s in scans])
    mask = np.stack([s[1] for s in scans])
    got = normals.estimate_normals(_t(pts), _t(mask), k=12)
    for b in range(2):
        one = normals.estimate_normals(_t(pts[b]), _t(mask[b]), k=12)
        assert torch.equal(got[b], one)


def test_icp_point_to_plane_auto_matches_jax(scans):
    """The reference-shaped ICP (target normals estimated inside): the
    transform within 1e-4."""
    (tp, tm), (sp, sm) = scans
    kw = dict(max_iterations=20, tolerance=1e-6, normal_k=10)
    res_t = icp.icp_point_to_plane_auto(PointCloud(_t(sp), _t(sm)),
                                        PointCloud(_t(tp), _t(tm)),
                                        ICPConfig(**kw))
    res_j = jicp.icp_point_to_plane_auto(
        JPointCloud(jnp.asarray(sp), jnp.asarray(sm)),
        JPointCloud(jnp.asarray(tp), jnp.asarray(tm)), JICPConfig(**kw))
    np.testing.assert_allclose(res_t.transformation.numpy(),
                               np.asarray(res_j.transformation), atol=1e-4)
    assert int(res_t.num_iterations) == int(res_j.num_iterations)
    assert abs(float(res_t.transformation[0, 3])) > 0.1  # it moved


def test_normals_knn_host_matches_jax_binding(scans):
    pts, mask = scans[0]
    cloud = pts[mask]
    for k in (20, 5):
        np.testing.assert_array_equal(native.normals_knn_host(cloud, k),
                                      jnative.normals_knn_host(cloud, k))


def test_frame_loader_knn_normals(tmp_path, scans):
    """``FrameLoader(normals_k=...)``: the workers' normals are
    ``normals_knn_host``'s of the loaded points, as in the JAX loader."""
    from lidar_slam_tpu_torch.utils.io import save_ply

    paths = []
    for i, (pts, mask) in enumerate(scans):
        paths.append(str(tmp_path / f"{i:06d}.ply"))
        save_ply(paths[-1], pts[mask])
    with native.FrameLoader(paths, cap=N, normals_k=12) as ld, \
            jnative.FrameLoader(paths, cap=N, normals_k=12) as jl:
        for f in range(len(paths)):
            p, n = ld.get_with_normals(f)
            jp, jn = jl.get_with_normals(f)
            np.testing.assert_array_equal(p, jp)
            np.testing.assert_array_equal(n, jn)
            np.testing.assert_array_equal(n, native.normals_knn_host(p, 12))
