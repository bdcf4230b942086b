"""``normal_stride > 1`` of the port's radius and adaptive normals against
the JAX package's: the normals of every stride-th row of the x-sorted
cloud (the adaptive count target ``max(k // stride, 4)``), repeated over
the skipped rows.

Tolerance, that of ``test_torch_ops.py::test_adaptive_normals_match_jax``
and ``test_radius_normals_match_jax``: 95% of the valid normals within 0.5
degrees up to sign (f32 moments summed in another order than the TPU
formulation's); invalid rows equal ((0, 0, 1))."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidar_slam_tpu.ops import normals as jnormals
from lidar_slam_tpu_torch.ops import normals
from lidar_slam_tpu_torch.utils.dataset import (
    generate_trajectory,
    generate_world,
    render_scan,
    route_half_for,
)
from lidar_slam_tpu_torch.utils.native import voxel_downsample_host

torch.set_num_threads(2)

CAP = 2048


@pytest.fixture(scope="module")
def cloud():
    half = route_half_for(60)
    world = generate_world(0, route_half=half)
    gt = generate_trajectory(60, half=half)
    rng = np.random.default_rng(1)
    s = render_scan(world, gt[5], rng, max_range=30.0, max_points=6000)
    v = voxel_downsample_host(s, 0.5, CAP)
    pts = np.zeros((CAP, 3), np.float32)
    pts[: len(v)] = v
    return pts, np.arange(CAP) < len(v)


def _agree(n_t, n_j, mask):
    assert n_t.shape == n_j.shape == (CAP, 3)
    cos = np.clip(np.abs(np.sum(n_j * n_t, axis=1)), 0.0, 1.0)[mask]
    ang = np.degrees(np.arccos(cos))
    assert np.percentile(ang, 95) < 0.5, np.percentile(ang, 95)
    np.testing.assert_array_equal(n_t[~mask], n_j[~mask])


@pytest.mark.parametrize("stride", [2, 3])
def test_radius_normals_stride_matches_jax(cloud, stride):
    pts, mask = cloud
    kw = dict(radius=1.5, window=512, stride=stride)
    n_j = np.asarray(jnormals.estimate_normals_radius(
        jnp.asarray(pts), jnp.asarray(mask), **kw))
    n_t = normals.estimate_normals_radius(
        torch.from_numpy(pts), torch.from_numpy(mask), **kw).numpy()
    _agree(n_t, n_j, mask)
    # each row carries the normal of the strided row it was repeated from
    src = (np.arange(CAP) // stride) * stride
    np.testing.assert_array_equal(n_t[mask], n_t[src][mask])


@pytest.mark.parametrize("stride", [2, 3])
def test_adaptive_normals_stride_matches_jax(cloud, stride):
    pts, mask = cloud
    kw = dict(k=20, r_probe=(2.0, 8.0), r_min=1.2, r_max=20.0, window=512,
              probe_stride=2, stride=stride)
    n_j = np.asarray(jnormals.estimate_normals_adaptive(
        jnp.asarray(pts), jnp.asarray(mask), **kw))
    n_t = normals.estimate_normals_adaptive(
        torch.from_numpy(pts), torch.from_numpy(mask), **kw).numpy()
    _agree(n_t, n_j, mask)
