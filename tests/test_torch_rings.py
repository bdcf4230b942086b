"""The port's copy of the ring-pattern raycast LiDAR simulator against the
JAX package's: the analytic world, the ray grid, scans rendered from one
random generator over several poses, and whole datasets, all bit for bit
(the code is the same numpy, with the same draws in the same order)."""

import filecmp
import os

import numpy as np
import pytest

from lidar_slam_tpu.utils import dataset as jdataset
from lidar_slam_tpu_torch.utils import dataset


def test_world_geom_and_ray_dirs_equal_jax():
    for seed, half in ((0, 25.0), (3, 12.0)):
        a = dataset.generate_world_geom(seed, route_half=half)
        b = jdataset.generate_world_geom(seed, route_half=half)
        np.testing.assert_array_equal(a.boxes, b.boxes)
        np.testing.assert_array_equal(a.cylinders, b.cylinders)
        assert a.boxes.dtype == a.cylinders.dtype == np.float32
        assert a.ground_z == b.ground_z
    for shape in ((64, 1024, (-24.8, 2.0)), (16, 128, (-15.0, 15.0))):
        d = dataset._ray_dirs(*shape)
        np.testing.assert_array_equal(d, jdataset._ray_dirs(*shape))
        assert d.dtype == np.float32


def test_render_scan_rings_equal_jax():
    """16 beams x 128 azimuths over 3 poses of one route, each package with
    its own generator of one seed: every scan bit-equal, and the generators
    left in the same state (dropout draws, then the range noise)."""
    half = dataset.route_half_for(40)
    geom = dataset.generate_world_geom(0, route_half=half)
    jgeom = jdataset.generate_world_geom(0, route_half=half)
    poses = dataset.generate_trajectory(40, half=half)
    r_p, r_j = np.random.default_rng(7), np.random.default_rng(7)
    for i in (0, 13, 39):
        a = dataset.render_scan_rings(geom, poses[i], r_p, n_beams=16,
                                      n_azimuth=128)
        b = jdataset.render_scan_rings(jgeom, poses[i], r_j, n_beams=16,
                                       n_azimuth=128)
        assert a.dtype == np.float32 and a.shape[1] == 3 and len(a) > 500
        np.testing.assert_array_equal(a, b)
    assert r_p.uniform() == r_j.uniform()


@pytest.mark.parametrize("fmt", ["bin", "ply"])
def test_make_rings_dataset_equal_jax(tmp_path, fmt):
    a, b = str(tmp_path / "port"), str(tmp_path / "jax")
    _, pa = dataset.make_rings_dataset(a, n_frames=3, seed=2, n_beams=16,
                                       n_azimuth=128, fmt=fmt)
    _, pb = jdataset.make_rings_dataset(b, n_frames=3, seed=2, n_beams=16,
                                        n_azimuth=128, fmt=fmt)
    np.testing.assert_array_equal(pa, pb)
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b))
    assert names == ["000000." + fmt, "000001." + fmt, "000002." + fmt,
                     "poses_gt.txt"]
    match, mismatch, errors = filecmp.cmpfiles(a, b, names, shallow=False)
    assert match == names and not mismatch and not errors
