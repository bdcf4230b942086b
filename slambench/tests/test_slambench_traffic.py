"""The frozen traffic: a seed gives the same scans byte for byte, the
world is the port's, the routes revisit where the cells say, and the
roofline arithmetic counts what the kernels must do."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

from lidar_slam_tpu_torch.utils.dataset import generate_world as port_world

from slambench import roofline
from slambench.traffic.generate import generate_world, load_traffic, make_drive, route


def _short(name, frames=3):
    return dataclasses.replace(load_traffic(name), frames=frames)


def test_slambench_same_seed_same_scans():
    t = load_traffic("drive300")
    t = dataclasses.replace(t, frames=3, laps=t.frames // 3)
    a, gt_a = make_drive(t, 2**31 + 5, "cpu")
    b, gt_b = make_drive(t, 2**31 + 5, "cpu")
    c, _ = make_drive(t, 2**31 + 6, "cpu")
    assert all(x.tobytes() == y.tobytes() for x, y in zip(a, b))
    assert np.array_equal(gt_a, gt_b)
    assert a[0].shape == (t.raw_points, 3) and a[0].dtype == np.float32
    # another seed: the same points of the same recording, in another order
    assert a[0].tobytes() != c[0].tobytes()
    key = lambda x: x[np.lexsort(x.T)]
    assert np.array_equal(key(a[0]), key(c[0]))


def test_slambench_world_is_the_ports():
    for seed, half in ((0, 50.2293), (3, 14.3239)):
        assert np.array_equal(generate_world(seed, route_half=half, corridor=60.0),
                              port_world(seed, route_half=half, corridor=60.0))


@pytest.mark.parametrize("name,first,last", [("revisit4x75", 80, 290),
                                             ("drive300", 270, 290),
                                             ("drive160", 150, 150)])
def test_slambench_ticks_revisit_the_first_lap(name, first, last):
    t = load_traffic(name)
    gt = route(t)
    lap = gt[: t.lap_frames, :2, 3]
    for q in range(first, last + 1, 10):
        assert np.linalg.norm(lap - gt[q, :2, 3], axis=1).min() < t.step_m, q


def test_slambench_laps_must_agree(tmp_path):
    (tmp_path / "bad.json").write_text(
        '{"frames": 300, "laps": 2, "revisit_share": 0.125, "step_m": 1.2, '
        '"raw_points": 10, "corridor_m": 60.0, "max_range_m": 50.0, '
        '"noise_m": 0.02, "recording_seed": 0}')
    with pytest.raises(ValueError):
        load_traffic("bad", tmp_path)


def test_slambench_roofline_counts():
    flops, nbytes = roofline.k2_launch(1, 32768, 32768, 32768, 32768)
    assert flops == 8 * 32768 ** 2 == pytest.approx(8.59e9, rel=1e-3)
    assert 32768 ** 2 == pytest.approx(1.074e9, rel=1e-3)
    assert nbytes == 32768 * 12 * 2 + 32768 * 8
    assert roofline.bound_s(flops, nbytes) == pytest.approx(128.2e-6, rel=1e-3)
    f1, b1 = roofline.k1_launch(1, 4096, 4096, 32768)
    assert f1 == 8 * 4096 * 4096
    assert roofline.bound_s(f1, b1) == pytest.approx(2.003e-6, rel=1e-3)
    # 3 lanes, partly valid: counts scale with the lanes and the valid rows
    f3, _ = roofline.k2_launch(3, 1000, 2000, 4096, 32768)
    assert f3 == 8 * 3 * 1000 * 2000
