"""The engine's host-normals path (``config.host_normals``: the loader's
radius normals ride along with each host-voxelized scan) and the device
radius estimator (``normal_method="radius"``), beside the JAX engine on the
same scans at tiny shapes: a 40-frame route whose last eighth revisits the
start, fast mode."""

import numpy as np
import pytest
import torch

from lidar_slam_tpu import config as jconfig
from lidar_slam_tpu.cli import _apply_mode
from lidar_slam_tpu.models.pipeline import SlamEngine as JSlamEngine
from lidar_slam_tpu.utils import native as jnative
from lidar_slam_tpu_torch import config
from lidar_slam_tpu_torch.models import pipeline
from lidar_slam_tpu_torch.utils import native
from lidar_slam_tpu_torch.utils.dataset import (
    generate_trajectory,
    generate_world,
    render_scan,
    route_half_for,
)

from jax_native import jax_native  # noqa: F401  (autouse fixture)

torch.set_num_threads(2)

N_FRAMES = 40
SHORT = 8  # frames of the runs that need no revisit
TINY = dict(max_raw_points=2048, max_points=2048, lc_cloud_points=0,
            max_frames=48, max_loop_factors=16)
# slab and normal windows of 1024 of the 2048 points, as in
# ``test_torch_pipeline.py``: narrower ones lose track in both engines
KNOBS = dict(host_voxelize=True, slab_window=1024, normal_window=1024,
             dispatch_block=0, normal_method="radius")


def _configs(**kw):
    jcfg = _apply_mode(jconfig.tiny_config(**TINY), "fast").replace(**KNOBS, **kw)
    cfg = config.apply_mode(config.tiny_config(**TINY), "fast").replace(
        **KNOBS, **kw)
    return jcfg, cfg


@pytest.fixture(scope="module")
def route():
    _, cfg = _configs(host_normals=True)
    half = route_half_for(N_FRAMES)
    world = generate_world(0, route_half=half)
    gt = generate_trajectory(N_FRAMES, half=half)
    rng = np.random.default_rng(0)
    scans = [
        native.voxel_downsample_host(
            render_scan(world, gt[i], rng, max_range=15.0, max_points=20000),
            0.5, TINY["max_points"])
        for i in range(N_FRAMES)
    ]
    normals = [native.normals_radius_host(s, cfg.effective_normal_radius)
               for s in scans]
    return scans, normals


@pytest.fixture(scope="module")
def jax_run(route):
    scans, normals = route
    jcfg, _ = _configs(host_normals=True)
    eng = JSlamEngine(jcfg)
    for f, (s, n) in enumerate(zip(scans, normals)):
        eng.push_scan(s, normals=n)
        if f == SHORT - 1:
            eng.flush()
            early = eng.trajectory()
    odo = eng.trajectory()
    eng.finalize()
    st = eng.state
    n = int(st.pg.n_loops)
    return dict(cfg=jcfg, early=early, odo=odo, final=eng.trajectory(),
                metrics=eng.metrics(), db_normals=np.asarray(st.db.normals),
                pairs=list(zip(np.asarray(st.pg.loop_to[:n]).tolist(),
                               np.asarray(st.pg.loop_from[:n]).tolist())))


@pytest.fixture(scope="module")
def port_run(route):
    """The resident run: ``preload(scans, normals=...)``."""
    scans, normals = route
    _, cfg = _configs(host_normals=True)
    eng = pipeline.SlamEngine(cfg, "cpu")
    eng.preload(scans, normals=normals)
    eng.run_preloaded()
    odo = eng.trajectory()
    eng.finalize()
    return dict(cfg=cfg, eng=eng, odo=odo, final=eng.trajectory(),
                metrics=eng.metrics(), pairs=eng.loop_pairs())


def test_native_radius_normals_equal_jax_binding(route):
    """Both packages bind the same ``lidar_normals_radius``: exact."""
    scans, normals = route
    _, cfg = _configs(host_normals=True)
    for s, n in list(zip(scans, normals))[::13]:
        assert n.shape == s.shape and n.dtype == np.float32
        np.testing.assert_array_equal(
            n, jnative.normals_radius_host(s, cfg.effective_normal_radius))


def test_host_normals_accept_sets_identical(jax_run, port_run):
    assert port_run["metrics"]["loop_count"] >= 1
    assert port_run["pairs"] == jax_run["pairs"]
    for key in ("loop_count", "verify_fired", "verify_fine_fired",
                "verify_bound_hit", "loops_dropped"):
        assert port_run["metrics"][key] == jax_run["metrics"][key], key
    np.testing.assert_array_equal(port_run["metrics"]["frame_npts"],
                                  jax_run["metrics"]["frame_npts"])


def test_host_normals_trajectory_matches_jax(route, jax_run, port_run):
    """Trajectories before and after finalize within 5e-3 m; the normals the
    DB keeps are the host's rows under the cloud's mask, so they are equal
    bit for bit."""
    scans, normals = route
    for stage in ("odo", "final"):
        a, b = port_run[stage], jax_run[stage]
        assert a.shape == b.shape == (N_FRAMES, 4, 4)
        err = np.abs(a[:, :3, 3] - b[:, :3, 3]).max()
        assert err < 5e-3, (stage, err)
    assert np.abs(port_run["odo"][:, :2, 3]).max() > 2.0  # it followed the route
    got = port_run["eng"].state.db.normals.numpy()
    np.testing.assert_array_equal(got, jax_run["db_normals"])
    f = 7
    np.testing.assert_array_equal(got[f, : len(scans[f])], normals[f])
    assert not got[f, len(scans[f]):].any()


def test_push_scan_takes_or_computes_the_normals(route, jax_run, port_run):
    """``push_scan(pts, normals=n)`` and ``push_scan(pts)`` (which computes
    the normals with the native radius estimator, as the JAX engine does)
    repeat the resident run bit for bit."""
    scans, normals = route
    given = pipeline.SlamEngine(port_run["cfg"], "cpu")
    computed = pipeline.SlamEngine(port_run["cfg"], "cpu")
    for s, n in zip(scans[:SHORT], normals[:SHORT]):
        given.push_scan(s, normals=n)
        computed.push_scan(s)
    for eng in (given, computed):
        np.testing.assert_array_equal(eng.trajectory(),
                                      port_run["odo"][:SHORT])
        np.testing.assert_array_equal(
            eng.state.db.normals[:SHORT].numpy(),
            port_run["eng"].state.db.normals[:SHORT].numpy())
    err = np.abs(given.trajectory()[:, :3, 3] - jax_run["early"][:, :3, 3]).max()
    assert err < 5e-3, err


def test_preload_without_normals_raises_as_jax_does(route, jax_run, port_run):
    scans, _ = route
    with pytest.raises(ValueError, match="host_normals"):
        pipeline.SlamEngine(port_run["cfg"], "cpu").preload(scans[:2])
    with pytest.raises(ValueError, match="host_normals"):
        JSlamEngine(jax_run["cfg"]).preload(scans[:2])


def test_device_radius_normals_engine_matches_jax(route):
    """``normal_method="radius"`` without ``host_normals``: both engines
    estimate on the device. Poses within 5e-3 m over a short run, normals
    within 0.5 degrees (95th percentile, up to sign)."""
    scans, _ = route
    jcfg, cfg = _configs()
    assert not cfg.host_normals and cfg.normal_method == "radius"
    jeng, eng = JSlamEngine(jcfg), pipeline.SlamEngine(cfg, "cpu")
    for s in scans[:SHORT]:
        jeng.push_scan(s)
        eng.push_scan(s)
    jeng.flush()
    a, b = eng.trajectory(), jeng.trajectory()
    assert a.shape == b.shape == (SHORT, 4, 4)
    assert np.abs(a[:, :3, 3] - b[:, :3, 3]).max() < 5e-3
    assert np.abs(a[-1, :2, 3] - a[0, :2, 3]).max() > 1.0  # it moved
    n_t = eng.state.db.normals[:SHORT].numpy()
    n_j = np.asarray(jeng.state.db.normals[:SHORT])
    m = eng.state.db.cloud_mask[:SHORT].numpy()
    cos = np.clip(np.abs(np.sum(n_t * n_j, axis=-1)), 0, 1)[m]
    assert np.percentile(np.degrees(np.arccos(cos)), 95) < 0.5
