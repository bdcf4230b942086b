"""The port's fast-mode main path, end to end, against the JAX engine on the
same host-voxelized scans (a ~40-frame route whose last eighth revisits the
start), at tiny shapes."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from lidar_slam_tpu import config as jconfig
from lidar_slam_tpu.cli import _apply_mode
from lidar_slam_tpu.models.pipeline import SlamEngine as JSlamEngine
from lidar_slam_tpu_torch import config
from lidar_slam_tpu_torch.models import pipeline
from lidar_slam_tpu_torch.ops.normals import estimate_normals_adaptive
from lidar_slam_tpu_torch.utils.dataset import (
    generate_trajectory,
    generate_world,
    render_scan,
    route_half_for,
)
from lidar_slam_tpu_torch.utils.metrics import ate_rmse
from lidar_slam_tpu_torch.utils.native import voxel_downsample_host

torch.set_num_threads(2)

N_FRAMES = 40
SNAP = 20  # the one-step test starts from the JAX state after this frame
TINY = dict(max_raw_points=2048, max_points=2048, lc_cloud_points=0,
            max_frames=48, max_loop_factors=16)
# Windows of 1024 of the 2048 points: at 512 the slab windows do not cover
# the +-radius x-bands of these small clouds, both engines lose track (ATE
# 5 m on the ~7 m circle) and the failing ICPs diverge chaotically, which no
# tolerance can compare. Scans are rendered densely within 15 m so the
# 2048-voxel clouds constrain ICP well (plane RMS ~0.24 m).
KNOBS = dict(host_voxelize=True, slab_window=1024, normal_window=1024,
             dispatch_block=0)


def port_config(jcfg) -> config.SlamConfig:
    """The port's config with the field values of a JAX ``SlamConfig``."""
    subs = {"icp": config.ICPConfig, "sc": config.ScanContextConfig,
            "lc": config.LoopClosureConfig, "pg": config.PoseGraphConfig,
            "grid": config.OccupancyGridConfig}
    kw = {}
    for f in dataclasses.fields(jcfg):
        v = getattr(jcfg, f.name)
        kw[f.name] = subs[f.name](**dataclasses.asdict(v)) if f.name in subs else v
    return config.SlamConfig(**kw)


def _tree(x):
    """JAX state pytree -> nested dicts of numpy leaves."""
    if hasattr(x, "_asdict"):
        return {k: _tree(v) for k, v in x._asdict().items()}
    return np.asarray(x)


@pytest.fixture(scope="module")
def route():
    half = route_half_for(N_FRAMES)
    world = generate_world(0, route_half=half)
    gt = generate_trajectory(N_FRAMES, half=half)
    rng = np.random.default_rng(0)
    scans = [
        voxel_downsample_host(
            render_scan(world, gt[i], rng, max_range=15.0, max_points=20000),
            0.5, TINY["max_points"],
        )
        for i in range(N_FRAMES)
    ]
    return scans, gt


@pytest.fixture(scope="module")
def jax_run(route):
    scans, gt = route
    jcfg = _apply_mode(jconfig.tiny_config(**TINY), "fast").replace(**KNOBS)
    eng = JSlamEngine(jcfg)
    snaps = {}
    for f, s in enumerate(scans):
        eng.push_scan(s)
        if f in (SNAP, SNAP + 1):
            snaps[f] = _tree(jax.tree.map(np.asarray, eng.state))
    traj_odo = eng.trajectory()
    eng.finalize()
    st = eng.state
    n = int(st.pg.n_loops)
    pairs = list(zip(np.asarray(st.pg.loop_to[:n]).tolist(),
                     np.asarray(st.pg.loop_from[:n]).tolist()))
    return dict(cfg=jcfg, odo=traj_odo, final=eng.trajectory(),
                metrics=eng.metrics(), pairs=pairs, snaps=snaps,
                grid=np.asarray(st.grid), occ=int(st.occ_dropped))


@pytest.fixture(scope="module")
def port_run(route, jax_run):
    scans, _ = route
    eng = pipeline.SlamEngine(port_config(jax_run["cfg"]), "cpu")
    eng.preload(scans)
    eng.run_preloaded()
    odo = eng.trajectory()
    eng.finalize()
    return dict(eng=eng, odo=odo, final=eng.trajectory(),
                metrics=eng.metrics(), pairs=eng.loop_pairs())


def test_config_fields_match_jax():
    """The port's config copy keeps every field name and default."""
    for name in ("SlamConfig", "ICPConfig", "ScanContextConfig",
                 "LoopClosureConfig", "PoseGraphConfig", "OccupancyGridConfig"):
        a = dataclasses.asdict(getattr(config, name)())
        b = dataclasses.asdict(getattr(jconfig, name)())
        assert a == b, name
    j = _apply_mode(jconfig.SlamConfig(), "fast")
    assert dataclasses.asdict(config.fast_mode(config.SlamConfig())) == \
        dataclasses.asdict(j)
    assert dataclasses.asdict(config.tiny_config()) == \
        dataclasses.asdict(jconfig.tiny_config())
    for base_t, base_j in ((config.SlamConfig(), jconfig.SlamConfig()),
                           (config.tiny_config(), jconfig.tiny_config())):
        for mode in ("default", "fast", "fidelity"):
            assert dataclasses.asdict(config.apply_mode(base_t, mode)) == \
                dataclasses.asdict(_apply_mode(base_j, mode)), mode
    assert config.apply_mode(config.SlamConfig(), "fidelity") == \
        config.fidelity_mode(config.SlamConfig())
    with pytest.raises(ValueError, match="mode"):
        config.apply_mode(config.SlamConfig(), "quick")


def test_loop_accept_sets_identical(jax_run, port_run):
    assert jax_run["metrics"]["loop_count"] >= 1
    assert port_run["pairs"] == jax_run["pairs"]
    for key in ("loop_count", "verify_fired", "verify_fine_fired",
                "verify_bound_hit", "loops_dropped"):
        assert port_run["metrics"][key] == jax_run["metrics"][key], key


def test_trajectory_matches_jax(jax_run, port_run):
    for stage in ("odo", "final"):
        a, b = port_run[stage], jax_run[stage]
        assert a.shape == b.shape == (N_FRAMES, 4, 4)
        err = np.abs(a[:, :3, 3] - b[:, :3, 3]).max()
        assert err < 5e-3, (stage, err)
    it_p, it_j = port_run["metrics"]["icp_iters"], jax_run["metrics"]["icp_iters"]
    assert np.mean(it_p[1:] == it_j[1:]) >= 0.9, (it_p, it_j)


def test_final_ate_and_occupancy(route, jax_run, port_run):
    _, gt = route
    ate_p = ate_rmse(port_run["final"], gt)
    ate_j = ate_rmse(jax_run["final"], gt)
    assert abs(ate_p - ate_j) <= 0.02 * ate_j, (ate_p, ate_j)
    assert ate_p < ate_rmse(port_run["odo"], gt) + 0.05
    # the rebuilt grid: cells at f32 cell boundaries may flip between the
    # two (sub-millimetre pose differences), nothing else
    st = port_run["eng"].state
    diff = int((st.grid.numpy() != jax_run["grid"]).sum())
    assert diff <= 0.002 * int((jax_run["grid"] > 0).sum()) + 2, diff
    assert int(st.occ_dropped) == jax_run["occ"]


def test_one_step_from_jax_state(route, jax_run):
    """Both engines step frame SNAP+1 from the same mid-run state (handed
    over through ``state_from_numpy``) and agree to 1e-5."""
    scans, _ = route
    cfg = port_config(jax_run["cfg"])
    before, after = jax_run["snaps"][SNAP], jax_run["snaps"][SNAP + 1]
    st = pipeline.state_from_numpy(before, "cpu")
    eng = pipeline.SlamEngine(cfg, "cpu")
    raw, count = eng.pad_scan(scans[SNAP + 1])
    pipeline.step(st, cfg, raw, count, SNAP + 1, eng._nn1)
    f = SNAP + 1
    np.testing.assert_allclose(st.poses[f].numpy(), after["poses"][f], atol=1e-5)
    np.testing.assert_allclose(st.prev_delta.numpy(), after["prev_delta"],
                               atol=1e-5)
    np.testing.assert_allclose(st.pg.odom_rel[f].numpy(),
                               after["pg"]["odom_rel"][f], atol=1e-5)
    np.testing.assert_allclose(st.icp_error[f].numpy(), after["icp_error"][f],
                               rtol=1e-5)
    assert int(st.icp_iters[f]) == int(after["icp_iters"][f])
    np.testing.assert_array_equal(st.db.desc[f].numpy(), after["db"]["desc"][f])
    np.testing.assert_array_equal(st.db.clouds[f].numpy(),
                                  after["db"]["clouds"][f])
    np.testing.assert_array_equal(st.grid.numpy(), after["grid"])
    n_t, n_j = st.prev_normals.numpy(), after["prev_normals"]
    m = after["prev"]["mask"]
    cos = np.clip(np.abs(np.sum(n_t * n_j, axis=1)), 0, 1)[m]
    assert np.percentile(np.degrees(np.arccos(cos)), 95) < 0.5


def test_normals_of_route_scans_match_port_engine(route):
    """The engine's normal estimator is the adaptive one with the config's
    knobs (probe stride 2, slab window)."""
    scans, _ = route
    cfg = config.fast_mode(config.tiny_config(**TINY)).replace(**KNOBS)
    pts = np.zeros((2048, 3), np.float32)
    pts[: len(scans[3])] = scans[3]
    mask = np.arange(2048) < len(scans[3])
    a = pipeline.normals_fn(cfg)(torch.from_numpy(pts), torch.from_numpy(mask))
    b = estimate_normals_adaptive(torch.from_numpy(pts), torch.from_numpy(mask),
                                  r_min=1.2, window=1024, probe_stride=2)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
