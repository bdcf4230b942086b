"""The slice as a whole in ``default`` mode, and checkpoints across the two
packages, at tiny shapes on the CPU.

Both engines run the same 40 raw scans (a route whose last eighth revisits
the start) through the device voxelizer, full-density ICP on the exact 1-NN
(the port's K2 in its plain version, JAX's streamed search) and
optimize-on-find. Each writes a checkpoint after frame ``CKPT``; each
checkpoint is then loaded by the OTHER engine, which must go on as the
writer did. The last scan is a degenerate one: 30 raw points in two voxels,
so its prepared cloud is below ``min_points`` although its raw count is not.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from lidar_slam_tpu import config as jconfig
from lidar_slam_tpu.models.pipeline import SlamEngine as JSlamEngine
from lidar_slam_tpu_torch import config
from lidar_slam_tpu_torch.models import pipeline
from lidar_slam_tpu_torch.utils.dataset import (
    generate_trajectory,
    generate_world,
    render_scan,
    route_half_for,
)

torch.set_num_threads(2)

N_FRAMES = 40
CKPT = 20   # checkpoints are written after this frame was pushed
AHEAD = 2   # frames pushed after a cross-package load
SHAPES = dict(max_raw_points=16384, max_points=2048, lc_cloud_points=0,
              max_frames=48, max_loop_factors=16)
# 8 LM iterations per optimize-on-find chunk: at the default 3 the chunk of
# this route stops exactly where the relative-decrease test flips with the
# last bit, and ``pending_optimize`` would compare rounding, not logic
PG = dict(max_iterations=25, cg_iterations=60, inline_max_iterations=8)


def _configs():
    jcfg = jconfig.tiny_config(pg=jconfig.PoseGraphConfig(**PG), **SHAPES)
    cfg = config.apply_mode(
        config.tiny_config(pg=config.PoseGraphConfig(**PG), **SHAPES), "default")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.optimize_midrun and not cfg.host_voxelize
    assert cfg.knn_backend == "auto" and cfg.icp.sample_points == 0
    return jcfg, cfg


def _tree(x):
    """JAX state pytree -> nested dicts of numpy leaves."""
    if hasattr(x, "_asdict"):
        return {k: _tree(v) for k, v in x._asdict().items()}
    return np.asarray(x)


def _port_tree(state):
    """The port's state -> the same nested dicts."""
    out = {}
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if dataclasses.is_dataclass(v):
            out[f.name] = _port_tree(v)
        else:
            out[f.name] = v.numpy().copy() if isinstance(v, torch.Tensor) else v
    return out


@pytest.fixture(scope="module")
def scans():
    half = route_half_for(N_FRAMES)
    world = generate_world(0, route_half=half)
    gt = generate_trajectory(N_FRAMES, half=half)
    rng = np.random.default_rng(0)
    raw = [render_scan(world, gt[i], rng, max_range=15.0, max_points=12000)
           for i in range(N_FRAMES)]
    few = np.array([[2.1, 3.1, 0.1], [4.1, -1.4, 0.6]], np.float32)
    raw[-1] = (np.repeat(few, 15, axis=0)
               + rng.uniform(0, 0.3, (30, 3)).astype(np.float32))
    return raw


@pytest.fixture(scope="module")
def port_run(scans, tmp_path_factory):
    _, cfg = _configs()
    ckpt = str(tmp_path_factory.mktemp("port") / "checkpoint.npz")
    eng = pipeline.SlamEngine(cfg, "cpu")
    snaps, infos = {}, []
    for f, s in enumerate(scans):
        info = eng.push_scan(s, sync_info=True)
        if info:
            infos.append(info)
        if f == CKPT:
            eng.save_checkpoint(ckpt)
        if CKPT < f <= CKPT + AHEAD:
            snaps[f] = _port_tree(eng.state)
    odo, pending = eng.trajectory(), eng.state.pending_optimize
    eng.finalize()
    return dict(cfg=cfg, ckpt=ckpt, eng=eng, odo=odo, pending=pending,
                final=eng.trajectory(), metrics=eng.metrics(),
                pairs=eng.loop_pairs(), snaps=snaps, infos=infos)


@pytest.fixture(scope="module")
def jax_run(scans, port_run, tmp_path_factory):
    jcfg, _ = _configs()
    ckpt = str(tmp_path_factory.mktemp("jax") / "checkpoint.npz")
    eng = JSlamEngine(jcfg)
    snaps = {}
    for f, s in enumerate(scans):
        eng.push_scan(s)
        if f == CKPT:
            eng.save_checkpoint(ckpt)
        if CKPT < f <= CKPT + AHEAD:
            snaps[f] = _tree(jax.tree.map(np.asarray, eng.state))
    odo, pending = eng.trajectory(), bool(eng.state.pending_optimize)
    eng.finalize()
    st = eng.state
    n = int(st.pg.n_loops)
    out = dict(cfg=jcfg, ckpt=ckpt, odo=odo, pending=pending,
               final=eng.trajectory(), metrics=eng.metrics(), snaps=snaps,
               map=eng.global_map(), map100=eng.global_map(100),
               grid=eng.occupancy().copy(),
               pairs=list(zip(np.asarray(st.pg.loop_to[:n]).tolist(),
                              np.asarray(st.pg.loop_from[:n]).tolist())))
    # the same engine (its compiled programs) goes on from the PORT's
    # checkpoint
    eng.reset()
    eng.load_checkpoint(port_run["ckpt"])
    assert eng.n_frames == CKPT + 1
    for f in range(CKPT + 1, CKPT + 1 + AHEAD):
        eng.push_scan(scans[f])
    out["from_port"] = _tree(jax.tree.map(np.asarray, eng.state))
    # ... and builds the map of its OWN checkpoint's state, which the port
    # then builds from the same file
    eng.reset()
    eng.load_checkpoint(ckpt)
    out["ckpt_map"] = eng.global_map()
    out["ckpt_map100"] = eng.global_map(100)
    return out


def test_default_mode_accept_sets_identical(jax_run, port_run):
    assert port_run["metrics"]["loop_count"] >= 1
    assert port_run["pairs"] == jax_run["pairs"]
    for key in ("loop_count", "verify_fired", "verify_fine_fired",
                "verify_bound_hit", "loops_dropped"):
        assert port_run["metrics"][key] == jax_run["metrics"][key], key
    assert port_run["pending"] == jax_run["pending"]
    # push_scan(sync_info=True) reports each accepting tick
    got = [(i["query"], m) for i in port_run["infos"] for m in i["matches"]]
    assert got == port_run["pairs"]
    assert sum(i["found"] for i in port_run["infos"]) == len(got)


def test_default_mode_trajectory_matches_jax(jax_run, port_run):
    """Before and after finalize, within 5e-3 m; the poses before finalize
    already carry the optimize-on-find corrections."""
    for stage in ("odo", "final"):
        a, b = port_run[stage], jax_run[stage]
        assert a.shape == b.shape == (N_FRAMES, 4, 4)
        err = np.abs(a[:, :3, 3] - b[:, :3, 3]).max()
        assert err < 5e-3, (stage, err)
    g = port_run["eng"].state.pg
    chain = g.poses[:N_FRAMES].numpy()
    assert np.abs(port_run["odo"][:, :3, 3] - chain[:, :3, 3]).max() > 1e-3


def test_frame_npts_is_the_prepared_count(jax_run, port_run):
    """``frame_npts`` is the voxel count, and it decides the skip: the last
    scan has 30 raw points (>= min_points) in two voxels (< min_points)."""
    n_t, n_j = port_run["metrics"]["frame_npts"], jax_run["metrics"]["frame_npts"]
    np.testing.assert_array_equal(n_t, n_j)
    assert n_t[-1] == 2 < port_run["cfg"].min_points < 30
    st = port_run["eng"].state
    assert not bool(st.pg.odom_valid[N_FRAMES - 1])
    assert not bool(st.db.in_db[N_FRAMES - 1])
    np.testing.assert_array_equal(port_run["odo"][-1], port_run["odo"][-2])


def test_checkpoint_files_have_the_same_entries(jax_run, port_run):
    with np.load(port_run["ckpt"]) as a, np.load(jax_run["ckpt"]) as b:
        assert sorted(a.files) == sorted(b.files)
        assert "__extra__/frame" in a.files and "pg/loop_from" in a.files
        for k in a.files:
            assert a[k].shape == b[k].shape, k
            assert a[k].dtype == b[k].dtype, k
        assert int(a["__extra__/frame"]) == int(b["__extra__/frame"]) == CKPT + 1


def _assert_step_equal(got, want, frames):
    """Two states after the same frames, as ``test_one_step_from_jax_state``
    holds them: 1e-5."""
    for f in frames:
        np.testing.assert_allclose(got["poses"][f], want["poses"][f], atol=1e-5)
        np.testing.assert_allclose(got["pg"]["odom_rel"][f],
                                   want["pg"]["odom_rel"][f], atol=1e-5)
        np.testing.assert_allclose(got["icp_error"][f], want["icp_error"][f],
                                   rtol=1e-5)
        assert int(got["icp_iters"][f]) == int(want["icp_iters"][f])
        assert int(got["frame_npts"][f]) == int(want["frame_npts"][f])
        np.testing.assert_allclose(got["db"]["clouds"][f], want["db"]["clouds"][f],
                                   atol=1e-5)
        np.testing.assert_allclose(got["db"]["desc"][f], want["db"]["desc"][f],
                                   atol=1e-5)
    np.testing.assert_allclose(got["prev_delta"], want["prev_delta"], atol=1e-5)
    np.testing.assert_array_equal(got["grid"], want["grid"])
    assert int(got["n_poses"]) == int(want["n_poses"])


def test_jax_checkpoint_loads_into_the_port(scans, jax_run, port_run):
    eng = pipeline.SlamEngine(port_run["cfg"], "cpu")
    eng.load_checkpoint(jax_run["ckpt"])
    assert eng.n_frames == CKPT + 1
    assert eng.state.pg.loop_from.dtype == torch.int64
    frames = range(CKPT + 1, CKPT + 1 + AHEAD)
    for f in frames:
        eng.push_scan(scans[f])
    _assert_step_equal(_port_tree(eng.state), jax_run["snaps"][CKPT + AHEAD],
                       frames)


def test_port_checkpoint_loads_into_jax(jax_run, port_run):
    frames = range(CKPT + 1, CKPT + 1 + AHEAD)
    _assert_step_equal(jax_run["from_port"], port_run["snaps"][CKPT + AHEAD],
                       frames)


def test_port_resume_is_bit_exact(scans, port_run):
    eng = pipeline.SlamEngine(port_run["cfg"], "cpu")
    eng.load_checkpoint(port_run["ckpt"])
    for f in range(eng.n_frames, N_FRAMES):
        eng.push_scan(scans[f])
    np.testing.assert_array_equal(eng.trajectory(), port_run["odo"])
    eng.finalize()
    np.testing.assert_array_equal(eng.trajectory(), port_run["final"])
    np.testing.assert_array_equal(eng.occupancy(),
                                  port_run["eng"].occupancy())
    assert eng.loop_pairs() == port_run["pairs"]


def test_wrong_config_load_raises_as_jax_does(jax_run, port_run, tmp_path):
    small = port_run["cfg"].replace(max_frames=32)
    with pytest.raises(ValueError, match="shape .* != template"):
        pipeline.SlamEngine(small, "cpu").load_checkpoint(port_run["ckpt"])
    with pytest.raises(ValueError, match="shape .* != template"):
        JSlamEngine(jax_run["cfg"].replace(max_frames=32)).load_checkpoint(
            port_run["ckpt"])
    with np.load(port_run["ckpt"]) as data:
        items = {k: data[k] for k in data.files if k != "db/desc"}
    cut = str(tmp_path / "cut.npz")
    np.savez(cut, **items)
    with pytest.raises(KeyError, match="db/desc"):
        pipeline.SlamEngine(port_run["cfg"], "cpu").load_checkpoint(cut)


def test_global_map_and_occupancy_match_jax_engine(jax_run, port_run):
    """``global_map`` (whole, and subsampled to 100 points per frame by the
    strided prefix) and ``occupancy`` beside the JAX engine's.

    From one shared state (the JAX checkpoint loaded by both engines) the
    maps hold the same rows in the same order, to 1e-5 m (the pose
    transform's f32 rounding). After the two full runs they hold the same
    number of rows (the masks are equal), within 1e-2 m: the final poses
    differ by up to 5e-3 m, and by a rotation that acts on points up to
    15 m away."""
    eng = pipeline.SlamEngine(port_run["cfg"], "cpu")
    eng.load_checkpoint(jax_run["ckpt"])
    for ppf, key in ((None, "ckpt_map"), (100, "ckpt_map100")):
        got, want = eng.global_map(max_points_per_frame=ppf), jax_run[key]
        assert got.dtype == np.float32 and got.shape == want.shape
        assert len(got) > 0 and got.shape[1] == 3
        np.testing.assert_allclose(got, want, atol=1e-5)
    assert len(jax_run["ckpt_map100"]) <= 100 * (CKPT + 1) < len(jax_run["ckpt_map"])

    eng, st = port_run["eng"], port_run["eng"].state
    for ppf, key in ((None, "map"), (100, "map100")):
        got, want = eng.global_map(max_points_per_frame=ppf), jax_run[key]
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=1e-2)
    # the rebuilt grid: cells at f32 cell boundaries may flip between the
    # two (millimetre pose differences), nothing else
    grid = eng.occupancy()
    assert grid.dtype == np.uint8 and grid.shape == jax_run["grid"].shape
    diff = int((grid != jax_run["grid"]).sum())
    assert diff <= 0.01 * int((jax_run["grid"] > 0).sum()) + 2, diff
    grid[:] = 0  # a copy: the state is untouched
    assert int(st.grid.sum()) > 0
