"""The port's batched engine in ``default`` mode against the JAX package's
``BatchedSlamEngine``, and a JAX batched mid-run state carried across, at
tiny shapes on the CPU.

Two lanes of different sequences (40 raw scans each, on one route whose
last eighth revisits the start, through two different worlds) go through
the device voxelizer, ICP on the exact 1-NN and the batched engine's mid-run
optimize: gated on ``pending_optimize`` and over the whole graph, which the
port copies from the JAX batched engine (it is not the single engine's
optimize-on-find). Both engines must accept the same loops per lane and give
trajectories within 5e-3 m, the tolerance of ``test_torch_default_mode.py``,
before and after finalize. Then the port starts from the JAX engine's state
after frame ``SNAP`` (leaves with a leading lane axis,
``batched_state_from_numpy``) and must go on as the JAX engine did.

``pending_optimize`` is not compared: a chunk that reaches the optimum in
float32 converges only if one more step happens to round to a lower cost,
and that differs between the engines (ROADMAP.md, Queue 3). Odometry and
verification register 1,024-point samples of the 2,048-point clouds, which
halves the plain 1-NN's time here and finds the same loops."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from lidar_slam_tpu import config as jconfig
from lidar_slam_tpu.parallel import BatchedSlamEngine as JBatchedSlamEngine
from lidar_slam_tpu_torch import config
from lidar_slam_tpu_torch.parallel import BatchedSlamEngine, batched_state_from_numpy
from lidar_slam_tpu_torch.utils.dataset import (
    generate_trajectory,
    generate_world,
    render_scan,
    route_half_for,
)

torch.set_num_threads(2)

N_FRAMES = 40
SNAP = 33  # the port starts from the JAX state after this frame
SHAPES = dict(max_raw_points=16384, max_points=2048, lc_cloud_points=0,
              max_frames=48, max_loop_factors=16)
# 8 LM iterations per chunk, as in test_torch_default_mode.py: at 3 the
# chunk's converged flag compares rounding, not logic
PG = dict(max_iterations=25, cg_iterations=60, inline_max_iterations=8)
SAMPLE = 1024


def _sampled(cfg):
    return cfg.replace(
        icp=dataclasses.replace(cfg.icp, sample_points=SAMPLE),
        lc=dataclasses.replace(cfg.lc, verify_sample=SAMPLE))


def _configs():
    jcfg = _sampled(jconfig.tiny_config(pg=jconfig.PoseGraphConfig(**PG), **SHAPES))
    cfg = _sampled(config.apply_mode(
        config.tiny_config(pg=config.PoseGraphConfig(**PG), **SHAPES), "default"))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.optimize_midrun and not cfg.host_voxelize
    return jcfg, cfg


def _tree(x):
    """JAX state pytree -> nested dicts of numpy leaves."""
    if hasattr(x, "_asdict"):
        return {k: _tree(v) for k, v in x._asdict().items()}
    return np.asarray(x)


def _lane_pairs(pg_state, b):
    n = int(np.asarray(pg_state.n_loops)[b])
    return list(zip(np.asarray(pg_state.loop_to)[b, :n].tolist(),
                    np.asarray(pg_state.loop_from)[b, :n].tolist()))


@pytest.fixture(scope="module")
def seqs():
    half = route_half_for(N_FRAMES)
    gt = generate_trajectory(N_FRAMES, half=half)
    out = []
    for seed in (0, 1):
        world = generate_world(seed, route_half=half)
        rng = np.random.default_rng(seed)
        out.append([render_scan(world, gt[i], rng, max_range=15.0,
                                max_points=12000) for i in range(N_FRAMES)])
    return out


@pytest.fixture(scope="module")
def jax_run(seqs):
    jcfg, _ = _configs()
    eng = JBatchedSlamEngine(jcfg, batch=2, optimize_midrun=jcfg.optimize_midrun)
    snap = None
    for f, pair in enumerate(zip(*seqs)):
        eng.push_scans(list(pair))
        if f == SNAP:
            snap = _tree(jax.tree.map(np.asarray, eng.state))
    odo = eng.trajectories()
    eng.finalize()
    st = eng.state
    keys = ("loop_count", "verify_fired", "verify_fine_fired", "verify_bound_hit")
    return dict(snap=snap, odo=odo, final=eng.trajectories(),
                counters={k: np.asarray(getattr(st, k)).tolist() for k in keys},
                pairs=[_lane_pairs(st.pg, b) for b in range(2)])


def _port_metrics(eng):
    keys = ("loop_count", "verify_fired", "verify_fine_fired", "verify_bound_hit")
    return {k: [m[k] for m in eng.metrics()] for k in keys}


@pytest.fixture(scope="module")
def port_run(seqs):
    _, cfg = _configs()
    eng = BatchedSlamEngine(cfg, 2, "cpu", optimize_midrun=cfg.optimize_midrun)
    for pair in zip(*seqs):
        eng.push_scans(list(pair))
    odo = eng.trajectories()
    eng.finalize()
    return dict(odo=odo, final=eng.trajectories(),
                counters=_port_metrics(eng), pairs=eng.loop_pairs())


def test_default_mode_lanes_accept_what_jax_accepts(jax_run, port_run):
    assert all(n >= 1 for n in port_run["counters"]["loop_count"])
    assert port_run["pairs"] == jax_run["pairs"]
    assert port_run["counters"] == jax_run["counters"]


def test_default_mode_trajectories_match_jax(jax_run, port_run):
    for stage in ("odo", "final"):
        a, b = port_run[stage], jax_run[stage]
        assert a.shape == b.shape == (2, N_FRAMES, 4, 4)
        err = np.abs(a[..., :3, 3] - b[..., :3, 3]).max()
        assert err < 5e-3, (stage, err)
    assert np.abs(port_run["final"][0] - port_run["final"][1]).max() > 1e-2


def test_goes_on_from_a_jax_batched_state(jax_run, seqs):
    """``batched_state_from_numpy`` of the JAX engine's state after frame
    SNAP: the port pushes the remaining frames (loop ticks included) and
    finalizes, and must end where the JAX engine ended."""
    _, cfg = _configs()
    eng = BatchedSlamEngine(cfg, 2, "cpu", optimize_midrun=cfg.optimize_midrun)
    eng.state = batched_state_from_numpy(jax_run["snap"], "cpu")
    eng._frame = SNAP + 1
    assert eng.state.n_poses == [SNAP + 1] * 2
    assert eng.state.db.clouds.shape[:2] == (2, SHAPES["max_frames"])
    assert isinstance(eng.state.loop_count, list)
    for b, lane in enumerate(eng.state.poses):
        np.testing.assert_array_equal(lane.numpy(), jax_run["snap"]["poses"][b])
    for pair in list(zip(*seqs))[SNAP + 1:]:
        eng.push_scans(list(pair))
    eng.finalize()
    assert eng.loop_pairs() == jax_run["pairs"]
    assert _port_metrics(eng) == jax_run["counters"]
    err = np.abs(eng.trajectories()[..., :3, 3] - jax_run["final"][..., :3, 3])
    assert err.max() < 5e-3, err.max()

