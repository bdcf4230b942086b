"""The engines with the pose graph's CG solver, port against the JAX
package, at tiny shapes on the CPU.

``PoseGraphConfig(solver="cg")`` reaches the engines in three places: the
optimize-on-find chunk of ``SlamEngine``, the gated chunk of
``BatchedSlamEngine``, and finalize (``pipeline.finalize_state``: float32
chunks of the configured solver, then the float64 Woodbury backstop). The
engine run is ``tests/test_torch_default_mode.py``'s: the same 40 raw scans
through default mode, held to that file's tolerance.
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

from lidar_slam_tpu import config as jconfig
from lidar_slam_tpu.models.pipeline import SlamEngine as JSlamEngine
from lidar_slam_tpu_torch import config
from lidar_slam_tpu_torch.models import pipeline
from lidar_slam_tpu_torch.models import pose_graph as pg
from lidar_slam_tpu_torch.parallel import batched
from lidar_slam_tpu_torch.utils.dataset import (
    generate_trajectory,
    generate_world,
    render_scan,
    route_half_for,
)

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_models import _graph  # noqa: E402

torch.set_num_threads(2)

N_FRAMES = 40
SHAPES = dict(max_raw_points=16384, max_points=2048, lc_cloud_points=0,
              max_frames=48, max_loop_factors=16)
# test_torch_default_mode.py's LM budget, with the CG solver
PG = dict(max_iterations=25, cg_iterations=60, inline_max_iterations=8,
          solver="cg")
STAGES = ("flush", "optimize", "rebuild")


def _configs(**pg_kw):
    pgc = dict(PG, **pg_kw)
    jcfg = jconfig.tiny_config(pg=jconfig.PoseGraphConfig(**pgc), **SHAPES)
    cfg = config.apply_mode(
        config.tiny_config(pg=config.PoseGraphConfig(**pgc), **SHAPES), "default")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.optimize_midrun
    return jcfg, cfg


@pytest.fixture(scope="module")
def scans():
    half = route_half_for(N_FRAMES)
    world = generate_world(0, route_half=half)
    gt = generate_trajectory(N_FRAMES, half=half)
    rng = np.random.default_rng(0)
    return [render_scan(world, gt[i], rng, max_range=15.0, max_points=12000)
            for i in range(N_FRAMES)]


@pytest.fixture(scope="module")
def runs(scans):
    """Both engines over the scans with the CG solver, each finalize timed;
    the port's optimize-on-find chunks are recorded as they run."""
    jcfg, cfg = _configs()
    chunks = []
    orig = pipeline.optimize_on_find

    def spy(state, config):
        res = orig(state, config)
        chunks.append(res)
        return res

    pipeline.optimize_on_find = spy
    try:
        eng = pipeline.SlamEngine(cfg, "cpu")
        for s in scans:
            eng.push_scan(s)
    finally:
        pipeline.optimize_on_find = orig
    port = dict(odo=eng.trajectory(), pending=eng.state.pending_optimize,
                timing={}, chunks=chunks)
    port["res"] = eng.finalize(timing=port["timing"])
    port.update(final=eng.trajectory(), metrics=eng.metrics(),
                pairs=eng.loop_pairs())

    jeng = JSlamEngine(jcfg)
    for s in scans:
        jeng.push_scan(s)
    jax_ = dict(odo=jeng.trajectory(), pending=bool(jeng.state.pending_optimize),
                timing={})
    jeng.finalize(timing=jax_["timing"])
    st = jeng.state
    n = int(st.pg.n_loops)
    jax_.update(final=jeng.trajectory(), metrics=jeng.metrics(),
                pairs=list(zip(np.asarray(st.pg.loop_to[:n]).tolist(),
                               np.asarray(st.pg.loop_from[:n]).tolist())))
    return port, jax_


def test_cg_engine_accept_sets_identical(runs):
    port, jax_ = runs
    assert port["metrics"]["loop_count"] >= 1
    assert port["pairs"] == jax_["pairs"]
    for key in ("loop_count", "verify_fired", "verify_fine_fired",
                "verify_bound_hit", "loops_dropped"):
        assert port["metrics"][key] == jax_["metrics"][key], key
    assert port["pending"] == jax_["pending"]


def test_cg_engine_trajectory_matches_jax(runs):
    """Before and after finalize, within test_torch_default_mode.py's 5e-3
    m; the optimize-on-find chunks ran the CG solver."""
    port, jax_ = runs
    for stage in ("odo", "final"):
        a, b = port[stage], jax_[stage]
        assert a.shape == b.shape == (N_FRAMES, 4, 4)
        assert np.isfinite(a).all()
        err = np.abs(a[:, :3, 3] - b[:, :3, 3]).max()
        assert err < 5e-3, (stage, err)
    assert port["chunks"] and all(r.cg_matvecs > 0 for r in port["chunks"])


def test_cg_engine_finalize_timing(runs):
    """``SlamEngine.finalize(timing=)`` fills the JAX engine's stage keys
    and the ladder's: the float32 chunks (``f32_s``/``f32_it``, as JAX) and,
    where they stop unconverged, ``f64_s``/``f64_it`` (JAX's
    ``dd_*``/``host_*``). Whether the float32 chunks end converged is not
    compared: on this route the two packages' chunks reach the same poses
    (``test_cg_engine_trajectory_matches_jax``), and the relative-decrease
    test then flips with float32 rounding (the port's backstop ran, JAX's
    did not)."""
    port, jax_ = runs
    t, tj = port["timing"], jax_["timing"]
    for key in STAGES + ("f32_s", "f32_it"):
        assert key in t and key in tj, key
        assert t[key] >= 0
    assert t["f32_it"] > 0
    assert set(t) - set(STAGES) <= {"f32_s", "f32_it", "f64_s", "f64_it"}
    res = port["res"]
    if "f64_it" in t:
        assert res.iterations == t["f32_it"] + t["f64_it"]
    else:
        assert res.converged and res.iterations == t["f32_it"]
    assert port["res"].cg_matvecs > 0


def test_default_finalize_timing(scans):
    """The default config's finalize (one float64 Woodbury LM) fills the
    stage keys and ``f64_s``/``f64_it``, and no ``f32_*``."""
    _, cfg = _configs(solver="woodbury")
    eng = pipeline.SlamEngine(cfg, "cpu")
    for s in scans[:6]:
        eng.push_scan(s)
    timing = {}
    res = eng.finalize(timing=timing)
    assert set(timing) == set(STAGES) | {"f64_s", "f64_it"}
    assert timing["f64_it"] == res.iterations > 0
    assert res.cg_matvecs == 0
    assert all(timing[k] >= 0 for k in STAGES)


def _lane(graph, cfg):
    """A one-lane batched state holding ``graph`` (its poses as the
    engine's), with an optimization pending."""
    s = pipeline.init_state(cfg, "cpu")
    s.pg = graph.replace(**{f.name: getattr(graph, f.name).clone()
                            for f in dataclasses.fields(graph)
                            if isinstance(getattr(graph, f.name), torch.Tensor)})
    s.poses = graph.poses.clone()
    s.n_poses = graph.n_poses
    s.pending_optimize = True
    return pipeline.stack_states([s])


@pytest.mark.parametrize("solver", ["cg", "woodbury"])
def test_batched_chunk_and_finalize_follow_solver(solver):
    """``BatchedSlamEngine``'s gated mid-run chunk is ``pose_graph.optimize``
    over the lane's whole graph with the configured solver, and its
    finalize ``finalize_state``: for CG, ``optimize_chunked`` with
    ``inline_max_iterations`` chunks; for Woodbury, the float64 LM. The
    lane's poses equal those calls' bit for bit."""
    gt, _, st = _graph(60, 3, seed=3)
    cfg = config.tiny_config(max_frames=68, max_loop_factors=16,
                             pg=config.PoseGraphConfig(**dict(PG, solver=solver)))
    state = _lane(st, cfg)
    n = 60

    batched.gated_optimize(state, cfg)
    want = pg.optimize(st, cfg.pg, max_iterations=cfg.pg.inline_max_iterations)
    assert (want.cg_matvecs > 0) == (solver == "cg")
    torch.testing.assert_close(state.poses[0, :n], want.poses[:n], rtol=0, atol=0)
    assert state.pending_optimize[0] == (not want.converged)

    graph = st.replace(poses=state.poses[0].clone())
    (res,) = batched.make_batched_fns(cfg)[4](state)
    if solver == "cg":
        ref = pg.optimize_chunked(graph, cfg.pg,
                                  chunk=cfg.pg.inline_max_iterations)
    else:
        ref = pg.optimize(pg.compact_loops(graph).to(torch.float64), cfg.pg)
    assert res.iterations == ref.iterations
    torch.testing.assert_close(state.poses[0, :n],
                               ref.poses[:n].to(torch.float32), rtol=0, atol=0)
    assert state.pending_optimize[0] is False
