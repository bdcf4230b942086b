"""The batched engine (``lidar_slam_tpu_torch.parallel``) and K1 over lanes,
at tiny shapes on the CPU.

- K1's plain version over 3 lanes equals three one-lane calls bit for bit,
  and the JAX Pallas kernel under ``jax.vmap`` (interpret mode).
- ``BatchedSlamEngine`` on 2 lanes of DIFFERENT sequences (two worlds on one
  40-frame route whose last eighth revisits the start) equals the port's
  single ``SlamEngine`` on each lane in fast mode, where the batched and the
  single engine have the same semantics (no mid-run optimize): loops and
  counters equal, poses within 1e-4 m, as ``tests/test_checkpoint_batched.py``
  holds the JAX engines.
- The resident run equals the streaming one, and ``reset()`` reruns it
  identically.

The batched engine in default mode, against the JAX batched engine, is in
``test_torch_batched_default.py``."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidar_slam_tpu.ops import knn_pallas
from lidar_slam_tpu_torch import config
from lidar_slam_tpu_torch.models import pipeline
from lidar_slam_tpu_torch.ops import knn_cuda
from lidar_slam_tpu_torch.ops.icp import icp_point_to_plane
from lidar_slam_tpu_torch.parallel import BatchedSlamEngine, make_mesh
from lidar_slam_tpu_torch.types import PointCloud
from lidar_slam_tpu_torch.utils.dataset import (
    generate_trajectory,
    generate_world,
    render_scan,
    route_half_for,
)
from lidar_slam_tpu_torch.utils.native import voxel_downsample_host

torch.set_num_threads(2)

N_FRAMES = 40
SHORT = 8  # frames of the resident and reset runs
TINY = dict(max_raw_points=2048, max_points=2048, lc_cloud_points=0,
            max_frames=48, max_loop_factors=16)
# slab and normal windows of 1024 of the 2048 points, as in
# ``test_torch_pipeline.py``: narrower ones lose track
KNOBS = dict(host_voxelize=True, slab_window=1024, normal_window=1024,
             dispatch_block=0)


def _t(x):
    return torch.from_numpy(np.array(x))


def _slab_lanes(rng, lanes=3, S=300, T=2000):
    """x-sorted targets with normals and x-sorted sources near them, one
    world per lane; a masked tail on lane 1."""
    tgt = rng.uniform(-30, 30, (lanes, T, 3)).astype(np.float32)
    tgt = np.take_along_axis(tgt, np.argsort(tgt[..., 0], axis=1)[..., None], 1)
    src = tgt[:, rng.choice(T, S, replace=False)] + rng.normal(
        0, 0.2, (lanes, S, 3)).astype(np.float32)
    src = np.take_along_axis(src, np.argsort(src[..., 0], axis=1)[..., None], 1)
    nrm = rng.normal(size=(lanes, T, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    mask = np.ones((lanes, T), bool)
    mask[1, T - 300:] = False
    return src, tgt, mask, nrm


def test_k1_plain_over_lanes_equals_one_lane_and_jax_vmap(rng):
    src, tgt, mask, nrm = _slab_lanes(rng)
    kw = dict(ts=128, window=1024)
    lanes = knn_cuda.match_slab_torch(_t(src), _t(tgt), _t(mask), _t(nrm), **kw)
    idx_l, d2_l = knn_cuda.nn1_slab_torch(_t(src), _t(tgt), _t(mask), **kw)
    jfn = jax.vmap(functools.partial(knn_pallas.match_slab_pallas, interpret=True,
                                     **kw))
    q_j, n_j, d2_j = jfn(*(jnp.asarray(x) for x in (src, tgt, mask, nrm)))
    for b in range(src.shape[0]):
        one = knn_cuda.match_slab_torch(_t(src[b]), _t(tgt[b]), _t(mask[b]),
                                        _t(nrm[b]), **kw)
        for got, want in zip(lanes, one):
            torch.testing.assert_close(got[b], want, rtol=0, atol=0)
        idx_1, d2_1 = knn_cuda.nn1_slab_torch(_t(src[b]), _t(tgt[b]),
                                              _t(mask[b]), **kw)
        torch.testing.assert_close(idx_l[b], idx_1, rtol=0, atol=0)
        torch.testing.assert_close(d2_l[b], d2_1, rtol=0, atol=0)
    np.testing.assert_array_equal(lanes[0].numpy(), np.asarray(q_j))
    np.testing.assert_array_equal(lanes[1].numpy(), np.asarray(n_j))
    np.testing.assert_allclose(lanes[2].numpy(), np.asarray(d2_j), rtol=1e-6,
                               atol=1e-6)


def test_k1_index_and_starts_per_lane(rng):
    """Each lane's LUT, scale and window starts are the one-lane ones; a
    B-lane query answers each lane as a one-lane index would."""
    src, tgt, mask, nrm = _slab_lanes(rng)
    index = knn_cuda._build_slab_index(_t(tgt), _t(mask), _t(nrm))
    out = knn_cuda._slab_query(_t(src), index, 128, 1024, 3.0)
    for b in range(src.shape[0]):
        one = knn_cuda._build_slab_index(_t(tgt[b]), _t(mask[b]), _t(nrm[b]))
        for f in ("tgt8", "lut", "lo", "inv_h"):
            torch.testing.assert_close(getattr(index, f)[b],
                                       getattr(one, f)[0], rtol=0, atol=0)
        for got, want in zip(out, knn_cuda._slab_query(_t(src[b]), one, 128,
                                                       1024, 3.0)):
            torch.testing.assert_close(got[b], want, rtol=0, atol=0)


def test_icp_takes_lanes_with_the_fused_backend(rng):
    """ops/icp.py with the K1 backend on 3 lanes: each lane's result is the
    one-lane ICP's (the batch freezes converged lanes)."""
    src, tgt, mask, nrm = _slab_lanes(rng, S=600)
    cfg = config.ICPConfig(max_iterations=8, tolerance=1e-5)
    be = knn_cuda.SlabBackend(ts=128, window=1024)
    res = icp_point_to_plane(PointCloud(_t(src), torch.ones(src.shape[:2], dtype=torch.bool)),
                             PointCloud(_t(tgt), _t(mask)), _t(nrm), cfg,
                             nn1_fn=be)
    for b in range(src.shape[0]):
        one = icp_point_to_plane(
            PointCloud(_t(src[b]), torch.ones(src.shape[1], dtype=torch.bool)),
            PointCloud(_t(tgt[b]), _t(mask[b])), _t(nrm[b]), cfg, nn1_fn=be)
        assert int(res.num_iterations[b]) == int(one.num_iterations)
        assert bool(res.converged[b]) == bool(one.converged)
        torch.testing.assert_close(res.transformation[b], one.transformation,
                                   rtol=0, atol=1e-6)


def test_normal_equations_round_the_same_for_any_lane_count(rng):
    """One Gauss-Newton step of a lane is bit-identical whether the lane is
    alone, unbatched, or one of 2 or 12 (each lane's normal equations are
    their own 2-D product: a batched matmul may take another plan, and so
    another rounding, for another batch size)."""
    from lidar_slam_tpu_torch.ops.icp import solve_point_to_plane

    src = rng.normal(0, 20, (12, 4096, 3)).astype(np.float32)
    tgt = src + rng.normal(0, 0.05, src.shape).astype(np.float32)
    nrm = rng.normal(size=src.shape).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    w = rng.uniform(size=src.shape[:2]) < 0.9
    args = [_t(x) for x in (src, tgt, nrm, w)]
    for B in (12, 2):
        lanes = solve_point_to_plane(*(a[:B] for a in args))
        for b in range(B):
            one = solve_point_to_plane(*(a[b : b + 1] for a in args))[0]
            flat = solve_point_to_plane(*(a[b] for a in args))
            assert torch.equal(lanes[b], one) and torch.equal(one, flat)


@pytest.mark.parametrize("S", [4096, 32768])
def test_plane_error_rounds_the_same_for_any_lane_count(rng, S):
    """A lane's plane error (the ICP's convergence test) is bit-identical
    alone, unbatched, and as one of 2 or 6 lanes: each lane is its own 1-D
    sum (``ops/icp._lane_sum``)."""
    from lidar_slam_tpu_torch.ops.icp import _plane_error

    cur = rng.normal(0, 20, (6, S, 3)).astype(np.float32)
    matched = cur + rng.normal(0, 0.05, cur.shape).astype(np.float32)
    nrm = rng.normal(size=cur.shape).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    w = (rng.uniform(size=cur.shape[:2]) < 0.9).astype(np.float32)
    args = [_t(x) for x in (cur, matched, nrm, w)]
    denom = args[3].sum(-1)
    for B in (6, 2):
        lanes = _plane_error(*(a[:B] for a in args), denom[:B])
        for b in range(B):
            one = _plane_error(*(a[b : b + 1] for a in args), denom[b : b + 1])
            flat = _plane_error(*(a[b] for a in args), denom[b])
            assert torch.equal(lanes[b], one[0]) and torch.equal(one[0], flat)


def _cfg():
    cfg = config.apply_mode(config.tiny_config(**TINY), "fast").replace(**KNOBS)
    assert not cfg.optimize_midrun and cfg.knn_backend == "slab_pallas"
    return cfg


@pytest.fixture(scope="module")
def seqs():
    """Two sequences on one route through two different worlds."""
    half = route_half_for(N_FRAMES)
    gt = generate_trajectory(N_FRAMES, half=half)
    out = []
    for seed in (0, 1):
        world = generate_world(seed, route_half=half)
        rng = np.random.default_rng(seed)
        out.append([voxel_downsample_host(
            render_scan(world, gt[i], rng, max_range=15.0, max_points=20000),
            0.5, TINY["max_points"]) for i in range(N_FRAMES)])
    return out


@pytest.fixture(scope="module")
def singles(seqs):
    out = []
    for seq in seqs:
        eng = pipeline.SlamEngine(_cfg(), "cpu")
        for s in seq:
            eng.push_scan(s)
        odo = eng.trajectory()
        eng.finalize()
        out.append(dict(odo=odo, final=eng.trajectory(), metrics=eng.metrics(),
                        pairs=eng.loop_pairs(), grid=eng.occupancy()))
    return out


@pytest.fixture(scope="module")
def batched(seqs):
    cfg = _cfg()
    eng = BatchedSlamEngine(cfg, 2, "cpu", optimize_midrun=cfg.optimize_midrun)
    found = [eng.push_scans([a, b], sync_info=True) for a, b in zip(*seqs)]
    odo = eng.trajectories()
    eng.finalize()
    return dict(eng=eng, odo=odo, final=eng.trajectories(), found=found,
                metrics=eng.metrics(), pairs=eng.loop_pairs())


def test_fast_mode_lanes_equal_single_engines(singles, batched):
    assert batched["odo"].shape == batched["final"].shape == (2, N_FRAMES, 4, 4)
    for b, single in enumerate(singles):
        assert single["metrics"]["loop_count"] >= 1
        assert batched["pairs"][b] == single["pairs"]
        for key in ("loop_count", "verify_fired", "verify_fine_fired",
                    "verify_bound_hit", "loops_dropped", "occ_dropped"):
            assert batched["metrics"][b][key] == single["metrics"][key], key
        for key in ("icp_iters", "icp_converged", "frame_npts"):
            np.testing.assert_array_equal(batched["metrics"][b][key],
                                          single["metrics"][key])
        np.testing.assert_allclose(batched["odo"][b], single["odo"], atol=1e-4)
        np.testing.assert_allclose(batched["final"][b], single["final"],
                                   atol=1e-4)
        np.testing.assert_array_equal(
            batched["eng"].state.grid[b].numpy(), single["grid"])
    # the two sequences differ: the lanes are not one run twice
    assert np.abs(batched["final"][0] - batched["final"][1]).max() > 1e-2
    # push_scans(sync_info=True) counts each tick's loops over the lanes
    assert sum(f or 0 for f in batched["found"]) == sum(
        m["loop_count"] for m in batched["metrics"])


def test_resident_equals_streaming_and_reset_reruns(seqs, batched):
    """The first frames from a preloaded store repeat the streaming run
    exactly (its poses of those frames are final before finalize in fast
    mode); after ``reset()`` the same engine repeats itself."""
    cfg = _cfg()
    res = BatchedSlamEngine(cfg, 2, "cpu", optimize_midrun=False)
    res.preload([s[:SHORT] for s in seqs])
    runs = []
    for _ in range(2):
        res.run_preloaded()
        assert res.n_frames == SHORT
        np.testing.assert_array_equal(res.trajectories(),
                                      batched["odo"][:, :SHORT])
        for m, want in zip(res.metrics(), batched["metrics"]):
            np.testing.assert_array_equal(m["icp_error"], want["icp_error"][:SHORT])
            np.testing.assert_array_equal(m["frame_npts"], want["frame_npts"][:SHORT])
        res.finalize()
        runs.append((res.trajectories(), res.state.grid.clone()))
        res.reset()
        assert res.n_frames == 0 and res.state.n_poses == [1, 1]
    np.testing.assert_array_equal(runs[0][0], runs[1][0])
    assert torch.equal(runs[0][1], runs[1][1])


def test_engine_refuses_mesh_and_bad_inputs():
    cfg = _cfg()
    with pytest.raises(TypeError, match="Mesh"):
        BatchedSlamEngine(cfg, 2, "cpu", mesh=object())
    with pytest.raises(ValueError, match="'seq'"):
        BatchedSlamEngine(cfg, 2, mesh=make_mesh({"pts": 2}, devices=["cpu"] * 2))
    eng = BatchedSlamEngine(cfg, 2, "cpu")
    with pytest.raises(ValueError, match="lanes"):
        eng.push_scans([np.zeros((10, 3), np.float32)])
    with pytest.raises(ValueError, match="equal length"):
        eng.preload([[np.zeros((10, 3), np.float32)], []])
