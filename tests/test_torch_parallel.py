"""The port's multi-device sharding (``lidar_slam_tpu_torch.parallel``) against
the JAX package's, on the CPU.

JAX runs on the 8 virtual CPU devices of ``tests/conftest.py``; the port's
meshes hold the CPU 8 times (``devices=["cpu"] * 8``), which is how one
device hosts every shard.

- ``make_mesh`` factorizes as JAX's does.
- The target- and source-sharded 1-NN give JAX's indices, and d2 within
  JAX's own tolerance (rtol 1e-5) plus the rounding of XLA's expanded
  |s|^2 + |t|^2 - 2 s.t (8 f32 ulps of |s|^2 + |t|^2; the port's
  difference form is exact to 1e-6); and the port's unsharded K2 bit for
  bit, ties across shards included (the lower global index wins).
- The DB-sharded Scan Context top-k gives JAX's indices and shifts, and the
  port's unsharded stable-sorted top-k exactly, over duplicate entries in
  two shards and empty entries at distance 1.0.
- ICP with ``make_sharded_nn1`` equals the port's ICP with the unsharded
  search bit for bit, and JAX's ICP with ``nn1_target_sharded`` to the
  port's ICP parity tolerance (``test_torch_ops.py``).
- ``BatchedSlamEngine(mesh=)`` equals the unsharded port engine (loops,
  counters; poses within 1e-6 m), a checkpoint saved with the mesh loads
  without it, and the engine follows JAX's meshed batched engine.
- ``dryrun_multichip`` runs on 8 CPU devices at a flagship of 8,192 points.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidar_slam_tpu import config as jconfig
from lidar_slam_tpu.cli import _apply_mode
from lidar_slam_tpu.ops import icp as jicp
from lidar_slam_tpu.ops import knn as jknn
from lidar_slam_tpu.ops import normals as jnormals
from lidar_slam_tpu.parallel import BatchedSlamEngine as JBatchedSlamEngine
from lidar_slam_tpu.parallel import make_mesh as jmake_mesh
from lidar_slam_tpu.parallel import nn1_source_sharded as jnn1_source_sharded
from lidar_slam_tpu.parallel import nn1_target_sharded as jnn1_target_sharded
from lidar_slam_tpu.parallel import sc_topk_sharded as jsc_topk_sharded
from lidar_slam_tpu.types import PointCloud as JPointCloud
from lidar_slam_tpu_torch import config
from lidar_slam_tpu_torch.ops import knn_cuda
from lidar_slam_tpu_torch.ops import scan_context as sc
from lidar_slam_tpu_torch.ops.icp import icp_point_to_plane
from lidar_slam_tpu_torch.parallel import (
    BatchedSlamEngine,
    Mesh,
    make_mesh,
    make_sharded_nn1,
    nn1_source_sharded,
    nn1_target_sharded,
    sc_topk_sharded,
)
from lidar_slam_tpu_torch.parallel.dryrun import dryrun_multichip, entry
from lidar_slam_tpu_torch.types import PointCloud
from lidar_slam_tpu_torch.utils.dataset import (
    generate_trajectory,
    generate_world,
    render_scan,
    route_half_for,
)
from lidar_slam_tpu_torch.utils.native import voxel_downsample_host

torch.set_num_threads(2)

CPU8 = ["cpu"] * 8
N_FRAMES = 40
TINY = dict(max_raw_points=2048, max_points=2048, lc_cloud_points=0,
            max_frames=48, max_loop_factors=16)
# the fast-mode knobs of test_torch_batched.py / test_torch_pipeline.py,
# where both packages' engines track these small clouds
KNOBS = dict(host_voxelize=True, slab_window=1024, normal_window=1024,
             dispatch_block=0)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def mesh8():
    assert len(jax.devices()) == 8, "conftest must provide 8 virtual devices"
    return jmake_mesh({"seq": 2, "pts": 4}), make_mesh({"seq": 2, "pts": 4},
                                                        devices=CPU8)


def test_make_mesh_factorizes_as_jax():
    for sizes in (None, {"seq": 2, "pts": 4}, {"pts": 8}):
        got = make_mesh(sizes, devices=CPU8)
        want = jmake_mesh(sizes)
        assert tuple(got.shape.items()) == tuple(want.shape.items())
        assert got.axis_names == tuple(want.axis_names)
        assert got.devices.shape == want.devices.shape
    assert make_mesh(devices=["cpu"] * 2).shape == {"seq": 2, "pts": 1}
    assert make_mesh(devices=["cpu"] * 16).shape == {"seq": 4, "pts": 4}
    with pytest.raises(ValueError, match="does not hold"):
        make_mesh({"seq": 3, "pts": 2}, devices=CPU8)


def test_make_mesh_without_cuda_needs_devices():
    if torch.cuda.is_available():
        assert make_mesh().size == torch.cuda.device_count()
        return
    with pytest.raises(RuntimeError, match="devices="):
        make_mesh()


def test_mesh_rows_follow_the_devices():
    """``axis_devices`` picks the row of ``pts`` devices that holds the
    caller's device (each ``seq`` group's own row), else the first row."""
    grid = np.empty(4, dtype=object)
    grid[:] = [torch.device("cpu"), torch.device("meta")] * 2
    mesh = Mesh(grid.reshape(2, 2).T.copy(), ("seq", "pts"))
    assert mesh.axis_devices("pts", near="meta") == [torch.device("meta")] * 2
    assert mesh.axis_devices("pts") == [torch.device("cpu")] * 2
    assert mesh.axis_devices("seq") == [torch.device("cpu"), torch.device("meta")]
    with pytest.raises(ValueError, match="no 'lanes'"):
        mesh.axis_devices("lanes")


def _knn_data(rng):
    """``tests/test_parallel.py``'s data: 256 sources, 512 targets, a masked
    tail from row 400."""
    src = (rng.normal(size=(256, 3)) * 10).astype(np.float32)
    tgt = (rng.normal(size=(512, 3)) * 10).astype(np.float32)
    mask = np.ones(512, bool)
    mask[400:] = False
    return src, tgt, mask


def test_target_and_source_sharded_match_jax(mesh8, rng):
    jmesh, mesh = mesh8
    src, tgt, mask = _knn_data(rng)
    for jfn, fn, m in ((jnn1_target_sharded, nn1_target_sharded, mask),
                       (jnn1_source_sharded, nn1_source_sharded,
                        np.ones(512, bool))):
        idx_j, d2_j = jfn(jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(m),
                          jmesh, axis="pts")
        idx_t, d2_t = fn(_t(src), _t(tgt), _t(m), mesh, axis="pts")
        assert idx_t.dtype == torch.int32 and d2_t.dtype == torch.float32
        np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
        # XLA's |s|^2 + |t|^2 - 2 s.t cancels to a few f32 ulps of
        # |s|^2 + |t|^2; the port's difference form is exact to 1e-6
        i = idx_t.numpy()
        exact = np.sum((src.astype(np.float64) - tgt[i]) ** 2, axis=1)
        np.testing.assert_allclose(d2_t.numpy(), exact, rtol=1e-6)
        scale = np.sum(src ** 2, axis=1) + np.sum(tgt[i] ** 2, axis=1)
        err = np.abs(d2_t.numpy() - np.asarray(d2_j))
        assert np.all(err <= 1e-5 * exact + 8 * np.finfo(np.float32).eps * scale)
        # and JAX's unsharded search
        idx_r, _ = jknn.nn1(jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(m))
        np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_r))


def test_sharded_1nn_equals_unsharded_bit_for_bit(mesh8, rng):
    """Both sharded searches equal ``knn_cuda.nn1`` exactly, over lanes,
    with one target point repeated in shards 0 and 2 (rows 37 and 291 of
    four 128-row shards) and in shards 1 and 3 (rows 200 and 400): sources
    on those points must get the lower global index."""
    _, mesh = mesh8
    src, tgt, mask = _knn_data(rng)
    mask[:] = True
    mask[450:] = False
    for a, b in ((37, 291), (200, 400)):
        tgt[b] = tgt[a]
    src[:2] = tgt[[291, 400]]
    lanes = (np.stack([src, src[::-1]]), np.stack([tgt, tgt[::-1]]),
             np.stack([mask, mask]))
    for s, t, m in ((src, tgt, mask), lanes):
        want = knn_cuda.nn1(_t(s), _t(t), _t(m))
        for fn in (nn1_target_sharded, nn1_source_sharded):
            got = fn(_t(s), _t(t), _t(m), mesh)
            for x, y in zip(got, want):
                torch.testing.assert_close(x, y, rtol=0, atol=0)
    i, _ = nn1_target_sharded(_t(src), _t(tgt), _t(mask), mesh)
    assert i[:2].tolist() == [37, 200]
    with pytest.raises(ValueError, match="do not split"):
        nn1_target_sharded(_t(src), _t(tgt[:510]), _t(mask[:510]), mesh)


def _sc_db(rng):
    """``tests/test_parallel.py``'s DB (64 entries, rows 50-63 empty), with
    entry 5 copied into row 21 (shard 2 of 8, same offset) and a query near
    entry 12 rotated by 7 sectors."""
    F, R, S = 64, 20, 60
    db = rng.uniform(0, 5, (F, R, S)).astype(np.float32)
    db[50:] = 0.0
    dbn = np.sqrt((db.reshape(F, -1) ** 2).sum(axis=1)).astype(np.float32)
    q = np.roll(db[12], 7, axis=1) + rng.normal(0, 0.01, (R, S)).astype(np.float32)
    db[21], dbn[21] = db[5], dbn[5]
    return q, db, dbn


def test_sc_topk_sharded_matches_jax_and_the_stable_sort(mesh8, rng):
    jmesh, mesh = mesh8
    q, db, dbn = _sc_db(rng)
    dist, shift = sc.sc_distances(_t(q), _t(db), _t(dbn))
    order = torch.sort(dist, stable=True).indices
    for k in (8, 60):  # 60 reaches into the ten empty entries' ties at 1.0
        d_j, i_j, s_j = jsc_topk_sharded(jnp.asarray(q), jnp.asarray(db),
                                         jnp.asarray(dbn), k, jmesh, axis="pts")
        d_t, i_t, s_t = sc_topk_sharded(_t(q), _t(db), _t(dbn), k, mesh)
        assert i_t.dtype == s_t.dtype == torch.int32 and len(i_t) == k
        np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
        np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
        np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_array_equal(i_t.numpy(), order[:k].numpy())
        np.testing.assert_array_equal(s_t.numpy(), shift[order[:k]].numpy())
        torch.testing.assert_close(d_t, dist[order[:k]], rtol=0, atol=0)
    ranks = order.tolist()
    assert ranks.index(5) + 1 == ranks.index(21)  # the duplicate, lower first
    assert ranks[-14:] == list(range(50, 64)) and float(dist[63]) == 1.0


def _icp_data():
    half = route_half_for(N_FRAMES)
    world = generate_world(0, route_half=half)
    gt = generate_trajectory(N_FRAMES, half=half)
    rng = np.random.default_rng(0)
    out = []
    for i in (5, 6):
        v = voxel_downsample_host(
            render_scan(world, gt[i], rng, max_range=15.0, max_points=20000),
            0.5, 2048)
        pts = np.zeros((2048, 3), np.float32)
        pts[: len(v)] = v
        out.append((pts, np.arange(2048) < len(v)))
    return out


def test_icp_with_the_sharded_search(mesh8):
    jmesh, mesh = mesh8
    (tgt, tmask), (src, smask) = _icp_data()
    nrm = np.asarray(jnormals.estimate_normals_adaptive(
        jnp.asarray(tgt), jnp.asarray(tmask), window=1024, r_min=1.2))
    # the default mode's ICP (every source row, tolerance 1e-6), where the
    # exact search is the odometry's
    cfg = dict(max_iterations=50, tolerance=1e-6)
    args = (PointCloud(_t(src), _t(smask)), PointCloud(_t(tgt), _t(tmask)),
            _t(nrm), config.ICPConfig(**cfg))
    sharded = make_sharded_nn1(mesh, "pts")
    res = icp_point_to_plane(*args, nn1_fn=sharded)
    ref = icp_point_to_plane(*args, nn1_fn=knn_cuda.nn1)
    for f in dataclasses.fields(res):
        torch.testing.assert_close(getattr(res, f.name), getattr(ref, f.name),
                                   rtol=0, atol=0)
    res_j = jicp.icp_point_to_plane(
        JPointCloud(jnp.asarray(src), jnp.asarray(smask)),
        JPointCloud(jnp.asarray(tgt), jnp.asarray(tmask)),
        jnp.asarray(nrm), jconfig.ICPConfig(**cfg),
        nn1_fn=lambda s, t, m: jnn1_target_sharded(s, t, m, jmesh, axis="pts"),
    )
    assert int(res.num_iterations) == int(res_j.num_iterations)
    assert bool(res.converged) == bool(res_j.converged)
    np.testing.assert_allclose(res.transformation.numpy(),
                               np.asarray(res_j.transformation), atol=1e-5)
    np.testing.assert_allclose(res.final_error.numpy(),
                               np.asarray(res_j.final_error), rtol=1e-4)
    # the prepared query over lanes equals the plain call
    q = sharded.prepare(_t(np.stack([tgt, tgt])), _t(np.stack([tmask, tmask])))
    s2 = _t(np.stack([src, src[::-1].copy()]))
    for a, b in zip(q(s2), sharded(s2, _t(np.stack([tgt, tgt])),
                                   _t(np.stack([tmask, tmask])))):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.fixture(scope="module")
def seqs():
    """Two sequences on one route through two different worlds, as in
    ``test_torch_batched.py``."""
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


def _configs():
    jcfg = _apply_mode(jconfig.tiny_config(**TINY), "fast").replace(**KNOBS)
    cfg = config.apply_mode(config.tiny_config(**TINY), "fast").replace(**KNOBS)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    return jcfg, cfg


def _run(eng, seqs):
    found = [eng.push_scans([a, b], sync_info=True) for a, b in zip(*seqs)]
    odo = eng.trajectories()
    eng.finalize()
    return dict(odo=odo, final=eng.trajectories(), found=found,
                metrics=eng.metrics(), pairs=eng.loop_pairs())


@pytest.fixture(scope="module")
def meshed(seqs, tmp_path_factory):
    """The port's engine over a (seq 2, pts 4) mesh of the CPU, with a
    checkpoint saved after frame 30."""
    _, cfg = _configs()
    mesh = make_mesh({"seq": 2, "pts": 4}, devices=CPU8)
    eng = BatchedSlamEngine(cfg, 2, mesh=mesh,
                            optimize_midrun=cfg.optimize_midrun)
    ckpt = str(tmp_path_factory.mktemp("ckpt") / "meshed.npz")
    found = []
    for f, (a, b) in enumerate(zip(*seqs)):
        found.append(eng.push_scans([a, b], sync_info=True))
        if f == 30:
            eng.save_checkpoint(ckpt)
    odo = eng.trajectories()
    eng.finalize()
    return dict(odo=odo, final=eng.trajectories(), found=found,
                metrics=eng.metrics(), pairs=eng.loop_pairs(), ckpt=ckpt,
                eng=eng)


def test_meshed_engine_equals_the_unsharded_engine(seqs, meshed):
    _, cfg = _configs()
    eng = meshed["eng"]
    assert [len(s.n_poses) for s in eng._states] == [1, 1]
    ref = _run(BatchedSlamEngine(cfg, 2, "cpu",
                                 optimize_midrun=cfg.optimize_midrun), seqs)
    assert meshed["pairs"] == ref["pairs"] and meshed["found"] == ref["found"]
    assert all(m["loop_count"] >= 1 for m in meshed["metrics"])
    for got, want in zip(meshed["metrics"], ref["metrics"]):
        for key, v in want.items():
            np.testing.assert_array_equal(got[key], v, err_msg=key)
    for stage in ("odo", "final"):
        assert meshed[stage].shape == (2, N_FRAMES, 4, 4)
        np.testing.assert_allclose(meshed[stage], ref[stage], rtol=0, atol=1e-6)
    # the gathered state is the lane-stacked state of the engine without one
    st = eng.state
    assert st.loop_count == [m["loop_count"] for m in ref["metrics"]]
    assert st.poses.shape[:2] == (2, TINY["max_frames"])


def test_checkpoint_saved_with_a_mesh_loads_without_one(seqs, meshed):
    """The meshed engine's checkpoint after frame 30 loads into an engine
    without a mesh, which goes on to the meshed run's trajectories; loaded
    into a meshed engine it is split over the groups as it was saved."""
    _, cfg = _configs()
    with np.load(meshed["ckpt"]) as c:
        assert c["poses"].shape[0] == 2 and c["n_poses"].tolist() == [31, 31]
        saved = c["poses"]
    again = BatchedSlamEngine(
        cfg, 2, mesh=make_mesh({"seq": 2, "pts": 1}, devices=["cpu"] * 2))
    again.load_checkpoint(meshed["ckpt"])
    assert again.n_frames == 31 and again.state.n_poses == [31, 31]
    np.testing.assert_array_equal(again.state.poses.numpy(), saved)
    eng = BatchedSlamEngine(cfg, 2, "cpu", optimize_midrun=cfg.optimize_midrun)
    eng.load_checkpoint(meshed["ckpt"])
    assert eng.n_frames == 31
    for a, b in list(zip(*seqs))[31:]:
        eng.push_scans([a, b])
    eng.finalize()
    np.testing.assert_allclose(eng.trajectories(), meshed["final"], rtol=0,
                               atol=1e-6)
    assert eng.loop_pairs() == meshed["pairs"]


def test_meshed_engine_follows_jax(seqs, meshed):
    """JAX's ``BatchedSlamEngine(mesh=make_mesh({"seq": 2, "pts": 4}))`` on
    the same scans: the same loops and counters, poses within 1e-4 m."""
    jcfg, _ = _configs()
    jeng = JBatchedSlamEngine(jcfg, batch=2, mesh=jmake_mesh({"seq": 2, "pts": 4}),
                              optimize_midrun=jcfg.optimize_midrun)
    for a, b in zip(*seqs):
        jeng.push_scans([a, b])
    odo = jeng.trajectories()
    jeng.finalize()
    st = jeng.state
    assert [m["loop_count"] for m in meshed["metrics"]] == \
        np.asarray(st.loop_count).tolist()
    assert [m["verify_fired"] for m in meshed["metrics"]] == \
        np.asarray(st.verify_fired).tolist()
    for got, want in ((meshed["odo"], odo), (meshed["final"], jeng.trajectories())):
        err = np.abs(got[..., :3, 3] - want[..., :3, 3]).max()
        assert err < 1e-4, err


def test_batched_fns_are_the_engines_programs(seqs, meshed):
    """``make_batched_fns`` (the JAX package's name): its init, step and
    loop over a lane-stacked state give the engine's run, and its optimize
    chunks every lane and sets ``pending_optimize``."""
    from lidar_slam_tpu_torch.parallel import make_batched_fns
    from lidar_slam_tpu_torch.parallel.batched import init_states

    _, cfg = _configs()
    init, step, loop, optimize, finalize = make_batched_fns(
        cfg, optimize_midrun=cfg.optimize_midrun)
    state = init_states(cfg, 2, "cpu")
    for f, (a, b) in enumerate(list(zip(*seqs))[:12]):
        raw = torch.zeros((2, cfg.max_points, 3))
        raw[0, : len(a)], raw[1, : len(b)] = _t(a), _t(b)
        counts = [len(a), len(b)]
        if f == 0:
            init(state, raw, counts)
            continue
        step(state, raw, counts, f)
        if f % cfg.loop_check_every == 0 and f > cfg.loop_start_frame:
            loop(state, f)
    np.testing.assert_array_equal(state.poses[:, :12].numpy(),
                                  meshed["odo"][:, :12])
    optimize(state)
    assert len(state.pending_optimize) == 2
    assert all(isinstance(p, bool) for p in state.pending_optimize)
    assert len(finalize(state)) == 2


def test_engine_refuses_a_bad_mesh():
    cfg = config.tiny_config(max_frames=8)
    with pytest.raises(TypeError, match="Mesh"):
        BatchedSlamEngine(cfg, 2, "cpu", mesh=object())
    with pytest.raises(ValueError, match="'seq'"):
        BatchedSlamEngine(cfg, 2, mesh=make_mesh({"pts": 2}, devices=["cpu"] * 2))
    with pytest.raises(ValueError, match="evenly"):
        BatchedSlamEngine(cfg, 3, mesh=make_mesh({"seq": 2}, devices=["cpu"] * 2))


def test_dryrun_multichip_on_eight_cpu_devices():
    out = dryrun_multichip(8, devices=CPU8, flagship_points=8192)
    assert out["mesh"] == {"seq": 2, "pts": 4} and out["batch"] == 2
    assert out["top1"] == 3
    assert out["n_poses"] == [2, 2]
    assert np.isfinite(out["flagship_poses"]).all()
    with pytest.raises(RuntimeError, match="need 8 devices"):
        dryrun_multichip(8, devices=["cpu"] * 4)
    fn, args = entry("cpu")  # the per-scan step and its example arguments
    state = fn(*args)
    assert state.n_poses == 2 and torch.isfinite(state.poses[:2]).all()
