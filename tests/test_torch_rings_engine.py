"""The slice as a whole on the ring-pattern LiDAR world: the port's
``SlamEngine`` on the CPU against the JAX engine, in the two
configurations this slice adds (``test_torch_cli_rings.py`` runs the
command line with the same options).

Each package renders a 64-frame route (its last eighth re-drives the start)
through its own copy of the raycast simulator, 32 beams x 256 azimuths,
voxelized on the host at 1 m into 1,024-row clouds, fast mode:

- (a) ``normal_method="knn"`` (k = 20) with ``knn_backend="grid"``, world 1;
- (b) ``knn_backend="slab"``, ``normal_stride=2`` with the adaptive normals
  (probe stride 1) and ``lc.ring_key_prefilter=8``, world 0.

Tolerance, that of the engine parity tests (``test_torch_pipeline.py``,
``test_torch_default_mode.py``): the accept sets and firing counters
identical; every pose within 5e-3 m before and after finalize.

How the configurations were chosen: both engines must track, and small
float32 differences must not be amplified past the tolerance. On these
sparse clouds that rules out, in both engines alike:

- 0.5 m voxels with the grid search: many odometry ICPs run out of
  iterations (the grid's 9 probes x 32 slots miss), so trajectories drift
  3-5 m and finalize's 1/error odometry weights amplify 1e-4 m odometry
  differences to 1-14 cm (the port's finalize of the JAX engine's state
  gives the JAX result to 4e-4 m);
- the adaptive normals' probe stride 2 (the fast-mode default): XLA's CPU
  backend evaluates the count probes' distances with FMA, so a few counts
  at d2 ~ r^2 flip, and ~0.4% of the normals differ by up to 10 degrees;
  odometry then parts by 2-20 cm.
"""

import dataclasses

import numpy as np
import pytest
import torch

from lidar_slam_tpu import config as jconfig
from lidar_slam_tpu.cli import _apply_mode
from lidar_slam_tpu.models.pipeline import SlamEngine as JSlamEngine
from lidar_slam_tpu.utils import dataset as jdataset
from lidar_slam_tpu_torch.models import pipeline
from lidar_slam_tpu_torch.utils import dataset
from lidar_slam_tpu_torch.utils.metrics import ate_rmse
from lidar_slam_tpu_torch.utils.native import voxel_downsample_host

from test_torch_pipeline import port_config

torch.set_num_threads(2)

N_FRAMES = 64
BEAMS, AZIMUTHS = 32, 256
VOXEL = 1.0
CAP = 1024
SEED = {"a": 1, "b": 0}


def _config(which, cfg_mod, apply_mode):
    base = apply_mode(cfg_mod.tiny_config(
        max_raw_points=CAP, max_points=CAP, lc_cloud_points=0,
        max_frames=N_FRAMES + 8, max_loop_factors=16), "fast")
    cfg = base.replace(host_voxelize=True, voxel_size=VOXEL, slab_window=CAP,
                       normal_window=CAP, dispatch_block=0)
    if which == "a":
        return cfg.replace(normal_method="knn", knn_backend="grid",
                           icp=dataclasses.replace(cfg.icp, normal_k=20))
    return cfg.replace(knn_backend="slab", normal_stride=2,
                       normal_probe_stride=1,
                       lc=dataclasses.replace(cfg.lc, ring_key_prefilter=8))


def _scans(ds_mod, seed):
    """The ring route of ``seed``, rendered by ``ds_mod``'s simulator."""
    half = ds_mod.route_half_for(N_FRAMES)
    geom = ds_mod.generate_world_geom(seed, route_half=half)
    gt = ds_mod.generate_trajectory(N_FRAMES, half=half)
    rng = np.random.default_rng(seed)
    scans = [voxel_downsample_host(
        ds_mod.render_scan_rings(geom, gt[i], rng, n_beams=BEAMS,
                                 n_azimuth=AZIMUTHS), VOXEL, CAP)
        for i in range(N_FRAMES)]
    return scans, gt


def _pairs(pg_state, n):
    return list(zip(np.asarray(pg_state.loop_to[:n]).tolist(),
                    np.asarray(pg_state.loop_from[:n]).tolist()))


@pytest.fixture(scope="module", params=["a", "b"])
def runs(request):
    which = request.param
    jscans, gt = _scans(jdataset, SEED[which])
    jcfg = _config(which, jconfig, _apply_mode)
    jeng = JSlamEngine(jcfg)
    for s in jscans:
        jeng.push_scan(s)
    jodo = jeng.trajectory()
    jeng.finalize()
    st = jeng.state
    jax_run = dict(odo=jodo, final=jeng.trajectory(), metrics=jeng.metrics(),
                   pairs=_pairs(st.pg, int(st.pg.n_loops)))

    scans, _ = _scans(dataset, SEED[which])
    for a, b in zip(scans, jscans):  # each package's own render: equal
        np.testing.assert_array_equal(a, b)
    eng = pipeline.SlamEngine(port_config(jcfg), "cpu")
    eng.preload(scans)
    eng.run_preloaded()
    odo = eng.trajectory()
    eng.finalize()
    port_run = dict(odo=odo, final=eng.trajectory(), metrics=eng.metrics(),
                    pairs=eng.loop_pairs())
    return which, gt, jax_run, port_run


def test_ring_accept_sets_identical(runs):
    _, _, j, p = runs
    assert j["metrics"]["loop_count"] >= 1
    assert p["pairs"] == j["pairs"]
    for key in ("loop_count", "verify_fired", "verify_fine_fired",
                "verify_bound_hit", "loops_dropped"):
        assert p["metrics"][key] == j["metrics"][key], key


def test_ring_trajectory_matches_jax(runs):
    _, gt, j, p = runs
    for stage in ("odo", "final"):
        a, b = p[stage], j[stage]
        assert a.shape == b.shape == (N_FRAMES, 4, 4)
        assert bool(np.isfinite(a).all())
        err = np.abs(a[:, :3, 3] - b[:, :3, 3]).max()
        assert err < 5e-3, (stage, err)
    # it tracks: finalize with the closed loops improves on the odometry
    assert ate_rmse(p["final"], gt) < ate_rmse(p["odo"], gt)
