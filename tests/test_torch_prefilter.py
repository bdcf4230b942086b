"""The ring-key prefilter of loop retrieval (``LoopClosureConfig.
ring_key_prefilter``) in the port against the JAX package: the keys, the
pairwise distance, the prefiltered retrieval (on a DB whose empty rows share
a zero ring key, so the k-th survivor is picked among ties: both keep the
lower index), and detection with it, one lane and lanes.

Tolerances: keys and distances within 1e-6 (f32 means and the matmul summed
in another order); survivors, shifts and accept sets equal; accepted
transforms within 1e-4 (``test_torch_models.py``'s, for the two 1-NN
forms)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidar_slam_tpu.config import LoopClosureConfig as JLCConfig
from lidar_slam_tpu.config import ScanContextConfig as JSCConfig
from lidar_slam_tpu.models import loop_closure as jlc
from lidar_slam_tpu.ops import normals as jnormals
from lidar_slam_tpu.ops import scan_context as jsc
from lidar_slam_tpu.types import PointCloud as JPointCloud
from lidar_slam_tpu_torch.config import LoopClosureConfig, ScanContextConfig
from lidar_slam_tpu_torch.models import loop_closure as lc
from lidar_slam_tpu_torch.ops import scan_context as sc
from lidar_slam_tpu_torch.types import PointCloud
from lidar_slam_tpu_torch.utils.dataset import generate_world, render_scan
from lidar_slam_tpu_torch.utils.native import voxel_downsample_host

torch.set_num_threads(2)


def _t(x):
    return torch.from_numpy(np.array(x))


def _db(rng, F=24, n_real=14):
    """Descriptor DB: ``n_real`` rows of sparse random heights, the rest
    empty (all zero, as unwritten DB rows are)."""
    R, S = ScanContextConfig().num_rings, ScanContextConfig().num_sectors
    db = np.zeros((F, R, S), np.float32)
    real = rng.uniform(0.0, 6.0, (n_real, R, S)).astype(np.float32)
    real *= rng.uniform(size=real.shape) < 0.3
    db[:n_real] = real
    return db


def test_keys_and_pair_distance_match_jax(rng):
    db = _db(rng)
    np.testing.assert_allclose(sc.ring_key(_t(db)).numpy(),
                               np.asarray(jsc.ring_key(jnp.asarray(db))),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(sc.sector_key(_t(db)).numpy(),
                               np.asarray(jsc.sector_key(jnp.asarray(db))),
                               rtol=1e-6, atol=1e-6)
    for a, b in ((0, 1), (2, 2), (3, 20)):  # a pair, itself, an empty row
        np.testing.assert_allclose(
            float(sc.sc_distance(_t(db[a]), _t(db[b]))),
            float(jsc.sc_distance(jnp.asarray(db[a]), jnp.asarray(db[b]))),
            atol=1e-6)


@pytest.mark.parametrize("query,k", [("real", 8), ("real", 30), ("faint", 5)])
def test_prefiltered_retrieval_matches_jax(rng, query, k):
    """``faint``: a query whose ring key is nearer the 10 empty rows' zero
    key than any real row's, so the 5 survivors are picked among 10 ties."""
    db = _db(rng)
    F = db.shape[0]
    q = db[3] if query == "real" else (db[3] * 0.01).astype(np.float32)
    norm = np.sqrt(np.sum(db * db, axis=(1, 2))).astype(np.float32)
    k = min(k, F)
    d_t, s_t = sc.sc_distances_ring_prefiltered(_t(q), _t(db), _t(norm), k)
    d_j, s_j = jsc.sc_distances_ring_prefiltered(
        jnp.asarray(q), jnp.asarray(db), jnp.asarray(norm), k=k)
    d_j, s_j = np.asarray(d_j), np.asarray(s_j)
    survivors = np.isfinite(d_j)
    assert int(survivors.sum()) == k
    np.testing.assert_array_equal(np.isfinite(d_t.numpy()), survivors)
    np.testing.assert_allclose(d_t.numpy()[survivors], d_j[survivors], atol=1e-6)
    np.testing.assert_array_equal(s_t.numpy(), s_j)
    if query == "faint":  # the lowest-index empty rows survive
        np.testing.assert_array_equal(np.flatnonzero(survivors),
                                      np.arange(14, 14 + k))


def _revisit_db(seed):
    """A 16-frame DB of 12 scans (a street, then two revisits of its start):
    4 empty rows, whose zero ring keys tie."""
    world = generate_world(seed, route_half=8.0)
    poses = []
    for i in range(10):
        T = np.eye(4, dtype=np.float32)
        T[:3, 3] = [i * 1.5, 0, 1.8]
        poses.append(T)
    for k, yaw in ((1, 0.2), (2, -0.3)):
        T = np.eye(4, dtype=np.float32)
        c, s = np.cos(yaw), np.sin(yaw)
        T[:3, :3] = [[c, -s, 0], [s, c, 0], [0, 0, 1]]
        T[:3, 3] = poses[k][:3, 3]
        poses.append(T)
    rng = np.random.default_rng(seed)
    F, N = 16, 2048
    jdb = jlc.init_db(F, N, JSCConfig())
    db = lc.init_db(F, N, ScanContextConfig())
    for f, p in enumerate(poses):
        s = voxel_downsample_host(
            render_scan(world, p, rng, max_range=25.0, max_points=4000), 0.4, N)
        pts = np.zeros((N, 3), np.float32)
        pts[: len(s)] = s
        mask = np.arange(N) < len(s)
        nrm = np.asarray(jnormals.estimate_normals_adaptive(
            jnp.asarray(pts), jnp.asarray(mask), r_min=1.0, window=512))
        jdb = jlc.add_frame(jdb, JPointCloud(jnp.asarray(pts), jnp.asarray(mask)),
                            jnp.int32(f), JSCConfig(), normals=jnp.asarray(nrm))
        lc.add_frame(db, PointCloud(_t(pts), _t(mask)), f, ScanContextConfig(),
                     enabled=True, normals=_t(nrm))
    return jdb, db, len(poses)


KW = dict(frame_gap=5, sc_distance_threshold=0.5, icp_fitness_threshold=0.6,
          icp_max_iterations=15, verify_tolerance=1e-3, ring_key_prefilter=8)


def _same(det_t, det_j):
    acc = det_t.accepted.numpy()
    np.testing.assert_array_equal(acc, np.asarray(det_j.accepted))
    np.testing.assert_array_equal(det_t.match_frame.numpy(),
                                  np.asarray(det_j.match_frame))
    np.testing.assert_array_equal(np.isfinite(det_t.sc_distance.numpy()),
                                  np.isfinite(np.asarray(det_j.sc_distance)))
    assert det_t.n_valid == int(det_j.n_valid)
    np.testing.assert_allclose(det_t.transform.numpy()[acc],
                               np.asarray(det_j.transform)[acc], atol=1e-4)
    return int(acc.sum())


def test_detect_with_prefilter_matches_jax():
    jdb, db, n = _revisit_db(0)
    n_acc = 0
    for q in (n - 2, n - 1):
        n_acc += _same(lc.detect(db, LoopClosureConfig(**KW), ScanContextConfig(),
                                 query=q),
                       jlc.detect(jdb, JLCConfig(**KW), JSCConfig(),
                                  query=jnp.int32(q)))
    assert n_acc > 0


def test_detect_lanes_with_prefilter_matches_jax():
    """Two lanes, two worlds: each lane prefilters its own DB and gives the
    JAX detection of that DB."""
    lanes = [_revisit_db(s) for s in (0, 1)]
    dbs = [d for _, d, _ in lanes]
    stacked = lc.KeyframeDB(
        **{f: torch.stack([getattr(d, f) for d in dbs])
           for f in ("desc", "desc_norm", "clouds", "cloud_mask", "normals",
                     "in_db")},
        last_frame=[d.last_frame for d in dbs])
    q = lanes[0][2] - 1
    dets = lc.detect_lanes(stacked, LoopClosureConfig(**KW), ScanContextConfig(),
                           None, [q, q])
    n_acc = sum(_same(det, jlc.detect(jdb, JLCConfig(**KW), JSCConfig(),
                                      query=jnp.int32(q)))
                for det, (jdb, _, _) in zip(dets, lanes))
    assert n_acc > 0
