"""The CUDA kernels against their plain PyTorch versions, on the card.

This file imports neither JAX nor the repository's conftest, so it runs on a
GPU host without JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py

Without a card the kernel tests skip (a CUDA kernel has no CPU mode).
Indices and squared distances must be EXACTLY equal: both sides evaluate
(dx*dx + dy*dy) + dz*dz in round-to-nearest f32 without fused multiply-adds
and keep the first index of the minimum."""

import numpy as np
import pytest
import torch

from lidar_slam_tpu_torch.ops import knn_cuda

torch.set_num_threads(2)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _gen(seed=0):
    return np.random.default_rng(seed)


def _dev(x, dev):
    return torch.from_numpy(np.array(x)).to(dev)


def _exact(a, b):
    torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("lanes,S,T", [(1, 137, 501), (3, 1000, 5000),
                                       (2, 4096, 32768), (1, 32768, 32768),
                                       (3, 32768, 32768)])
def test_nn1_kernel_matches_plain(cuda, lanes, S, T):
    g = _gen(S)
    src = (g.normal(size=(lanes, S, 3)) * 20).astype(np.float32)
    tgt = (g.normal(size=(lanes, T, 3)) * 20).astype(np.float32)
    mask = g.uniform(size=(lanes, T)) > 0.1
    mask[0, T // 2:] = False  # a masked tail
    s, t, m = (_dev(x, cuda) for x in (src, tgt, mask))
    before = knn_cuda.NN1.launches
    idx_k, d2_k = knn_cuda.nn1(s, t, m)
    assert knn_cuda.NN1.launches == before + 1  # all lanes, one launch
    idx_p, d2_p = knn_cuda.nn1_torch(s, t, m)
    _exact(idx_k, idx_p)
    _exact(d2_k, d2_p)
    assert int(idx_k[0].max()) < T // 2


@pytest.mark.gpu
def test_nn1_kernel_ties_keep_first_index(cuda):
    g = _gen(1)
    base = (g.normal(size=(3000, 3)) * 10).astype(np.float32)
    tgt = np.concatenate([base, base], axis=0)  # every point twice
    src = base[g.permutation(3000)[:700]] + np.float32(0.01)
    idx, _ = knn_cuda.nn1(_dev(src, cuda), _dev(tgt, cuda),
                          torch.ones(6000, dtype=torch.bool, device=cuda))
    assert int(idx.max()) < 3000


def _nn1_edge_case(name):
    """(src, tgt, mask, expected first indices or None) for the K2 designs'
    edges: the split, tile and group boundaries of the target."""
    g = _gen(7)
    if name == "one_lane":       # a single lane still fills the card
        lanes, S, T = 1, 4096, 32768
    elif name == "ragged_T":     # T not a multiple of the tile or of 4
        lanes, S, T = 2, 700, 1027
    elif name == "ragged_S":     # S not a multiple of the block's rows
        lanes, S, T = 1, 513, 2048
    elif name == "tiny":         # fewer targets than one group
        lanes, S, T = 3, 5, 3
    else:                        # split_tie
        lanes, S, T = 1, 4096, 32768
    src = (g.normal(size=(lanes, S, 3)) * 20).astype(np.float32)
    tgt = (g.normal(size=(lanes, T, 3)) * 20).astype(np.float32)
    mask = np.ones((lanes, T), bool)
    want = None
    if name == "split_tie":
        # equal rows on both sides of group (16), tile (512) and split
        # (1,024 and up) boundaries, and far apart; a source on the point
        # itself (d2 == 0) must get the lower index
        bounds = [16, 512, 1024, 2048, 4096, 16384, 32767]
        want = {}
        for r, b in enumerate(bounds):
            tgt[0, b] = tgt[0, b - 1]
            far = (b + 9000) % T
            tgt[0, far] = tgt[0, b - 1]
            src[0, r] = tgt[0, b - 1]
            want[r] = min(b - 1, far)
    return src, tgt, mask, want


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["one_lane", "ragged_T", "ragged_S", "tiny",
                                  "split_tie"])
def test_nn1_kernel_edges(cuda, name):
    src, tgt, mask, want = _nn1_edge_case(name)
    s, t, m = (_dev(x, cuda) for x in (src, tgt, mask))
    idx_k, d2_k = knn_cuda.nn1(s, t, m)
    idx_p, d2_p = knn_cuda.nn1_torch(s, t, m)
    _exact(idx_k, idx_p)
    _exact(d2_k, d2_p)
    for r, i in (want or {}).items():
        assert int(idx_k[0, r]) == i and float(d2_k[0, r]) == 0.0


@pytest.mark.gpu
def test_nn1_prepare_query_equals_nn1(cuda):
    """One layout, several queries: each is one launch and equals nn1; the
    kernel leaves its tickets ready for the next launch."""
    src, tgt, mask, _ = _nn1_edge_case("ragged_T")
    mask[0, 500:] = False
    s, t, m = (_dev(x, cuda) for x in (src, tgt, mask))
    query = knn_cuda.nn1.prepare(t, m)
    before = knn_cuda.NN1.launches
    for shift in (0.0, 0.5, 0.0):
        idx_q, d2_q = query(s + shift)
        idx_n, d2_n = knn_cuda.nn1_torch(s + shift, t, m)
        _exact(idx_q, idx_n)
        _exact(d2_q, d2_n)
    assert knn_cuda.NN1.launches == before + 3
    assert int(idx_q[0].max()) < 500


def _slab_case(g, n_tgt, n_src, scale, masked):
    tgt = (g.normal(size=(n_tgt, 3)) * scale).astype(np.float32)
    tgt = tgt[np.argsort(tgt[:, 0])]
    src = tgt + g.normal(size=tgt.shape).astype(np.float32) * 0.2
    src = src[np.argsort(src[:, 0])][:n_src]
    mask = np.ones(n_tgt, bool)
    if masked:
        mask[int(0.85 * n_tgt):] = False
    normals = g.normal(size=(n_tgt, 3)).astype(np.float32)
    return src, tgt, mask, normals


@pytest.mark.gpu
@pytest.mark.parametrize("n_tgt,n_src,ts,window", [(2000, 1500, 128, 1024),
                                                   (32768, 4096, 256, 4096),
                                                   (30000, 4000, 256, 8192)])
def test_match_slab_kernel_matches_plain(cuda, n_tgt, n_src, ts, window):
    src, tgt, mask, normals = _slab_case(_gen(n_tgt), n_tgt, n_src, 50.0,
                                         masked=True)
    args = [_dev(x, cuda) for x in (src, tgt, mask, normals)]
    before = knn_cuda.MATCH_SLAB.launches
    out_k = knn_cuda.match_slab(*args, ts=ts, window=window)
    assert knn_cuda.MATCH_SLAB.launches == before + 1
    out_p = knn_cuda.match_slab_torch(*args, ts=ts, window=window)
    for a, b in zip(out_k, out_p):
        _exact(a, b)
    idx_k, d2_k = knn_cuda.nn1_slab(*args[:3], ts=ts, window=window)
    idx_p, d2_p = knn_cuda.nn1_slab_torch(*args[:3], ts=ts, window=window)
    _exact(idx_k, idx_p)
    _exact(d2_k, d2_p)
    # the fused gather is the row gather, bit for bit
    _exact(out_k[0], args[1][idx_k.long()])
    _exact(out_k[1], args[3][idx_k.long()])


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["ragged_S", "sentinel_tile", "short_S",
                                  "small_target", "wide_tile"])
def test_match_slab_kernel_edges(cuda, name):
    """One K1 query, kernel against plain: matched rows, d2, indices and the
    window starts the kernel computed itself."""
    n_tgt, n_src, ts, window = {
        "ragged_S": (32768, 4001, 256, 4096),       # last tile has 161 rows
        "sentinel_tile": (32768, 4096, 256, 4096),  # a tile of invalid rows
        "short_S": (5000, 100, 256, 1024),          # S < ts: one 100-row tile
        "small_target": (200, 300, 128, 4096),      # window = padded target
        "wide_tile": (20000, 3000, 1000, 2048),     # several passes a tile
    }[name]
    src, tgt, mask, normals = _slab_case(_gen(n_src), n_tgt, n_src, 50.0,
                                         masked=True)
    if name == "sentinel_tile":
        src[-300:] = knn_cuda.SENTINEL  # as the ICP displaces invalid rows
    src, tgt, mask, normals = (_dev(x, cuda) for x in (src, tgt, mask, normals))
    index = knn_cuda._build_slab_index(tgt, mask, normals)
    before = knn_cuda.MATCH_SLAB.launches
    out_k = knn_cuda._slab_query(src, index, ts, window, 3.0)
    assert knn_cuda.MATCH_SLAB.launches == before + 1
    out_p = knn_cuda._slab_query(src, index, ts, window, 3.0,
                                 knn_cuda._slab_query_plain)
    for a, b in zip(out_k, out_p):  # qn, d2, idx, starts
        assert a.shape == b.shape
        _exact(a, b)
    ts_eff = min(ts, max(8, n_src))
    src_p = knn_cuda._pad_rows(src, ts_eff, knn_cuda.SENTINEL)
    _exact(out_k[3], knn_cuda._slab_starts_lut(
        src_p, index, ts_eff, min(window, index.padded_T), 3.0))


def test_cuda_wrappers_refuse_other_devices():
    """A tensor on an unsupported device is refused, not sent to the plain
    version."""
    src = torch.zeros((4, 3), device="meta")
    with pytest.raises(ValueError):
        knn_cuda.nn1(src, src, torch.ones(4, dtype=torch.bool, device="meta"))


def test_kernel_build_is_keyed_on_the_source():
    path = knn_cuda.library_path()
    assert path.parent == knn_cuda.BUILD_DIR
    assert path.name.startswith("libknn_") and path.suffix == ".so"
    assert knn_cuda.KERNEL_SOURCE.exists()


@pytest.mark.gpu
def test_engine_on_gpu_matches_cpu(cuda):
    """The slice at tiny shapes: the engine on the card (K1, K2) against the
    same engine on the CPU (plain versions). The kernels are exact; the rest
    differs only in reduction order, so poses agree to 1e-3 m."""
    from lidar_slam_tpu_torch.config import fast_mode, tiny_config
    from lidar_slam_tpu_torch.models.pipeline import SlamEngine
    from lidar_slam_tpu_torch.utils.dataset import (
        generate_trajectory,
        generate_world,
        render_scan,
        route_half_for,
    )
    from lidar_slam_tpu_torch.utils.native import voxel_downsample_host

    n = 40
    half = route_half_for(n)
    world = generate_world(0, route_half=half)
    gt = generate_trajectory(n, half=half)
    g = np.random.default_rng(0)
    scans = [voxel_downsample_host(render_scan(world, gt[i], g, max_range=15.0,
                                               max_points=20000), 0.5, 2048)
             for i in range(n)]
    cfg = fast_mode(tiny_config(
        max_raw_points=2048, max_points=2048, lc_cloud_points=0, max_frames=48,
        max_loop_factors=16,
    )).replace(host_voxelize=True, slab_window=1024, normal_window=1024)
    runs = {}
    for dev in ("cpu", cuda):
        for k in knn_cuda.KERNELS:
            k.launches = 0
        eng = SlamEngine(cfg, dev)
        eng.preload(scans)
        eng.run_preloaded()
        eng.finalize()
        runs[str(dev)] = (eng.trajectory(), eng.metrics(), eng.loop_pairs(),
                          {k.name: k.launches for k in knn_cuda.KERNELS})
    (t_c, m_c, p_c, l_c), (t_g, m_g, p_g, l_g) = runs["cpu"], runs[str(cuda)]
    assert l_c == {"match_slab": 0, "nn1": 0}
    assert l_g["match_slab"] > 0 and l_g["nn1"] > 0
    assert p_g == p_c and len(p_c) >= 1
    assert np.abs(t_g[:, :3, 3] - t_c[:, :3, 3]).max() < 1e-3
    assert np.mean(m_g["icp_iters"] == m_c["icp_iters"]) >= 0.9


@pytest.mark.gpu
@pytest.mark.parametrize("lanes,n_tgt,n_src,ts,window", [
    (3, 2000, 1500, 128, 1024), (4, 32768, 4096, 256, 4096),
    (2, 20000, 3001, 256, 2048)])
def test_match_slab_kernel_over_lanes(cuda, lanes, n_tgt, n_src, ts, window):
    """K1 over lanes: one launch serves every lane, and each lane equals the
    plain version and a one-lane launch on that lane's target, bit for bit
    (matched rows, d2, indices, window starts)."""
    g = _gen(lanes)
    cases = [_slab_case(g, n_tgt, n_src, 30.0 + 10.0 * b, masked=b % 2 == 1)
             for b in range(lanes)]
    src, tgt, mask, normals = (_dev(np.stack(x), cuda) for x in zip(*cases))
    index = knn_cuda._build_slab_index(tgt, mask, normals)
    before = knn_cuda.MATCH_SLAB.launches
    out_k = knn_cuda._slab_query(src, index, ts, window, 3.0)
    assert knn_cuda.MATCH_SLAB.launches == before + 1
    out_p = knn_cuda._slab_query(src, index, ts, window, 3.0,
                                 knn_cuda._slab_query_plain)
    for a, b in zip(out_k, out_p):
        assert a.shape == b.shape
        _exact(a, b)
    for b in range(lanes):
        one = knn_cuda._build_slab_index(tgt[b], mask[b], normals[b])
        for a, c in zip(out_k, knn_cuda._slab_query(src[b], one, ts, window,
                                                    3.0)):
            _exact(a[b], c)


@pytest.mark.gpu
def test_batched_engine_on_gpu_matches_cpu(cuda):
    """The batched engine at tiny shapes, 2 lanes of different worlds: on
    the card (K1 over lanes, K2 over tranches) against the same engine on
    the CPU. Same loops; poses within 1e-3 m (the rest of the arithmetic
    differs only in reduction order)."""
    from lidar_slam_tpu_torch.config import fast_mode, tiny_config
    from lidar_slam_tpu_torch.parallel import BatchedSlamEngine
    from lidar_slam_tpu_torch.utils.dataset import (
        generate_trajectory,
        generate_world,
        render_scan,
        route_half_for,
    )
    from lidar_slam_tpu_torch.utils.native import voxel_downsample_host

    n = 40
    half = route_half_for(n)
    gt = generate_trajectory(n, half=half)
    seqs = []
    for seed in (0, 1):
        world = generate_world(seed, route_half=half)
        g = np.random.default_rng(seed)
        seqs.append([voxel_downsample_host(
            render_scan(world, gt[i], g, max_range=15.0, max_points=20000),
            0.5, 2048) for i in range(n)])
    cfg = fast_mode(tiny_config(
        max_raw_points=2048, max_points=2048, lc_cloud_points=0, max_frames=48,
        max_loop_factors=16,
    )).replace(host_voxelize=True, slab_window=1024, normal_window=1024)
    runs = {}
    for dev in ("cpu", cuda):
        for k in knn_cuda.KERNELS:
            k.launches = 0
        eng = BatchedSlamEngine(cfg, 2, dev, optimize_midrun=False)
        eng.preload(seqs)
        eng.run_preloaded()
        eng.finalize()
        runs[str(dev)] = (eng.trajectories(), eng.loop_pairs(),
                          {k.name: k.launches for k in knn_cuda.KERNELS})
    (t_c, p_c, l_c), (t_g, p_g, l_g) = runs["cpu"], runs[str(cuda)]
    assert l_c == {"match_slab": 0, "nn1": 0}
    assert l_g["match_slab"] > 0 and l_g["nn1"] > 0
    assert p_g == p_c and all(len(p) >= 1 for p in p_c)
    assert np.abs(t_g[..., :3, 3] - t_c[..., :3, 3]).max() < 1e-3


@pytest.mark.gpu
def test_normal_equations_round_the_same_for_any_lane_count(cuda):
    """On the card, one Gauss-Newton step of a lane is bit-identical alone
    and as one of 4 or 12 lanes (cuBLAS plans a batched matmul per batch
    size, so ``ops/icp.py`` forms each lane's normal equations as its own
    2-D product)."""
    from lidar_slam_tpu_torch.ops.icp import solve_point_to_plane

    rng = _gen(3)
    src = rng.normal(0, 20, (12, 4096, 3)).astype(np.float32)
    tgt = src + rng.normal(0, 0.05, src.shape).astype(np.float32)
    nrm = rng.normal(size=src.shape).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    w = rng.uniform(size=src.shape[:2]) < 0.9
    args = [_dev(x, cuda) for x in (src, tgt, nrm, w)]
    for B in (12, 4):
        lanes = solve_point_to_plane(*(a[:B] for a in args))
        for b in range(B):
            _exact(lanes[b], solve_point_to_plane(*(a[b : b + 1] for a in args))[0])
