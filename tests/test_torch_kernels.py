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

from lidar_slam_tpu_torch.ops import cuda_lib, knn_cuda

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
    path = knn_cuda.LIBRARY.path
    assert path.parent == cuda_lib.BUILD_DIR
    assert path.name.startswith("libknn_") and path.suffix == ".so"
    assert knn_cuda.LIBRARY.source.exists()


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


@pytest.mark.gpu
def test_plane_error_rounds_the_same_for_any_lane_count(cuda):
    """On the card, a lane's plane error (the ICP's convergence test) is
    bit-identical alone and as one of 2 or 6 lanes at the odometry's 4,096
    and full-density 32,768 rows: a row sum over a batch is split over
    blocks by the batch's size, so ``ops/icp.py`` sums each lane alone."""
    from lidar_slam_tpu_torch.ops.icp import _plane_error

    rng = _gen(4)
    for S in (4096, 32768):
        cur = rng.normal(0, 20, (6, S, 3)).astype(np.float32)
        matched = cur + rng.normal(0, 0.05, cur.shape).astype(np.float32)
        nrm = rng.normal(size=cur.shape).astype(np.float32)
        nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
        w = (rng.uniform(size=cur.shape[:2]) < 0.9).astype(np.float32)
        args = [_dev(x, cuda) for x in (cur, matched, nrm, w)]
        denom = args[3].sum(-1)
        for B in (6, 2):
            lanes = _plane_error(*(a[:B] for a in args), denom[:B])
            for b in range(B):
                _exact(lanes[b], _plane_error(*(a[b : b + 1] for a in args),
                                              denom[b : b + 1])[0])


# ---------------------------------------------------------------------------
# icp_step (csrc/icp_step.cu) against its plain version, icp_step_torch. The
# two sum the rows in another order (the kernel: 4 rows a thread, a warp
# butterfly, the warps and then the blocks in order; the plain version:
# cuBLAS products and torch sums), so the normal equations differ in the
# last bits of their sums; every elementwise step rounds alike.
# ---------------------------------------------------------------------------


def _rodrigues(w):
    th = np.linalg.norm(w)
    k = w / th
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K


def _icp_step_case(seed, lanes, N, route, dev):
    """``(src, mask, match, T0)``: each lane's sources, fixed correspondences
    of a small known motion with 1 cm of noise (K1's packed rows read
    through strides, or K2's int32 index into shuffled targets), a fifth of
    the rows and a block of 300 masked, and a start near the identity."""
    g = _gen(seed)
    src = (g.normal(size=(lanes, N, 3)) * [20, 20, 3]).astype(np.float32)
    nrm = g.normal(size=(lanes, N, 3))
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    tgt = np.empty_like(src)
    for b in range(lanes):
        R = _rodrigues(g.normal(0, 0.03, 3))
        tgt[b] = src[b] @ R.T + g.normal(0, 0.4, 3) + g.normal(0, 0.01, (N, 3))
    mask = g.uniform(size=(lanes, N)) > 0.2
    mask[:, N // 3: N // 3 + 300] = False
    T0 = np.tile(np.eye(4, dtype=np.float32), (lanes, 1, 1))
    T0[:, :3, 3] = g.normal(0, 0.05, (lanes, 3))
    s, m, T = (_dev(x, dev) for x in (src, mask, T0))
    if route == "k1":
        qn = np.zeros((lanes, N, 8), np.float32)
        qn[..., 0:3], qn[..., 3:6] = tgt, nrm
        q = _dev(qn, dev)
        match = (q[..., 0:3], q[..., 3:6], None)
    else:
        M = N + 37
        perm = np.stack([g.permutation(M)[:N] for _ in range(lanes)])
        pts = (g.normal(size=(lanes, M, 3)) * 50).astype(np.float32)
        tn = np.tile(np.float32([0, 0, 1]), (lanes, M, 1))
        for b in range(lanes):
            pts[b, perm[b]], tn[b, perm[b]] = tgt[b], nrm[b]
        match = (_dev(pts, dev), _dev(tn.astype(np.float32), dev),
                 _dev(perm.astype(np.int32), dev))
    return s, m, match, T


def _icp_states(T, lanes, mode, dev, max_it=6):
    from lidar_slam_tpu_torch.ops import icp_cuda

    def one():
        conv = None
        if mode != "coarse":
            conv = torch.zeros(lanes, dtype=torch.bool, device=dev)
            if lanes == 3:
                conv[1] = True  # a lane inactive from the start stays frozen
        return icp_cuda.new_state(T.clone(), 1e-9, conv, max_it, 1e-9, 1e-6)

    return one(), one()


def _close_T(a, b):
    """Translations within 1e-5 m, rotations within 1e-6 (rad, per entry)."""
    torch.testing.assert_close(a[..., :3, 3], b[..., :3, 3], rtol=0, atol=1e-5)
    torch.testing.assert_close(a[..., :3, :3], b[..., :3, :3], rtol=0,
                               atol=1e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["coarse", "step"])
@pytest.mark.parametrize("route", ["k1", "k2"])
@pytest.mark.parametrize("N", [512, 4096, 32768])
@pytest.mark.parametrize("lanes", [1, 3])
def test_icp_step_kernel_matches_plain(cuda, lanes, N, route, mode):
    """Six iterations, each from the same state on both sides (the plain
    state is set to the kernel's after each comparison): ``apply`` within
    3e-5 m of ``se3.apply`` (4 ulps at the 64-128 m of the largest
    products: cuBLAS contracts them into FMAs, the kernel does not); T
    within 1e-5 m / 1e-6 rad, ``converged`` and
    ``it`` equal, the error history within 1e-6 relative, the loop flags
    equal; then ``final``'s errors within 1e-6 relative."""
    from lidar_slam_tpu_torch.ops import icp_cuda, se3
    from lidar_slam_tpu_torch.ops.icp import icp_step_torch

    src, mask, match, T = _icp_step_case(N + lanes, lanes, N, route, cuda)
    st_k, st_p = _icp_states(T, lanes, mode, cuda)
    cur = torch.empty_like(src)
    for _ in range(6):
        icp_cuda.launch("apply", st_k, cur, src=src)
        torch.testing.assert_close(cur, se3.apply(st_k.T, src), rtol=0,
                                   atol=3e-5)
        before = icp_cuda.ICP_STEP.launches
        icp_cuda.launch(mode, st_k, cur, mask=mask, match=match)
        assert icp_cuda.ICP_STEP.launches == before + 1
        icp_step_torch(mode, st_p, cur, mask=mask, match=match)
        torch.cuda.synchronize()
        _close_T(st_k.T, st_p.T)
        if mode == "step":
            _exact(st_k.it, st_p.it)
            _exact(st_k.converged, st_p.converged)
            _exact(st_k.flags, st_p.flags)
            torch.testing.assert_close(st_k.hist, st_p.hist, rtol=1e-6, atol=0)
            torch.testing.assert_close(st_k.prev_err, st_p.prev_err, rtol=1e-6,
                                       atol=0)
            for name in ("it", "prev_err", "converged", "hist"):
                getattr(st_p, name).copy_(getattr(st_k, name))
        st_p.T.copy_(st_k.T)
    if mode == "step":
        assert int(st_k.it.max()) > 1
        if lanes == 3:
            assert int(st_k.it[1]) == 0 and torch.equal(st_k.T[1], T[1])
    icp_cuda.launch("apply", st_k, cur, src=src)
    icp_cuda.launch("final", st_k, cur, mask=mask, match=match)
    icp_step_torch("final", st_p, cur, mask=mask, match=match)
    torch.testing.assert_close(st_k.err, st_p.err, rtol=1e-6, atol=0)
    if mode == "step":
        torch.testing.assert_close(st_k.hist, st_p.hist, rtol=1e-6, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("N,route", [(512, "k2"), (4096, "k1"),
                                     (32768, "k2")])
def test_icp_step_lane_alone_equals_lane_in_batch(cuda, N, route):
    """The kernel's reduction depends on the row count alone: a lane run
    alone and the same lane in a 3-lane launch give bit-identical T,
    ``it``, error history and final error."""
    from lidar_slam_tpu_torch.ops import icp_cuda

    src, mask, match, T = _icp_step_case(5, 3, N, route, cuda)

    def run(sl):
        conv = torch.zeros(sl.stop - sl.start, dtype=torch.bool, device=cuda)
        st = icp_cuda.new_state(T[sl].clone(), 1e-9, conv, 6, 1e-9, 1e-6)
        s, m = src[sl], mask[sl]
        mt = tuple(None if x is None else x[sl] for x in match)
        cur = torch.empty_like(s)
        for _ in range(6):
            icp_cuda.launch("apply", st, cur, src=s)
            icp_cuda.launch("step", st, cur, mask=m, match=mt)
        icp_cuda.launch("apply", st, cur, src=s)
        icp_cuda.launch("final", st, cur, mask=m, match=mt)
        return st

    batch = run(slice(0, 3))
    for b in range(3):
        one = run(slice(b, b + 1))
        for name in ("T", "it", "hist", "err"):
            _exact(getattr(batch, name)[b], getattr(one, name)[0])


@pytest.mark.gpu
def test_icp_step_refuses_float64_and_other_devices(cuda):
    from lidar_slam_tpu_torch.ops import icp_cuda

    src, mask, match, T = _icp_step_case(1, 1, 512, "k2", cuda)
    st, _ = _icp_states(T, 1, "step", cuda)
    before = icp_cuda.ICP_STEP.launches
    cur = torch.empty_like(src)
    with pytest.raises(ValueError):
        icp_cuda.launch("apply", st, cur.double(), src=src.double())
    with pytest.raises(ValueError):
        icp_cuda.launch("apply", st, cur, src=src.cpu())
    with pytest.raises(ValueError):
        icp_cuda.launch("step", st, cur, mask=mask.cpu(), match=match)
    with pytest.raises(ValueError):
        icp_cuda.launch("step", st, cur, mask=mask,
                        match=(match[0], match[1], match[2].long()))
    st64, _ = _icp_states(T.double(), 1, "step", cuda)
    with pytest.raises(ValueError):
        icp_cuda.launch("apply", st64, cur, src=src)
    assert icp_cuda.ICP_STEP.launches == before


def _drive_clouds(dev, n=21, rows=32768):
    """The first ``n`` frames of a rendered drive (``utils.dataset``: the
    corridor world, 65,536 raw points voxelized at 0.5 m to ``rows`` rows,
    with the targets' adaptive normals, as on the engine's path: the
    route of ``chip_smoke.py``)."""
    from lidar_slam_tpu_torch.ops.normals import estimate_normals_adaptive
    from lidar_slam_tpu_torch.types import PointCloud
    from lidar_slam_tpu_torch.utils.dataset import (
        ScanRenderer,
        generate_trajectory,
        generate_world,
        route_half_for,
    )
    from lidar_slam_tpu_torch.utils.native import voxel_downsample_host

    half = route_half_for(500)
    renderer = ScanRenderer(generate_world(0, route_half=half, corridor=60.0))
    gt = generate_trajectory(500, half=half)
    g = _gen(0)
    clouds = []
    for i in range(n):
        v = voxel_downsample_host(renderer.render(gt[i], g, max_points=65536),
                                  0.5, rows)
        pts = np.zeros((rows, 3), np.float32)
        pts[: len(v)] = v
        p = _dev(pts, dev)
        m = _dev(np.arange(rows) < len(v), dev)
        nrm = estimate_normals_adaptive(p, m, r_min=1.2, window=4096,
                                        probe_stride=2)
        clouds.append((PointCloud(p, m), nrm))
    return clouds


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["fast", "fidelity"])
def test_icp_on_card_matches_plain_over_a_drive(cuda, mode):
    """Each of a drive's first 20 frames registered onto its predecessor on
    the card: ``icp_point_to_plane`` (``icp_step``) against the same call
    with the plain step (``icp_step_torch``), fast mode's K1 route (4,096
    sources, warm start from the previous delta) and fidelity's K2 route
    (32,768 x 32,768, 50 iterations). The correspondence kernels are exact
    on both sides, so the runs part only by the sums' order in each
    iteration: on every frame where the two take the same iterations and
    agree on convergence (18 of 20 at least), translations within 1e-4 m
    and rotations within 1e-5 per entry; elsewhere a stop on an error
    change near the tolerance came an iteration apart, and the two lie a
    last, small Gauss-Newton step apart: 1e-2 m, 1e-3."""
    from lidar_slam_tpu_torch.config import apply_mode, slice_config
    from lidar_slam_tpu_torch.models.pipeline import resolve_nn1
    from lidar_slam_tpu_torch.ops import icp, icp_cuda

    cfg = apply_mode(slice_config(), mode)
    nn1_fn = resolve_nn1(cfg)
    clouds = _drive_clouds(cuda)
    before = icp_cuda.ICP_STEP.launches
    same, delta = 0, None
    for i in range(1, len(clouds)):
        (src, _), (tgt, nrm) = clouds[i], clouds[i - 1]
        init = delta if cfg.icp.warm_start else None
        got = icp._icp(src, tgt, nrm, cfg.icp, init, nn1_fn, None)
        ref = icp._icp(src, tgt, nrm, cfg.icp, init, nn1_fn, None,
                       launch=icp.icp_step_torch)
        alike = (int(got.num_iterations) == int(ref.num_iterations)
                 and bool(got.converged) == bool(ref.converged))
        _close_T_drive(got.transformation, ref.transformation,
                       1.0 if alike else 100.0)
        same += alike
        delta = got.transformation
    assert icp_cuda.ICP_STEP.launches > before
    assert same >= 18


def _close_T_drive(a, b, scale):
    torch.testing.assert_close(a[:3, 3], b[:3, 3], rtol=0, atol=1e-4 * scale)
    torch.testing.assert_close(a[:3, :3], b[:3, :3], rtol=0, atol=1e-5 * scale)


@pytest.mark.gpu
def test_iter_spans_count_every_iteration_on_card(cuda):
    """The engine on the card with tracing on: every ICP loop pass is one
    ``iter`` span with one ``icp_step`` ``step`` launch, each odometry
    ICP's ``iter`` spans its iteration count, and every ``icp`` span
    launched ``icp_step``."""
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
    eng = SlamEngine(cfg, cuda, trace=True)
    eng.reset()
    for s in scans:
        eng.push_scan(s)
    m = eng.metrics()
    spans = m["trace"]["spans"]
    iters = [s for s in spans if s["name"] == "iter"]
    assert iters
    for i, s in enumerate(spans):
        if s["name"] == "iter":
            kernels = [t["kernel"] for t in spans
                       if t["name"] == "launch" and t["parent"] == i]
            assert kernels in (["icp_step", "match_slab", "icp_step"],
                               ["icp_step", "nn1", "icp_step"])
    for i, s in enumerate(spans):
        if s["name"] != "icp":
            continue
        assert s["launches"]["icp_step"] > 0
        if spans[s["parent"]]["name"] == "step":
            mine = sum(1 for t in iters if t["parent"] == i)
            assert mine == m["icp_iters"][s["frame"]]
    assert m["loop_count"] >= 1
