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
                                       (2, 4096, 32768)])
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
