"""The port's 1-NN searches against the JAX Pallas kernels (interpret mode).
The CUDA kernels are held to these plain versions in test_torch_kernels.py.

The plain versions and the Pallas kernels both evaluate squared distances in
the difference form, in the same order, so indices must be equal and d2
equal to 1e-6 (relative)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidar_slam_tpu.ops import knn_pallas
from lidar_slam_tpu_torch.ops import knn_cuda

torch.set_num_threads(2)


def _t(x):
    return torch.from_numpy(np.array(x))


def _nn1_both(src, tgt, mask, ts, tt):
    idx_j, d2_j = knn_pallas.nn1_pallas(
        jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(mask),
        ts=ts, tt=tt, interpret=True,
    )
    idx_t, d2_t = knn_cuda.nn1_torch(_t(src), _t(tgt), _t(mask))
    return (np.asarray(idx_j), np.asarray(d2_j)), (idx_t.numpy(), d2_t.numpy())


def _case(rng, name):
    if name == "random":
        src = (rng.normal(size=(300, 3)) * 20).astype(np.float32)
        tgt = (rng.normal(size=(700, 3)) * 20).astype(np.float32)
        return src, tgt, np.ones(700, bool), 64, 256
    if name == "masked":
        src = rng.normal(size=(64, 3)).astype(np.float32)
        tgt = rng.normal(size=(256, 3)).astype(np.float32)
        mask = np.zeros(256, bool)
        mask[:100] = True
        return src, tgt, mask, 64, 128
    if name == "unaligned":
        src = (rng.normal(size=(137, 3)) * 50).astype(np.float32)
        tgt = (rng.normal(size=(501, 3)) * 50).astype(np.float32)
        return src, tgt, np.ones(501, bool), 64, 128
    # exact ties: every target point appears twice, in different tiles
    base = (rng.normal(size=(200, 3)) * 10).astype(np.float32)
    tgt = np.concatenate([base, base[::-1]], axis=0)
    src = base[rng.permutation(200)[:90]] + np.float32(0.01)
    return src, tgt, np.ones(400, bool), 64, 128


@pytest.mark.parametrize("name", ["random", "masked", "unaligned", "tie"])
def test_nn1_torch_matches_pallas(rng, name):
    src, tgt, mask, ts, tt = _case(rng, name)
    (idx_j, d2_j), (idx_t, d2_t) = _nn1_both(src, tgt, mask, ts, tt)
    np.testing.assert_array_equal(idx_t, idx_j)
    np.testing.assert_allclose(d2_t, d2_j, rtol=1e-6, atol=1e-6)
    if name == "tie":  # the first of two equal copies wins
        assert idx_t.max() < 200
    if name == "masked":
        assert idx_t.max() < 100


def _sorted_cloud(rng, n, scale=30.0):
    pts = (rng.normal(size=(n, 3)) * scale).astype(np.float32)
    return pts[np.argsort(pts[:, 0])]


def _slab_case(rng, masked=False):
    tgt = _sorted_cloud(rng, 2000, scale=50.0)
    src = tgt + rng.normal(size=tgt.shape).astype(np.float32) * 0.2
    src = src[np.argsort(src[:, 0])][:1500]
    mask = np.ones(2000, bool)
    if masked:
        mask[1700:] = False
    normals = rng.normal(size=(2000, 3)).astype(np.float32)
    return src, tgt, mask, normals


@pytest.mark.parametrize("masked", [False, True])
def test_slab_torch_matches_pallas(rng, masked):
    src, tgt, mask, normals = _slab_case(rng, masked)
    kw = dict(ts=128, window=1024)
    idx_j, d2_j = knn_pallas.nn1_slab_pallas(
        jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(mask),
        interpret=True, **kw,
    )
    q_j, n_j, d2f_j = knn_pallas.match_slab_pallas(
        jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(mask),
        jnp.asarray(normals), interpret=True, **kw,
    )
    idx_t, d2_t = knn_cuda.nn1_slab_torch(_t(src), _t(tgt), _t(mask), **kw)
    q_t, n_t, d2f_t = knn_cuda.match_slab_torch(
        _t(src), _t(tgt), _t(mask), _t(normals), **kw
    )
    # window starts: the LUT arithmetic must bin exactly as the JAX glue
    index = knn_pallas._build_slab_index(
        jnp.asarray(tgt), jnp.asarray(mask), None
    )
    src_p = knn_pallas._pad_rows(jnp.asarray(src), 128, knn_pallas.SENTINEL)
    starts_j = knn_pallas._slab_starts_lut(src_p, index, 128, 1024, 3.0)
    starts_t = knn_cuda._slab_starts_lut(
        knn_cuda._pad_rows(_t(src), 128, knn_cuda.SENTINEL),
        knn_cuda._build_slab_index(_t(tgt), _t(mask), None), 128, 1024, 3.0,
    )
    np.testing.assert_array_equal(starts_t.numpy(), np.asarray(starts_j))
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    np.testing.assert_allclose(d2_t.numpy(), np.asarray(d2_j), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_array_equal(q_t.numpy(), np.asarray(q_j))
    np.testing.assert_array_equal(n_t.numpy(), np.asarray(n_j))
    # the fused gather is the row gather, bit for bit
    np.testing.assert_array_equal(q_t.numpy(), tgt[idx_t.numpy()])
    np.testing.assert_array_equal(d2f_t.numpy(), d2_t.numpy())


def test_slab_backend_prepare_match_equals_match_slab(rng):
    src, tgt, mask, normals = _slab_case(rng)
    be = knn_cuda.SlabBackend(ts=128, window=1024)
    q = be.prepare_match(_t(tgt), _t(mask), _t(normals))(_t(src))
    ref = knn_cuda.match_slab(_t(src), _t(tgt), _t(mask), _t(normals),
                              ts=128, window=1024)
    for a, b in zip(q, ref):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    idx, _ = be(_t(src), _t(tgt), _t(mask))
    np.testing.assert_array_equal(idx.numpy(), knn_cuda.nn1_slab_torch(
        _t(src), _t(tgt), _t(mask), ts=128, window=1024)[0].numpy())


def test_cpu_wrappers_use_plain_versions(rng):
    """On CPU tensors the wrappers take the plain versions and launch
    nothing."""
    src, tgt, mask, normals = _slab_case(rng)
    before = [k.launches for k in knn_cuda.KERNELS]
    a = knn_cuda.nn1(_t(src[None]), _t(tgt[None]), _t(mask[None]))
    b = knn_cuda.nn1_torch(_t(src[None]), _t(tgt[None]), _t(mask[None]))
    np.testing.assert_array_equal(a[0].numpy(), b[0].numpy())
    knn_cuda.match_slab(_t(src), _t(tgt), _t(mask), _t(normals))
    assert [k.launches for k in knn_cuda.KERNELS] == before
