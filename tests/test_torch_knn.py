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


def _merge_key(d2, idx):
    """The kernels' merge key, (bits(d2) << 32) | idx, as int64. For
    d2 >= +0 (a sum of squares) the f32 bits order as integers and stay
    below 2^31, so the signed int64 min is the kernels' unsigned min."""
    bits = d2.to(torch.float32).contiguous().view(torch.int32).to(torch.int64)
    return (bits << 32) | idx.to(torch.int64)


def _split_key(key):
    return ((key & 0xFFFFFFFF).to(torch.int32),
            (key >> 32).to(torch.int32).view(torch.float32))


@pytest.mark.parametrize("chunk", [1, 7, 16, 64, 100, 256, 300])
def test_key_merge_keeps_first_index_minimum(rng, chunk):
    """The kernels' merge rule in plain torch: split each row's candidates
    into chunks, take per-chunk first-index minima, merge by the 64-bit key
    (d2 bits, index) with an integer min in any order; the result is
    torch.min over the whole row, ties and a zero distance included."""
    S, T = 48, 300
    tgt = (rng.normal(size=(T, 3)) * 5).astype(np.float32)
    src = (rng.normal(size=(S, 3)) * 5).astype(np.float32)
    b = min(chunk, T - 1)          # a chunk boundary (or the last row)
    tgt[b] = tgt[b - 1]            # equal rows on both sides of it
    tgt[(b + 150) % T] = tgt[b - 1]  # ... and far away
    src[0] = tgt[b - 1]            # d2 == 0 to all three
    src[1] = tgt[b - 1] + np.float32(0.01)  # a positive exact tie
    d2 = knn_cuda.sq_dist(_t(src), _t(tgt))          # (S, T)
    keys = []
    for off in range(0, T, chunk):
        local_d, local_i = torch.min(d2[:, off:off + chunk], dim=1)
        keys.append(_merge_key(local_d, local_i + off))
    order = rng.permutation(len(keys))
    merged = torch.stack([keys[i] for i in order]).min(dim=0).values
    idx, dist = _split_key(merged)
    want_d, want_i = torch.min(d2, dim=1)
    np.testing.assert_array_equal(idx.numpy(), want_i.numpy())
    np.testing.assert_array_equal(dist.numpy(), want_d.numpy())
    first = min(b - 1, (b + 150) % T)
    assert int(idx[0]) == first and float(dist[0]) == 0.0
    assert int(idx[1]) == first and float(dist[1]) > 0.0


def _dyadic_case(rng, name):
    """Coordinates on a 0.25 grid within +-16: every product and sum is exact
    in f32, so the difference form (the port, the Pallas kernel) and the
    |s|^2+|t|^2-2s.t form (the JAX package's XLA nn1) agree to the bit."""
    T, S = 512, 96
    tgt = rng.integers(-64, 65, size=(T, 3)).astype(np.float32) / 4
    src = rng.integers(-64, 65, size=(S, 3)).astype(np.float32) / 4
    mask = np.ones(T, bool)
    if name == "masked":
        mask[300:] = False
    else:  # tie: the second half repeats the first
        tgt[256:] = tgt[:256]
        src[:10] = tgt[250:260]
    return src, tgt, mask


@pytest.mark.parametrize("name", ["masked", "tie"])
def test_nn1_prepare_matches_nn1_and_jax(rng, name):
    from lidar_slam_tpu.ops import knn as knn_jax

    src, tgt, mask = _dyadic_case(rng, name)
    query = knn_cuda.nn1.prepare(_t(tgt[None]), _t(mask[None]))
    idx_q, d2_q = query(_t(src[None]))
    idx_n, d2_n = knn_cuda.nn1(_t(src[None]), _t(tgt[None]), _t(mask[None]))
    np.testing.assert_array_equal(idx_q.numpy(), idx_n.numpy())
    np.testing.assert_array_equal(d2_q.numpy(), d2_n.numpy())
    args = (jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(mask))
    for idx_j, d2_j in (
        knn_jax.nn1(*args, chunk=128),
        knn_pallas.nn1_pallas(*args, ts=32, tt=128, interpret=True),
    ):
        np.testing.assert_array_equal(idx_q[0].numpy(), np.asarray(idx_j))
        np.testing.assert_allclose(d2_q[0].numpy(), np.asarray(d2_j),
                                   rtol=1e-6, atol=0)
    assert idx_q.max() < (300 if name == "masked" else 256)


def test_nn1_plan_covers_the_target():
    """Every split of a K2 launch holds at least one tile and together they
    hold all of them; a few hundred blocks at the main path's shapes."""
    for lanes, S, Tp in [(3, 4096, 32768), (1, 4096, 32768), (1, 5, 512),
                         (8, 100000, 1024), (2, 777, 30208),
                         (1, 32768, 32768), (3, 32768, 32768)]:
        n_split, per = knn_cuda._nn1_plan(lanes, S, Tp, 132)
        n_tiles = Tp // knn_cuda._NN1_TILE
        assert (n_split - 1) * per < n_tiles <= n_split * per
    assert knn_cuda._nn1_plan(3, 4096, 32768, 132) == (11, 6)
    assert knn_cuda._nn1_plan(1, 4096, 32768, 132) == (32, 2)
    # the exact modes' shapes (fidelity odometry, full-density verification):
    # 320 and 384 blocks, within the grid's limits
    assert knn_cuda._nn1_plan(1, 32768, 32768, 132) == (5, 13)
    assert knn_cuda._nn1_plan(3, 32768, 32768, 132) == (2, 32)
