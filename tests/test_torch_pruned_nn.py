"""The pruned odometry 1-NN searches of the port (``ops/slab_nn.py``,
``ops/grid_nn.py``: ``knn_backend="slab"`` and ``"grid"``) against the JAX
package's on the same host-voxelized, x-sorted clouds, one lane and a batch
of lanes, each lane equal to itself alone.

Tolerances: the grid's keys, order and sorted points, every index and the
binary search are equal. The squared distances of both searches are equal
to 1e-6 relative, as in ``test_torch_knn.py``: XLA's CPU backend contracts
the sum of squares into FMAs (``fma(dz, dz, fma(dx, dx, dy*dy))`` for the
slab's ``dx*dx + dy*dy + dz*dz``), while the port evaluates it without FMA,
as the TPU and the port's kernels do (a last-bit difference in ~20% of the
rows, never a different index here).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidar_slam_tpu.ops import grid_nn as jgrid
from lidar_slam_tpu.ops import slab_nn as jslab
from lidar_slam_tpu_torch.ops import grid_nn, slab_nn
from lidar_slam_tpu_torch.utils.dataset import (
    generate_trajectory,
    generate_world,
    render_scan,
    route_half_for,
)
from lidar_slam_tpu_torch.utils.native import voxel_downsample_host

torch.set_num_threads(2)

CAP = 2048


@pytest.fixture(scope="module")
def clouds():
    """Four padded, x-sorted 2,048-row clouds of consecutive frames (a
    masked tail on each)."""
    half = route_half_for(60)
    world = generate_world(0, route_half=half)
    gt = generate_trajectory(60, half=half)
    rng = np.random.default_rng(3)
    out = []
    for f in (7, 8, 20, 21):
        s = render_scan(world, gt[f], rng, max_range=20.0, max_points=8000)
        v = voxel_downsample_host(s, 0.5, CAP - 100)
        pts = np.zeros((CAP, 3), np.float32)
        pts[: len(v)] = v
        out.append((pts, np.arange(CAP) < len(v)))
    return out


def _src(pts, mask, n, shift=(0.3, -0.2, 0.05)):
    """A source of ``n`` rows: the cloud moved a little, invalid rows at the
    sentinel (as the ICP hands them over)."""
    s = np.where(mask[:, None], pts + np.float32(shift), np.float32(1.0e6))
    return np.ascontiguousarray(s[:n].astype(np.float32))


def _eq(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _eq_nn(got, want):
    """Indices equal; d2 to 1e-6 relative (XLA's FMA, see above)."""
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=1e-6,
                               atol=0)


def test_searchsorted_left_matches_jax(rng):
    keys = np.sort(rng.integers(0, 50, 300)).astype(np.int32)  # duplicates
    q = rng.integers(-5, 60, 777).astype(np.int32)
    _eq([grid_nn._searchsorted_left(torch.from_numpy(keys), torch.from_numpy(q))],
        [jgrid._searchsorted_left(jnp.asarray(keys), jnp.asarray(q))])
    x = np.maximum.accumulate(rng.normal(size=1000).astype(np.float32))
    qx = rng.normal(size=64).astype(np.float32)
    _eq([grid_nn._searchsorted_left(torch.from_numpy(x), torch.from_numpy(qx))],
        [jgrid._searchsorted_left(jnp.asarray(x), jnp.asarray(qx))])


@pytest.mark.parametrize("S,ts,window", [(2048, 256, 1024), (1000, 256, 512),
                                         (777, 64, 4096)])
def test_nn1_slab_matches_jax(clouds, S, ts, window):
    (tp, tm), (sp, sm) = clouds[0], clouds[1]
    src = _src(sp, sm, S)
    got = slab_nn.nn1_slab(torch.from_numpy(src), torch.from_numpy(tp),
                           torch.from_numpy(tm), ts=ts, window=window)
    want = jslab.nn1_slab(jnp.asarray(src), jnp.asarray(tp), jnp.asarray(tm),
                          ts=ts, window=window)
    _eq_nn(got, want)
    assert got[0].dtype == torch.int32


def test_nn1_slab_lanes_equal_each_lane(clouds):
    tp = np.stack([c[0] for c in clouds[::2]])
    tm = np.stack([c[1] for c in clouds[::2]])
    src = np.stack([_src(*clouds[1], 1000), _src(*clouds[3], 1000)])
    got = slab_nn.nn1_slab(torch.from_numpy(src), torch.from_numpy(tp),
                           torch.from_numpy(tm), window=512)
    for b in range(2):
        one = slab_nn.nn1_slab(torch.from_numpy(src[b]), torch.from_numpy(tp[b]),
                               torch.from_numpy(tm[b]), window=512)
        _eq([got[0][b], got[1][b]], [one[0].numpy(), one[1].numpy()])
        _eq_nn(one, jslab.nn1_slab(jnp.asarray(src[b]), jnp.asarray(tp[b]),
                                     jnp.asarray(tm[b]), window=512))


def test_build_grid_matches_jax_with_duplicate_keys(clouds):
    tp, tm = clouds[0]
    # many rows per 1 m cell: the stable sort decides their order
    for cell in (1.0, 4.0):
        g = grid_nn.build_grid(torch.from_numpy(tp), torch.from_numpy(tm), cell)
        j = jgrid.build_grid(jnp.asarray(tp), jnp.asarray(tm), cell)
        assert len(np.unique(np.asarray(j.keys))) < int(tm.sum())
        _eq([g.keys, g.order, g.points], [j.keys, j.order, j.points])
        assert g.keys.dtype == torch.int32 and g.order.dtype == torch.int32


@pytest.mark.parametrize("cell,window", [(1.0, 32), (0.5, 8)])
def test_nn1_grid_matches_jax(clouds, cell, window):
    (tp, tm), (sp, sm) = clouds[0], clouds[1]
    src = _src(sp, sm, 1500)
    g = grid_nn.build_grid(torch.from_numpy(tp), torch.from_numpy(tm), cell)
    j = jgrid.build_grid(jnp.asarray(tp), jnp.asarray(tm), cell)
    want = jgrid.nn1_grid(jnp.asarray(src), j, window=window)
    _eq_nn(grid_nn.nn1_grid(torch.from_numpy(src), g, window=window), want)
    # the ICP backend: the plain call and prepare/query
    be = grid_nn.make_grid_backend(cell, window=window)
    jbe = jgrid.make_grid_backend(cell, window=window)
    args = (torch.from_numpy(src), torch.from_numpy(tp), torch.from_numpy(tm))
    _eq_nn(be(*args), want)
    _eq_nn(be.prepare(args[1], args[2])(args[0]),
           jbe.prepare(jnp.asarray(tp), jnp.asarray(tm))(jnp.asarray(src)))


def test_nn1_grid_lanes_equal_each_lane(clouds):
    tp = np.stack([c[0] for c in clouds[::2]])
    tm = np.stack([c[1] for c in clouds[::2]])
    src = np.stack([_src(*clouds[1], 1000), _src(*clouds[3], 1000)])
    query = grid_nn.make_grid_backend(1.0).prepare(torch.from_numpy(tp),
                                                   torch.from_numpy(tm))
    got = query(torch.from_numpy(src))
    for b in range(2):
        one = grid_nn.make_grid_backend(1.0)(torch.from_numpy(src[b]),
                                             torch.from_numpy(tp[b]),
                                             torch.from_numpy(tm[b]))
        _eq([got[0][b], got[1][b]], [one[0].numpy(), one[1].numpy()])
        j = jgrid.build_grid(jnp.asarray(tp[b]), jnp.asarray(tm[b]), 1.0)
        _eq_nn(one, jgrid.nn1_grid(jnp.asarray(src[b]), j))
