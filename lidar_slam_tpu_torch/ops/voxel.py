"""Device-side voxel-grid downsampling with a fixed output shape (port of
``lidar_slam_tpu/ops/voxel.py``).

Replaces the reference's host hash map (file_utils.cpp:148-196:
floor(p / voxel) key -> bucket -> centroid) with sort-based segmentation:
quantize each point to a packed int32 voxel key, sort (stably), find the
segment of each voxel in the sorted order and reduce each segment to its
centroid.

Key packing uses 10 bits per axis, so coordinates must lie within
+-511 * voxel_size of the origin (+-255 m at the default 0.5 m voxel, beyond
any LiDAR return in the sensor frame). Out-of-range points are clamped.

The output is ordered by voxel key (x-major), the order the slab searches
and the slab normals rely on. If more than ``out_size`` voxels are occupied,
an evenly strided subset over the key-sorted uniques is kept:
strided-over-sorted is spatially uniform, where a sorted-prefix cut would
keep only the low-x slab of the scene.

**Determinism.** The JAX version sums each voxel with a scatter-add. On a
GPU a scatter-add (``index_add_``) is a set of atomic adds in no fixed
order, so two runs could differ in the last bit and a run resumed from a
checkpoint would not repeat the uninterrupted one. The points of a voxel are
contiguous after the sort, so each voxel is summed here by
``torch.segment_reduce`` over its run instead: one sequential sum per
segment, in the sorted (stable) order, the same on every run and the order
in which a sequential scatter-add visits them. Against the JAX function on
the same input: the mask and the set of occupied voxels are equal exactly,
the centroids to 1e-5 m (``tests/test_torch_ops.py``).
"""

from __future__ import annotations

import torch

from ..types import PointCloud

_AXIS_BITS = 10
_AXIS_OFF = 1 << (_AXIS_BITS - 1)  # 512
_AXIS_MAX = (1 << _AXIS_BITS) - 1  # 1023
_INVALID_KEY = 2**31 - 1


def voxel_keys(pts: torch.Tensor, mask: torch.Tensor,
               voxel_size: float) -> torch.Tensor:
    """Packed int32 voxel key of every point; masked rows get the largest
    key, so they sort behind every voxel."""
    vs = torch.tensor(voxel_size, dtype=pts.dtype, device=pts.device)
    q = torch.floor(pts / vs).to(torch.int32) + _AXIS_OFF
    q = torch.clamp(q, 0, _AXIS_MAX)
    key = (q[:, 0] << (2 * _AXIS_BITS)) | (q[:, 1] << _AXIS_BITS) | q[:, 2]
    return torch.where(mask, key, torch.full_like(key, _INVALID_KEY))


def voxel_downsample(pts: torch.Tensor, mask: torch.Tensor, voxel_size: float,
                     out_size: int) -> PointCloud:
    """Centroid-per-voxel downsample of a padded cloud.

    ``pts`` (N, 3) float32 padded points, ``mask`` (N,) validity. With
    ``voxel_size <= 0`` the input passes through, truncated or padded to
    ``out_size`` (reference pass-through, file_utils.cpp:153). Returns a
    cloud of (out_size, 3) centroids with its mask."""
    N = pts.shape[0]
    dev = pts.device
    if voxel_size <= 0:
        out_pts = torch.zeros((out_size, 3), dtype=pts.dtype, device=dev)
        out_mask = torch.zeros((out_size,), dtype=torch.bool, device=dev)
        n = min(N, out_size)
        out_pts[:n], out_mask[:n] = pts[:n], mask[:n]
        return PointCloud(
            torch.where(out_mask[:, None], out_pts, torch.zeros_like(out_pts)),
            out_mask,
        )

    key = voxel_keys(pts, mask, voxel_size)
    key_s, order = torch.sort(key, stable=True)
    pts_s = pts[order]
    valid_s = key_s != _INVALID_KEY

    is_start = torch.ones_like(valid_s)
    is_start[1:] = key_s[1:] != key_s[:-1]
    is_start &= valid_s
    seg = torch.cumsum(is_start.to(torch.int64), 0) - 1  # voxel id per point
    n_unique = torch.sum(is_start.to(torch.int64))

    # Segment u of the sorted points is voxel u (up to N of them); the
    # invalid rows, which sorted last, are segment N. ``slot`` is
    # non-decreasing, so the segments' bounds are a searchsorted.
    slot = torch.where(valid_s, seg, torch.full_like(seg, N))
    bounds = torch.searchsorted(
        slot, torch.arange(N + 2, dtype=torch.int64, device=dev)
    )
    lengths = bounds[1:] - bounds[:-1]                          # (N + 1,)
    sums = torch.segment_reduce(pts_s, "sum", lengths=lengths, axis=0,
                                unsafe=True)                    # (N + 1, 3)
    counts = lengths.to(pts.dtype)

    j = torch.arange(out_size, dtype=torch.int64, device=dev)
    pick = torch.where(n_unique > out_size, (j * n_unique) // out_size, j)
    pick = torch.clamp(pick, max=N)  # out_size > N: the empty tail
    centroids = sums[pick] / torch.clamp(counts[pick], min=1.0)[:, None]
    out_mask = j < torch.clamp(n_unique, max=out_size)
    return PointCloud(
        torch.where(out_mask[:, None], centroids, torch.zeros_like(centroids)),
        out_mask,
    )
