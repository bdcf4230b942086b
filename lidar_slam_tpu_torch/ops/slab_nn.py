"""Slab-pruned 1-NN (port of ``lidar_slam_tpu/ops/slab_nn.py``; the odometry
backend ``knn_backend="slab"``).

Clouds leave the voxelizer in x-major key order, so for a tile of ``ts``
consecutive source points every target within ``margin`` of the tile in x
lies in one contiguous range of the target. Each tile searches a fixed
``window`` of consecutive targets, starting where a binary search over the
running max of the masked target's x finds ``min(tile x) - margin``, clipped
to ``[0, T - window]``; the first-index argmin of the difference-form
distance gives the neighbour. Exact whenever the true neighbour lies within
``margin`` of the query in x and inside the window.

This is not K1 (``ops/knn_cuda.py``): K1 takes its window starts from a
rounded lookup table and has no margin. Plain PyTorch; leading-dim lanes,
each against its own target.
"""

from __future__ import annotations

import torch

from .grid_nn import _searchsorted_left
from .knn import SENTINEL, sq_dist

_CHUNK_ELEMS = 1 << 26  # distance-block elements per chunk of tiles


def slab_windows(src: torch.Tensor, tgt: torch.Tensor, tgt_mask: torch.Tensor,
                 ts: int = 256, window: int = 4096, margin: float = 3.0):
    """The search of :func:`nn1_slab`: ``(tiles (..., n, ts, 3), starts
    (..., n) int64, ts, window, tgt_m)``: tile t of the source searches
    targets ``[starts[t], starts[t] + window)`` of ``tgt_m`` (the target with
    invalid rows at the sentinel)."""
    S = src.shape[-2]
    T = tgt.shape[-2]
    ts = min(ts, S)
    while S % ts:
        ts -= 1
    window = min(window, T)
    tgt_m = torch.where(tgt_mask[..., None], tgt, torch.full_like(tgt, SENTINEL))
    # x-major key order is x-monotone only at voxel granularity: search the
    # running max of x, which is monotone and >= x, so a start is never late
    x_mono = torch.cummax(tgt_m[..., 0], dim=-1).values
    tiles = src.reshape(*src.shape[:-2], S // ts, ts, 3)
    tile_min_x = torch.min(tiles[..., 0], dim=-1).values - margin
    starts = _searchsorted_left(x_mono, tile_min_x)
    starts = torch.clamp(starts, 0, max(T - window, 0)).to(torch.int64)
    return tiles, starts, ts, window, tgt_m


def nn1_slab(
    src: torch.Tensor,
    tgt: torch.Tensor,
    tgt_mask: torch.Tensor,
    ts: int = 256,
    window: int = 4096,
    margin: float = 3.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """1-NN with x-slab pruning: ``src`` (..., S, 3), ``tgt`` (..., T, 3),
    ``tgt_mask`` (..., T) -> ``(idx (..., S) int32, d2 (..., S))``. ``ts``
    shrinks until it divides S."""
    lead = src.shape[:-2]
    tiles, starts, ts, window, tgt_m = slab_windows(src, tgt, tgt_mask, ts,
                                                    window, margin)
    n_tiles = tiles.shape[-3]
    cols = torch.arange(window, device=src.device)
    step = max(1, _CHUNK_ELEMS // (ts * window))
    idx_parts, d2_parts = [], []
    for t0 in range(0, n_tiles, step):
        st = starts[..., t0 : t0 + step]                   # (..., n)
        win_idx = st[..., None] + cols                     # (..., n, W)
        flat = win_idx.reshape(*lead, -1)
        win = torch.gather(tgt_m, -2, flat[..., None].expand(*flat.shape, 3))
        win = win.reshape(*win_idx.shape, 3)               # (..., n, W, 3)
        d2 = sq_dist(tiles[..., t0 : t0 + step, :, :], win)  # (..., n, ts, W)
        loc = torch.argmin(d2, dim=-1, keepdim=True)
        d2_parts.append(torch.gather(d2, -1, loc)[..., 0])
        idx_parts.append(loc[..., 0] + st[..., None])
    S = src.shape[-2]
    idx = torch.cat(idx_parts, dim=-2).reshape(*lead, S).to(torch.int32)
    d2 = torch.cat(d2_parts, dim=-2).reshape(*lead, S)
    return idx, d2
