"""Sorted-grid windowed 1-NN (port of ``lidar_slam_tpu/ops/grid_nn.py``;
the odometry backend ``knn_backend="grid"``).

The target is sorted once per ICP call by a packed (cx, cy, cz) cell key.
Each query probes its 3x3 (cx, cy) neighbour cells from cz - 1: a binary
search finds each probe's first slot, a fixed run of ``window`` sorted
slots from there covers the z range, and the exact distances to the 9 x
``window`` candidates give the first-index argmin. Exact whenever the true
neighbour lies within one cell of the query; a miss returns a farther
correspondence. Plain PyTorch; every function takes leading-dim lanes, each
lane searching its own target.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from .knn import SENTINEL

_BITS = 10
_OFF = 1 << (_BITS - 1)
_MAXQ = (1 << _BITS) - 1
_MASKED_KEY = 2**31 - 1


@dataclass
class SortedGrid:
    """Per-scan acceleration structure (the reference's per-scan KD-tree)."""

    points: torch.Tensor  # (..., T, 3) cell-key-sorted, invalid at SENTINEL
    keys: torch.Tensor    # (..., T) sorted packed keys (int32)
    order: torch.Tensor   # (..., T) original index per sorted slot (int32)
    cell: torch.Tensor    # () cell size


def _quantize(pts: torch.Tensor, cell: torch.Tensor) -> torch.Tensor:
    # a true f32 division by a tensor (see ops/normals.py)
    q = torch.floor(pts / cell).to(torch.int32) + _OFF
    return torch.clamp(q, 0, _MAXQ)


def _pack(q: torch.Tensor) -> torch.Tensor:
    return (q[..., 0] << (2 * _BITS)) | (q[..., 1] << _BITS) | q[..., 2]


def _gather_last(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (..., T), idx (..., Q) -> (..., Q)."""
    return torch.gather(x, -1, idx.to(torch.int64))


def _searchsorted_left(keys: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """Left insertion points of ``queries`` (..., Q) in ``keys`` (..., T) by
    the JAX package's unrolled ceil(log2 T)-step bisection (int32)."""
    T = keys.shape[-1]
    steps = max(int(math.ceil(math.log2(max(T, 2)))), 1)
    lo = torch.zeros(queries.shape, dtype=torch.int32, device=queries.device)
    hi = torch.full(queries.shape, T, dtype=torch.int32, device=queries.device)
    for _ in range(steps):
        mid = torch.div(lo + hi, 2, rounding_mode="floor")
        v = _gather_last(keys, torch.clamp(mid, max=T - 1))
        go_right = v < queries
        lo = torch.where(go_right, mid + 1, lo)
        hi = torch.where(go_right, hi, mid)
    return lo


def build_grid(pts: torch.Tensor, mask: torch.Tensor, cell) -> SortedGrid:
    """Sort a (..., T, 3) cloud by packed cell key (stable, as
    ``jnp.argsort``: rows of one cell keep their order); masked rows get the
    largest key and sort last."""
    cell = torch.as_tensor(cell, dtype=pts.dtype, device=pts.device)
    pts_m = torch.where(mask[..., None], pts, torch.full_like(pts, SENTINEL))
    key = torch.where(mask, _pack(_quantize(pts_m, cell)),
                      torch.full(mask.shape, _MASKED_KEY, dtype=torch.int32,
                                 device=pts.device))
    order = torch.argsort(key, dim=-1, stable=True)
    return SortedGrid(
        points=torch.gather(pts_m, -2, order[..., None].expand(*order.shape, 3)),
        keys=torch.gather(key, -1, order),
        order=order.to(torch.int32),
        cell=cell,
    )


def grid_candidates(src: torch.Tensor, grid: SortedGrid,
                    window: int = 32) -> torch.Tensor:
    """The sorted slots :func:`nn1_grid` compares for each query: (..., S,
    9 * window) int32, ``window`` slots from the first of each of the 9
    (dx, dy) probes at cz - 1, clamped to T - 1."""
    S = src.shape[-2]
    T = grid.points.shape[-2]
    dev = src.device
    qs = _quantize(src, grid.cell)
    d = torch.tensor([(dx, dy) for dx in (-1, 0, 1) for dy in (-1, 0, 1)],
                     dtype=torch.int32, device=dev)  # (9, 2)
    probe_q = torch.stack(
        [
            torch.clamp(qs[..., None, 0] + d[:, 0], 0, _MAXQ),
            torch.clamp(qs[..., None, 1] + d[:, 1], 0, _MAXQ),
            torch.clamp(qs[..., None, 2] - 1, 0, _MAXQ).expand(*qs.shape[:-1], 9),
        ],
        dim=-1,
    )  # (..., S, 9, 3)
    lead = src.shape[:-2]
    pos = _searchsorted_left(grid.keys, _pack(probe_q).reshape(*lead, S * 9))
    cand = pos.reshape(*lead, S, 9, 1) + torch.arange(
        window, dtype=torch.int32, device=dev)
    return torch.clamp(cand, max=T - 1).reshape(*lead, S, 9 * window)


def nn1_grid(src: torch.Tensor, grid: SortedGrid,
             window: int = 32) -> tuple[torch.Tensor, torch.Tensor]:
    """1-NN of (..., S, 3) queries in the sorted grid: ``(idx into the
    ORIGINAL target order (int32), squared distance)``, the contract of
    ``ops.knn.nn1``."""
    lead = src.shape[:-2]
    S = src.shape[-2]
    cand = grid_candidates(src, grid, window)               # (..., S, 9W)
    flat = cand.reshape(*lead, -1).to(torch.int64)
    cpts = torch.gather(grid.points, -2, flat[..., None].expand(*flat.shape, 3))
    cpts = cpts.reshape(*cand.shape, 3)
    dx = cpts[..., 0] - src[..., :, None, 0]
    dy = cpts[..., 1] - src[..., :, None, 1]
    dz = cpts[..., 2] - src[..., :, None, 2]
    d2 = dx * dx + dy * dy + dz * dz                        # (..., S, 9W)
    best = torch.argmin(d2, dim=-1, keepdim=True)
    best_d2 = torch.gather(d2, -1, best)[..., 0]
    best_slot = torch.gather(cand, -1, best)[..., 0]
    return _gather_last(grid.order, best_slot.reshape(*lead, S)), best_d2


def make_grid_backend(cell: float, window: int = 32):
    """ICP-injectable grid backend (``ops/icp.py``'s ``nn1_fn``), with a
    ``prepare`` attribute: the grid is built once per ICP call and queried
    every iteration."""

    def nn1_fn(src, tgt, mask):
        return nn1_grid(src, build_grid(tgt, mask, cell), window=window)

    def prepare(tgt, mask):
        grid = build_grid(tgt, mask, cell)
        return lambda src: nn1_grid(src, grid, window=window)

    nn1_fn.prepare = prepare
    return nn1_fn
