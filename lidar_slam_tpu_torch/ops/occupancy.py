"""Occupancy-grid mapping (port of ``lidar_slam_tpu/ops/occupancy.py``).

A fixed dense uint8 grid centred on a configurable world origin. Each scan
marks the cells it hits inside a sensor-centred P x P patch clipped to the
grid; in-range points whose cell lies outside the grid or the clipped patch
are COUNTED (``n_dropped``), exactly as in the JAX package. The TPU's
one-hot matmul becomes a direct scatter into the grid, IN PLACE.

Filter semantics (reference slam_node.cpp:211-221): keep world points with
z in [height_min, height_max] and horizontal distance to the sensor in
[min_range, max_range]; cell = floor(xy / resolution).
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import OccupancyGridConfig


def empty_grid(config: OccupancyGridConfig, device=None) -> torch.Tensor:
    return torch.zeros((config.grid_dim, config.grid_dim), dtype=torch.uint8,
                       device=device)


def _cell(v: torch.Tensor, origin: float, res: torch.Tensor, D: int):
    # true f32 division by a tensor, as in the JAX graph
    return torch.floor((v - origin) / res).to(torch.int64) + D // 2


def update_occupancy(
    grid: torch.Tensor,
    world_pts: torch.Tensor,
    mask: torch.Tensor,
    sensor_xy: torch.Tensor,
    config: OccupancyGridConfig = OccupancyGridConfig(),
) -> torch.Tensor:
    """Mark the cells hit by world-frame scans, writing ``grid`` in place.

    ``world_pts`` (N, 3) or (B, N, 3), ``mask`` (N,) or (B, N), ``sensor_xy``
    (2,) or (B, 2): a batch of scans is marked in one scatter, each with its
    own clipped patch. Into a (D, D) grid the batch is frames of one map and
    the number of dropped in-range points is summed over it (int64 tensor,
    ()); into a (B, D, D) grid scan b marks lane b's map and the counts are
    per lane, (B,). The scatter is a set to 1 (a max), never an add."""
    if world_pts.dim() == 2:
        world_pts, mask, sensor_xy = world_pts[None], mask[None], sensor_xy[None]
    lanes = grid.dim() == 3
    D = config.grid_dim
    P = config.patch_dim
    res = torch.tensor(config.resolution, dtype=world_pts.dtype,
                       device=world_pts.device)
    x, y, z = world_pts[..., 0], world_pts[..., 1], world_pts[..., 2]
    sx, sy = sensor_xy[:, 0:1], sensor_xy[:, 1:2]
    dx, dy = x - sx, y - sy
    r = torch.sqrt(dx * dx + dy * dy)
    keep = (
        mask
        & (z >= config.height_min)
        & (z <= config.height_max)
        & (r <= config.max_range)
        & (r >= config.min_range)
    )
    cx = _cell(x, config.origin_x, res, D)
    cy = _cell(y, config.origin_y, res, D)
    px0 = torch.clamp(_cell(sx, config.origin_x, res, D) - P // 2, 0, D - P)
    py0 = torch.clamp(_cell(sy, config.origin_y, res, D) - P // 2, 0, D - P)
    lx = cx - px0
    ly = cy - py0
    in_patch = (lx >= 0) & (lx < P) & (ly >= 0) & (ly < P)
    dropped = keep & ~in_patch
    keep = keep & in_patch
    if lanes:
        lane = torch.arange(keep.shape[0], device=keep.device)[:, None]
        grid[lane.expand_as(keep)[keep], cx[keep], cy[keep]] = 1
        return torch.sum(dropped, dim=-1)
    grid[cx[keep], cy[keep]] = 1
    return torch.sum(dropped)


def grid_to_message(grid, config: OccupancyGridConfig) -> dict:
    """Crop to the occupied bounding box + 5-cell margin, occupied = 100
    (reference cells_to_occupancy_grid_msg, slam_node.cpp:279-297).

    Host-side (NumPy ``grid``), used only for artifact export."""
    g = np.asarray(grid)
    occ = np.argwhere(g > 0)
    if occ.size == 0:
        return {
            "resolution": config.resolution,
            "width": 0,
            "height": 0,
            "origin_x": 0.0,
            "origin_y": 0.0,
            "data": np.zeros((0, 0), np.int8),
        }
    D = config.grid_dim
    minx, miny = occ.min(axis=0) - 5
    maxx, maxy = occ.max(axis=0) + 5
    minx, miny = max(minx, 0), max(miny, 0)
    maxx, maxy = min(maxx, D - 1), min(maxy, D - 1)
    crop = g[minx : maxx + 1, miny : maxy + 1]
    data = np.where(crop > 0, 100, 0).astype(np.int8)
    return {
        "resolution": config.resolution,
        "width": data.shape[0],
        "height": data.shape[1],
        "origin_x": (minx - D // 2) * config.resolution + config.origin_x,
        "origin_y": (miny - D // 2) * config.resolution + config.origin_y,
        "data": data,
    }
