"""The occupancy grid of a finalized map, written plainly: a D x D grid of
cells of ``resolution`` metres around the origin (cell floor(v / res) +
D // 2). Each frame's cloud goes to the world by its pose; a point marks
its cell when its z is within [height_min, height_max], its horizontal
distance to the sensor within [min_range, max_range], and its cell inside
the frame's P x P patch around the sensor's cell (clipped to the grid,
P = max_range x 2 / res + 16 rounded up to 128)."""

from __future__ import annotations

import torch

from . import se3
from .prec import FP32, Precision


def rebuild(poses, clouds, masks, g, p: Precision = FP32) -> torch.Tensor:
    D = g.grid_dim
    P = min(D, -(-(int(2.0 * g.max_range / g.resolution) + 16) // 128) * 128)
    grid = torch.zeros((D, D), dtype=torch.uint8, device=clouds.device)
    res = torch.tensor(g.resolution, dtype=torch.float32, device=clouds.device)
    for f in range(poses.shape[0]):
        T = p.inp(poses[f])
        w = se3.apply(T, p.inp(clouds[f]), p)
        sx, sy = T[0, 3], T[1, 3]
        dx, dy = w[:, 0] - sx, w[:, 1] - sy
        r = torch.sqrt(dx * dx + dy * dy)
        keep = (masks[f] & (w[:, 2] >= g.height_min) & (w[:, 2] <= g.height_max)
                & (r <= g.max_range) & (r >= g.min_range))
        cx = torch.floor((w[:, 0] - g.origin_x) / res).to(torch.int64) + D // 2
        cy = torch.floor((w[:, 1] - g.origin_y) / res).to(torch.int64) + D // 2
        px = torch.clamp(torch.floor((sx - g.origin_x) / res).to(torch.int64) + D // 2 - P // 2,
                         0, D - P)
        py = torch.clamp(torch.floor((sy - g.origin_y) / res).to(torch.int64) + D // 2 - P // 2,
                         0, D - P)
        keep &= (cx >= px) & (cx < px + P) & (cy >= py) & (cy < py + P)
        grid[cx[keep], cy[keep]] = 1
    return grid
