"""Voxel-grid centroid downsampling: one centroid per occupied voxel of
side ``voxel`` (key floor(p / voxel) per axis), emitted in ascending
(x, y, z) key order, at most ``cap`` rows: over capacity, the rows
``(j * n_voxels) // cap`` of the sorted voxels. Sums in float64 (the
control's: float32 of TF32 inputs), rounded to float32 once per centroid.

``device_keys``: the keys of the port's device voxelizer, 10 bits an axis
clamped to [-512, 511] voxels (beyond any return at 0.5 m); otherwise the
host voxelizer's 21 bits an axis (never clamped at sensor ranges)."""

from __future__ import annotations

import torch

from .prec import FP32, Precision


def voxelize(pts: torch.Tensor, voxel: float, cap: int,
             device_keys: bool = False,
             p: Precision = FP32) -> tuple[torch.Tensor, torch.Tensor]:
    """(n, 3) float32 points -> ``(points (cap, 3), mask (cap,))``."""
    pts = p.inp(pts)
    q = torch.floor(pts / torch.tensor(voxel, dtype=pts.dtype,
                                       device=pts.device)).to(torch.int64)
    if device_keys:
        q = torch.clamp(q + 512, 0, 1023)
        key = (q[:, 0] << 20) | (q[:, 1] << 10) | q[:, 2]
    else:
        q = q + (1 << 20)
        key = (q[:, 0] << 42) | (q[:, 1] << 21) | q[:, 2]
    uniq, inv = torch.unique(key, sorted=True, return_inverse=True)
    n = uniq.shape[0]
    sums = torch.zeros((n, 3), dtype=p.wide, device=pts.device)
    sums.index_add_(0, inv, pts.to(p.wide))
    cnt = torch.bincount(inv, minlength=n).to(p.wide)
    cent = (sums / cnt[:, None]).float()
    j = torch.arange(cap, device=pts.device)
    m = min(n, cap)
    pick = (j * n) // cap if n > cap else j.clamp(max=max(n - 1, 0))
    out = torch.zeros((cap, 3), dtype=torch.float32, device=pts.device)
    out[:m] = cent[pick[:m]]
    mask = j < m
    return out, mask
