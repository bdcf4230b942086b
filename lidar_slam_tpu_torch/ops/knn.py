"""Exact 1-nearest-neighbour search, plain PyTorch.

``nn1`` computes squared distances in the DIFFERENCE form
``dx*dx + dy*dy + dz*dz`` (exact f32, evaluated left to right), the form of
the TPU kernels (``lidar_slam_tpu/ops/knn_pallas.py:48-51``) and of the port's
CUDA kernels. It is the plain version of K2 (``ops/knn_cuda.nn1``) and what
that wrapper runs on CPU tensors. The JAX package's XLA ``nn1`` uses the
|s|^2+|t|^2-2s.t expansion instead, so its distances differ in the last bits.

Invalid (masked-out) target points are displaced to a far sentinel so they
are never selected; ties go to the first index.
"""

from __future__ import annotations

import torch

SENTINEL = 1.0e6  # meters; far beyond any LiDAR return


def mask_points(pts: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Displace invalid points to the sentinel so a search never picks them."""
    return torch.where(mask[..., None], pts, torch.full_like(pts, SENTINEL))


def sq_dist(src: torch.Tensor, tgt: torch.Tensor) -> torch.Tensor:
    """(..., S, T) squared distances, difference form, f32-exact order."""
    dx = src[..., :, 0:1] - tgt[..., None, :, 0]
    dy = src[..., :, 1:2] - tgt[..., None, :, 1]
    dz = src[..., :, 2:3] - tgt[..., None, :, 2]
    return dx * dx + dy * dy + dz * dz


def nn1(
    src: torch.Tensor,
    tgt: torch.Tensor,
    tgt_mask: torch.Tensor,
    chunk: int = 2048,
) -> tuple[torch.Tensor, torch.Tensor]:
    """1-NN of each source row in the target cloud.

    ``src`` (..., S, 3), ``tgt`` (..., T, 3), ``tgt_mask`` (..., T) with equal
    leading dims. Returns ``(idx (..., S) int32, dist2 (..., S) f32)``: the
    first index of the minimum, and max(d2, 0)."""
    tgt = mask_points(tgt, tgt_mask)
    T = tgt.shape[-2]
    best_d = best_i = None
    for off in range(0, T, chunk):
        d2 = sq_dist(src, tgt[..., off : off + chunk, :])
        local_d, local_i = torch.min(d2, dim=-1)
        local_i = local_i.to(torch.int32) + off
        if best_d is None:
            best_d, best_i = local_d, local_i
        else:
            better = local_d < best_d  # strict: the earlier chunk keeps ties
            best_d = torch.where(better, local_d, best_d)
            best_i = torch.where(better, local_i, best_i)
    return best_i, torch.clamp(best_d, min=0.0)
