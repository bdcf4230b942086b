"""Core tensor types of the port (counterpart of ``lidar_slam_tpu/types.py``).

A point cloud is a fixed-shape padded ``(..., N, 3)`` float32 tensor plus a
boolean validity mask; transforms are raw ``(..., 4, 4)`` tensors handled by
the free functions in :mod:`lidar_slam_tpu_torch.ops.se3`. Leading batch
dimensions are allowed everywhere (loop verification runs its candidate lanes
as one batch).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass
class PointCloud:
    """Padded point cloud: ``points[..., i, :]`` is valid iff ``mask[..., i]``."""

    points: torch.Tensor  # (..., N, 3) float32
    mask: torch.Tensor    # (..., N) bool

    @property
    def capacity(self) -> int:
        return self.points.shape[-2]

    def count(self) -> torch.Tensor:
        """Number of valid points (int64 tensor over the leading dims)."""
        return self.mask.sum(dim=-1)

    def subsample(self, n_out: int) -> "PointCloud":
        """Deterministic strided subsample of the valid prefix (the same rows
        as the JAX ``PointCloud.subsample``)."""
        if n_out >= self.capacity:
            return self
        idx = strided_prefix_idx(self.count(), n_out)
        return PointCloud(
            torch.gather(
                self.points, -2, idx[..., None].expand(*idx.shape, 3)
            ),
            torch.gather(self.mask, -1, idx),
        )


def strided_prefix_idx(cnt: torch.Tensor, n_out: int) -> torch.Tensor:
    """Indices (int64) of an evenly strided ``n_out``-subsample of a valid
    prefix of length ``cnt`` (any batch shape; a trailing axis is added).
    When ``cnt <= n_out`` the first ``n_out`` rows are returned unchanged."""
    cnt = torch.as_tensor(cnt)
    j = torch.arange(n_out, device=cnt.device)
    c = cnt.to(torch.int64)[..., None]
    return torch.where(c > n_out, (j * c) // n_out, j)


@dataclass
class ICPResult:
    """Registration result (mirrors the JAX ``ICPResult``; reference
    types.hpp:155-164). Leading batch dims follow the inputs."""

    transformation: torch.Tensor  # (..., 4, 4)
    converged: torch.Tensor       # (...) bool
    num_iterations: torch.Tensor  # (...) int32
    error_history: torch.Tensor   # (..., max_iterations + 1)
    final_error: torch.Tensor     # (...)
