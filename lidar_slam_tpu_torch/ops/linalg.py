"""Small fixed-size linear algebra (port of ``lidar_slam_tpu/ops/linalg.py``).

The unrolled Cholesky-Crout factorisation and triangular substitution are
kept exactly as the JAX package writes them, so the ICP Gauss-Newton step
rounds the same way and odometry matches the reference bit-near. Batched over
leading dimensions.
"""

from __future__ import annotations

import torch

_JITTER = 1e-12


def cholesky_small(A: torch.Tensor) -> list:
    """Lower Cholesky factor of (..., n, n) PSD A as a list-of-lists of
    (...) tensors (n is small and static)."""
    n = A.shape[-1]
    L = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            s = A[..., i, j]
            for p in range(j):
                s = s - L[i][p] * L[j][p]
            if i == j:
                L[i][j] = torch.sqrt(torch.clamp(s, min=_JITTER))
            else:
                L[i][j] = s / L[j][j]
    return L


def solve_psd_small(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve A x = b for PSD (..., n, n) A and (..., n) b."""
    n = A.shape[-1]
    L = cholesky_small(A)
    y = [None] * n
    for i in range(n):
        s = b[..., i]
        for p in range(i):
            s = s - L[i][p] * y[p]
        y[i] = s / L[i][i]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for p in range(i + 1, n):
            s = s - L[p][i] * x[p]
        x[i] = s / L[i][i]
    return torch.stack(x, dim=-1)
