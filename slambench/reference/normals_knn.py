"""The upstream's k-NN normals (``normal_method="knn"``; kaushik884/
LiDAR-SLAM-from-scratch ``core/icp.hpp:23-67``, ``estimate_normals``),
written plainly: for every valid row of a padded (N, 3) cloud,

1. the ``icp.normal_k`` nearest valid rows of the same cloud (all of them
   where it holds fewer), the row itself among them, by squared distance
   in difference form dx*dx + dy*dy + dz*dz; of rows at the same distance
   as the k-th, the lower indices are taken;
2. the covariance of those neighbours about their centroid;
3. the eigenvector of its least eigenvalue, turned to z >= 0;

and (0, 0, 1) for invalid rows and for rows with fewer than 3 valid
neighbours (a cloud of fewer than 3 valid rows).

Where this departs from ``icp.hpp:23-67``, and why:

- float32 (the configuration's precision) where the upstream's
  ``PointCloud`` is a double matrix: the program is held to what its
  configuration states;
- the neighbours come from a brute-force search over every valid row, not
  from the upstream's k-d tree: the same set in exact arithmetic, and no
  tree of the program's kind to share a fault with;
- ties at the k-th place go to the lower row index, which the tree's
  traversal order leaves unspecified: the set must be a function of the
  cloud;
- padded rows (``mask`` false) are neither queried nor neighbours: the
  upstream's clouds have no padding;
- the normals are those of one frame's cloud, worked out once, as the
  program's ``normals_fn`` caches them; the upstream computes them again
  for the target of every ICP call, the same numbers.

Every matmul goes through :class:`Precision`, so the control (TF32) rounds
the points and the covariance's operands."""

from __future__ import annotations

import torch

from .normals import _d2, least_eigvec_up
from .prec import FP32, Precision

_CHUNK_ELEMS = 1 << 26      # query rows x valid rows a chunk


def knn_rows(pts: torch.Tensor, k: int) -> torch.Tensor:
    """(V, k) indices into the (V, 3) ``pts``, V >= k: each row's k nearest
    rows, in increasing index order (not by distance)."""
    V = pts.shape[0]
    c = max(1, _CHUNK_ELEMS // V)
    out = []
    for q0 in range(0, V, c):
        d2 = _d2(pts[q0:q0 + c], pts)                               # (c, V)
        kth = torch.topk(d2, k, dim=1, largest=False).values[:, -1:]
        below = d2 < kth
        at = d2 == kth
        room = k - below.sum(1, keepdim=True)
        take = below | (at & (torch.cumsum(at, 1) <= room))
        out.append(take.nonzero()[:, 1].reshape(-1, k))
    return torch.cat(out)


def knn_normals(pts: torch.Tensor, mask: torch.Tensor, cfg,
                p: Precision = FP32) -> torch.Tensor:
    """Normals of a padded (N, 3) cloud under ``cfg`` (the configuration's
    ``SlamConfig``), ``normal_method="knn"``."""
    pts = p.inp(pts)
    up = torch.tensor([0.0, 0.0, 1.0], dtype=pts.dtype, device=pts.device)
    out = up.repeat(pts.shape[0], 1)
    valid = mask.nonzero()[:, 0]
    if len(valid) < 3:
        return out
    v = pts[valid]                                                  # (V, 3)
    nbr = v[knn_rows(v, min(cfg.icp.normal_k, len(valid)))]         # (V, k, 3)
    d = nbr - nbr.mean(1, keepdim=True)
    cov = p.mm(d.transpose(1, 2), d) / nbr.shape[1]
    out[valid] = least_eigvec_up(cov, torch.zeros(len(valid), dtype=torch.bool,
                                                  device=pts.device))
    return out
