"""One frame's odometry, written plainly: register the frame's cloud onto
the previous frame's (with the previous frame's normals), from the previous
accepted delta (``warm_start``) or the identity, with the configuration's
search (``knn_backend``: ``slab_pallas`` the slab window, ``auto`` /
``pallas`` / ``xla`` the exact 1-NN). The frame's delta is the identity
when its cloud holds fewer than ``min_points`` rows, or its ICP did not
converge, or its final error (1e6 when not finite) exceeds
``divergence_error``. The frame's odometry factor is scaled by 1 + 10 x
that final error, whatever the delta (pose_graph.cpp's weighting)."""

from __future__ import annotations

import torch

from .icp import icp
from .prec import FP32, Precision

EXACT = ("auto", "pallas", "xla")


def search_of(cfg) -> str:
    if cfg.knn_backend == "slab_pallas":
        return "slab"
    if cfg.knn_backend in EXACT:
        return "exact"
    raise NotImplementedError(f"knn_backend {cfg.knn_backend!r}")


def odometry(cfg, src, smask, tgt, tmask, tnormals, prev_delta,
             p: Precision = FP32):
    """``(delta (4, 4), valid, factor scale)`` of one frame."""
    npts = int(smask.sum())
    ok = npts >= cfg.min_points
    init = prev_delta if cfg.icp.warm_start else torch.eye(4, device=src.device)
    T, conv, _, fe = icp(src[None], smask[None], tgt[None], tmask[None],
                         tnormals[None], cfg.icp, init, search_of(cfg),
                         window=cfg.slab_window, p=p)
    fit = torch.where(torch.isfinite(fe), fe, torch.full_like(fe, 1e6))
    scale = 1.0 + 10.0 * float(fit[0])
    if not ok or not bool(conv[0]) or float(fit[0]) > cfg.divergence_error:
        return torch.eye(4, device=src.device), ok, scale
    return T[0], ok, scale
