"""DB-sharded Scan Context retrieval (port of
``lidar_slam_tpu/parallel/sharded_detect.py``).

Each shard of the keyframe axis runs the shifted-cosine search
(``ops/scan_context.sc_distances``) on its own device and keeps its own
top-``min(k, shard)``; the ``n_shards x k_local`` candidates, with global
indices, are gathered on the query's device and the global top-k is taken
from them. Exact: the top-k of a concatenation is the top-k of the union of
the per-shard top-k.

Equal distances keep the lower DB index first, as ``lax.top_k`` does: each
shard sorts stably by distance, and the gathered candidates lie in order of
shard and then of rank, so a second stable sort orders equal distances by
global index.
"""

from __future__ import annotations

import torch

from ..ops.scan_context import sc_distances
from .mesh import Mesh


def sc_topk_sharded(query: torch.Tensor, db: torch.Tensor,
                    db_norm: torch.Tensor, k: int, mesh: Mesh,
                    axis: str = "pts"):
    """Top-k Scan Context candidates with the DB sharded over ``axis``.

    ``query`` (R, S), ``db`` (F, R, S) with F divisible by the axis size,
    ``db_norm`` (F,). Returns ``(dist (k,), idx (k,) int32, shift (k,)
    int32)`` on the query's device: ascending distances, their DB indices
    and each one's best column shift; empty entries carry distance 1.0."""
    devices = mesh.axis_devices(axis, near=query.device)
    F = db.shape[0]
    if F % len(devices):
        raise ValueError(f"{F} DB rows do not split over {len(devices)} shards")
    size = F // len(devices)
    k_local = min(k, size)
    dist_c, idx_c, shift_c = [], [], []
    for i, dev in enumerate(devices):
        sl = slice(i * size, (i + 1) * size)
        dist, shift = sc_distances(query.to(dev), db[sl].to(dev),
                                   db_norm[sl].to(dev))
        loc = torch.sort(dist, stable=True).indices[:k_local]
        dist_c.append(dist[loc].to(query.device))
        idx_c.append((loc + i * size).to(query.device))
        shift_c.append(shift[loc].to(query.device))
    d_all = torch.cat(dist_c)
    sel = torch.sort(d_all, stable=True).indices[:k]
    return (d_all[sel], torch.cat(idx_c)[sel].to(torch.int32),
            torch.cat(shift_c)[sel].to(torch.int32))
