"""Scan Context place-recognition descriptor (port of
``lidar_slam_tpu/ops/scan_context.py``).

- descriptor: polar binning over range in [0.1, 80] m, max-z per bin (a
  ``scatter_reduce("amax")`` seeded at -1e9, the same values as the TPU's
  tiled masked max), empty bins = 0;
- database search: ONE matmul of the 60 column-rolled queries against the
  stacked descriptor DB (float32 with TF32 off), then the best shift.
"""

from __future__ import annotations

import math

import torch

from ..config import ScanContextConfig

_NEG = -1.0e9


def scan_context(pts: torch.Tensor, mask: torch.Tensor,
                 config: ScanContextConfig = ScanContextConfig()) -> torch.Tensor:
    """(rings, sectors) max-height descriptor of a padded (N, 3) cloud."""
    R, S = config.num_rings, config.num_sectors
    f = dict(dtype=pts.dtype, device=pts.device)
    x, y, z = pts[:, 0], pts[:, 1], pts[:, 2]
    rng = torch.sqrt(x * x + y * y)
    ang = torch.atan2(y, x) + math.pi
    valid = mask & (rng <= config.max_range) & (rng >= config.min_range)
    # true f32 divisions by tensors (see ops/normals.py)
    ring_size = torch.tensor(config.max_range / R, **f)
    sector_size = torch.tensor(2.0 * math.pi / S, **f)
    ring = torch.clamp((rng / ring_size).to(torch.int64), 0, R - 1)
    sector = torch.clamp((ang / sector_size).to(torch.int64), 0, S - 1)
    C = R * S
    bin_id = torch.where(valid, ring * S + sector, torch.full_like(ring, C))
    zval = torch.where(valid, z, torch.full_like(z, _NEG))
    desc = torch.full((C + 1,), _NEG, **f)  # slot C collects invalid points
    desc = desc.scatter_reduce(0, bin_id, zval, reduce="amax", include_self=True)
    desc = desc[:C]
    desc = torch.where(desc < -1000.0, torch.zeros_like(desc), desc)
    return desc.reshape(R, S)


def _rolled_queries(desc: torch.Tensor) -> torch.Tensor:
    """(S, R*S): the query rolled right by each shift s, flattened."""
    S = desc.shape[-1]
    return torch.stack([torch.roll(desc, s, dims=-1) for s in range(S)]).reshape(S, -1)


def sc_distances(query: torch.Tensor, db: torch.Tensor,
                 db_norm: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Distance of one (R, S) query to every (F, R, S) DB entry: the min over
    column shifts of 1 - cosine similarity, and the best shift (int64);
    distance 1.0 where either norm < 1e-10."""
    S = query.shape[-1]
    F = db.shape[0]
    q = _rolled_queries(query)
    dots = torch.matmul(q, db.reshape(F, -1).T)       # (S, F)
    qn = torch.sqrt(torch.sum(query * query))
    norm = qn * db_norm
    sims = dots / torch.clamp(norm, min=1e-30)[None, :]
    best_sim, best_shift = torch.max(sims, dim=0)
    dist = 1.0 - best_sim
    dist = torch.where(norm < 1e-10, torch.ones_like(dist), dist)
    return dist, best_shift


def shift_to_yaw(shift: torch.Tensor, num_sectors: int) -> torch.Tensor:
    """Best column shift -> relative yaw angle (radians)."""
    s = shift.to(torch.float32)
    half = num_sectors / 2.0
    s = torch.where(s > half, s - num_sectors, s)
    return s * (2.0 * math.pi / num_sectors)
