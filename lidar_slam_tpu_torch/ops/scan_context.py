"""Scan Context place-recognition descriptor (port of
``lidar_slam_tpu/ops/scan_context.py``).

- descriptor: polar binning over range in [0.1, 80] m, max-z per bin (a
  ``scatter_reduce("amax")`` seeded at -1e9, the same values as the TPU's
  tiled masked max), empty bins = 0;
- database search: ONE matmul of the 60 column-rolled queries against the
  stacked descriptor DB (float64 sums rounded to float32), then the best
  shift;
- the ring-key prefilter (``LoopClosureConfig.ring_key_prefilter``): the L1
  distance of the rotation-invariant ring keys picks k survivors, and only
  they get the shifted-cosine search.
"""

from __future__ import annotations

import math

import torch

from ..config import ScanContextConfig

_NEG = -1.0e9


def scan_context(pts: torch.Tensor, mask: torch.Tensor,
                 config: ScanContextConfig = ScanContextConfig()) -> torch.Tensor:
    """(rings, sectors) max-height descriptor of a padded (N, 3) cloud, or
    (B, rings, sectors) of B clouds (B, N, 3) in one scatter."""
    R, S = config.num_rings, config.num_sectors
    f = dict(dtype=pts.dtype, device=pts.device)
    x, y, z = pts[..., 0], pts[..., 1], pts[..., 2]
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
    lead = pts.shape[:-2]
    n_clouds = math.prod(lead)
    # cloud k's bins are [k (C + 1), (k + 1) (C + 1)); slot C of each
    # collects its invalid points
    bin_id = bin_id.reshape(n_clouds, -1) + (C + 1) * torch.arange(
        n_clouds, device=pts.device)[:, None]
    desc = torch.full((n_clouds * (C + 1),), _NEG, **f)
    desc = desc.scatter_reduce(0, bin_id.reshape(-1), zval.reshape(-1),
                               reduce="amax", include_self=True)
    desc = desc.reshape(n_clouds, C + 1)[:, :C]
    desc = torch.where(desc < -1000.0, torch.zeros_like(desc), desc)
    return desc.reshape(*lead, R, S)


def ring_key(desc: torch.Tensor) -> torch.Tensor:
    """Row-wise mean over sectors (reference scan_context.hpp:107-109)."""
    return torch.mean(desc, dim=-1)


def sector_key(desc: torch.Tensor) -> torch.Tensor:
    """Column-wise mean over rings (reference scan_context.hpp:113-116)."""
    return torch.mean(desc, dim=-2)


def _rolled_queries(desc: torch.Tensor) -> torch.Tensor:
    """(S, R*S): the query rolled right by each shift s, flattened."""
    S = desc.shape[-1]
    return torch.stack([torch.roll(desc, s, dims=-1) for s in range(S)]).reshape(S, -1)


def sc_distances(query: torch.Tensor, db: torch.Tensor,
                 db_norm: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Distance of one (R, S) query to every (F, R, S) DB entry: the min over
    column shifts of 1 - cosine similarity, and the best shift (int64);
    distance 1.0 where either norm < 1e-10.

    The dot products accumulate in float64 and round once to float32, so an
    entry's distance does not depend on how many entries share the product
    (a GEMM library picks its split of the sum by shape): a DB split over
    devices (``parallel/sharded_detect.py``) or of another capacity gives
    the same distances."""
    S = query.shape[-1]
    F = db.shape[0]
    q = _rolled_queries(query)
    dots = torch.matmul(q.double(), db.reshape(F, -1).double().T).float()  # (S, F)
    qn = torch.sqrt(torch.sum(query * query))
    norm = qn * db_norm
    sims = dots / torch.clamp(norm, min=1e-30)[None, :]
    best_sim, best_shift = torch.max(sims, dim=0)
    dist = 1.0 - best_sim
    dist = torch.where(norm < 1e-10, torch.ones_like(dist), dist)
    return dist, best_shift


def sc_distances_ring_prefiltered(
    query: torch.Tensor, db: torch.Tensor, db_norm: torch.Tensor, k: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Two-stage retrieval: the k DB entries nearest the query in ring-key L1
    distance (equal distances keep the lower index, as ``lax.top_k``; empty
    rows share a zero key), then :func:`sc_distances` on those only.
    Returns ``(dist (F,), best_shift (F,))`` with the non-survivors at +inf
    and shift 0."""
    F = db.shape[0]
    l1 = torch.sum(torch.abs(ring_key(db) - ring_key(query)[None, :]), dim=-1)
    idx = torch.sort(l1, stable=True).indices[:k]
    d_k, s_k = sc_distances(query, db[idx], db_norm[idx])
    dist = torch.full((F,), float("inf"), dtype=query.dtype, device=query.device)
    shift = torch.zeros((F,), dtype=s_k.dtype, device=query.device)
    dist[idx] = d_k
    shift[idx] = s_k
    return dist, shift


def sc_distance(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Distance of two descriptors (reference scan_context.hpp:90-102)."""
    d, _ = sc_distances(a, b[None], torch.sqrt(torch.sum(b * b))[None])
    return d[0]


def shift_to_yaw(shift: torch.Tensor, num_sectors: int) -> torch.Tensor:
    """Best column shift -> relative yaw angle (radians)."""
    s = shift.to(torch.float32)
    half = num_sectors / 2.0
    s = torch.where(s > half, s - num_sectors, s)
    return s * (2.0 * math.pi / num_sectors)
