"""Count-targeted radius normals over x-slab windows of an x-sorted cloud
(the configuration's ``normal_method="adaptive"`` with ``normal_window``,
``normal_probe_stride`` and ``normal_stride``), written plainly:

1. for every ``probe_stride``-th row, the neighbours within the two probe
   radii among the ``window`` rows that start at the first row whose
   running-max x reaches the tile's least x minus the larger radius (tiles
   of ``256 // probe_stride`` rows; the count includes the row itself);
2. the local dimension log(c_hi / c_lo) / log(r_hi / r_lo) in [0.7, 2.5]
   and the radius r_hi (k / c_hi)^(1 / dim) in [r_min, r_max], repeated
   over the skipped rows;
3. for every row, the neighbours within its radius in its tile's window
   (tiles of 256 rows, the window starting at the tile's least x minus its
   largest radius), their covariance about their mean, taken in
   coordinates centred on the row itself, and the eigenvector of its least
   eigenvalue, turned to z >= 0; (0, 0, 1) for invalid rows and rows with
   fewer than 3 neighbours.
"""

from __future__ import annotations

import torch

from .prec import FP32, Precision

SENTINEL = 1.0e6
_CHUNK_ROWS = 2048      # query rows a chunk (2048 x window distances)


def _starts(x_mono, tile_min_x, n, window):
    s = torch.searchsorted(x_mono, tile_min_x.contiguous(), side="left")
    return torch.clamp(s, 0, max(n - window, 0))


def _d2(q: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(..., S, 3) x (..., W, 3) -> (..., S, W) squared distances,
    difference form dx*dx + dy*dy + dz*dz."""
    dx = q[..., :, None, 0] - w[..., None, :, 0]
    dy = q[..., :, None, 1] - w[..., None, :, 1]
    dz = q[..., :, None, 2] - w[..., None, :, 2]
    return dx * dx + dy * dy + dz * dz


def _tiles(q: torch.Tensor, ts: int) -> torch.Tensor:
    pad = -q.shape[0] % ts
    if pad:
        q = torch.cat([q, q[-1:].expand(pad, 3)], 0)
    return q.reshape(-1, ts, 3)


def _probe_counts(pts_m, query, radii, window, ts):
    N, M = pts_m.shape[0], query.shape[0]
    window = N if window <= 0 else min(window, N)
    ts = min(ts, M)
    tiles = _tiles(query, ts)
    x_mono = torch.cummax(pts_m[:, 0], 0).values
    starts = _starts(x_mono, tiles[:, :, 0].min(1).values - max(radii), N, window)
    ar = torch.arange(window, device=pts_m.device)
    r2 = [torch.tensor(r * r, dtype=pts_m.dtype, device=pts_m.device) for r in radii]
    outs = [[] for _ in radii]
    step = max(1, _CHUNK_ROWS // ts)
    for t0 in range(0, tiles.shape[0], step):
        t1 = min(t0 + step, tiles.shape[0])
        win = pts_m[starts[t0:t1, None] + ar]
        d2 = _d2(tiles[t0:t1], win)
        for o, r in zip(outs, r2):
            o.append((d2 < r).sum(-1).to(pts_m.dtype))
    return [torch.cat(o).reshape(-1)[:M] for o in outs]


def _radius_normals(pts_m, mask, radius, window, p: Precision, ts=256):
    N = pts_m.shape[0]
    ts = min(ts, N)
    while N % ts:
        ts -= 1
    window = min(window, N)
    tiles = pts_m.reshape(-1, ts, 3)
    r_t = radius.reshape(-1, ts)
    x_mono = torch.cummax(pts_m[:, 0], 0).values
    starts = _starts(x_mono, tiles[:, :, 0].min(1).values - r_t.max(1).values,
                     N, window)
    ar = torch.arange(window, device=pts_m.device)
    covs, cnts = [], []
    step = max(1, _CHUNK_ROWS // ts)
    for t0 in range(0, tiles.shape[0], step):
        t1 = min(t0 + step, tiles.shape[0])
        win = pts_m[starts[t0:t1, None] + ar]                  # (t, W, 3)
        q = tiles[t0:t1]                                       # (t, ts, 3)
        d = win[:, None, :, :] - q[:, :, None, :]              # (t, ts, W, 3)
        d2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]
        r = r_t[t0:t1]
        m = (d2 < (r * r)[..., None]).to(pts_m.dtype)          # (t, ts, W)
        cnt = m.sum(-1)
        dm = d.reshape(-1, window, 3)
        mw = m.reshape(-1, 1, window)
        s1 = p.mm(mw, dm)[:, 0, :]                              # (t ts, 3)
        s2 = p.mm((dm * mw.transpose(1, 2)).transpose(1, 2), dm)  # (t ts, 3, 3)
        c = cnt.reshape(-1).clamp(min=1.0)
        mean = s1 / c[:, None]
        covs.append(s2 / c[:, None, None] - mean[:, :, None] * mean[:, None, :])
        cnts.append(cnt.reshape(-1))
    cov, cnt = torch.cat(covs), torch.cat(cnts)
    # LAPACK's batched 3 x 3 eigh on the host (cuSOLVER's batched syevj
    # refuses a batch of this size)
    _, vecs = torch.linalg.eigh(cov.cpu())
    n = vecs[..., :, 0].to(cov.device)
    n = torch.where(n[:, 2:3] < 0, -n, n)
    up = torch.tensor([0.0, 0.0, 1.0], dtype=n.dtype, device=n.device)
    bad = (cnt < 3.0) | ~mask
    return torch.where(bad[:, None], up.expand_as(n), n)


def adaptive_normals(pts: torch.Tensor, mask: torch.Tensor, cfg,
                     p: Precision = FP32) -> torch.Tensor:
    """Normals of a padded (N, 3) x-sorted cloud under ``cfg`` (the
    configuration's ``SlamConfig``)."""
    st = cfg.normal_stride
    if st > 1:
        sub = _adaptive(pts[::st], mask[::st], cfg, max(cfg.normal_k_target // st, 4), p)
        n = torch.repeat_interleave(sub, st, 0)[: pts.shape[0]]
        up = torch.tensor([0.0, 0.0, 1.0], dtype=n.dtype, device=n.device)
        return torch.where(mask[:, None], n, up.expand_as(n))
    return _adaptive(pts, mask, cfg, cfg.normal_k_target, p)


def _adaptive(pts, mask, cfg, k, p):
    N = pts.shape[0]
    pts = p.inp(pts)
    pts_m = torch.where(mask[:, None], pts, torch.full_like(pts, SENTINEL))
    r_lo, r_hi = float(cfg.normal_probe_lo), float(cfg.normal_probe_hi)
    ps = max(int(cfg.normal_probe_stride), 1)
    query = pts_m[::ps] if ps > 1 else pts_m
    c_lo, c_hi = _probe_counts(pts_m, query, (r_lo, r_hi), cfg.normal_window,
                               max(256 // ps, 8))
    c_lo, c_hi = c_lo.clamp(min=2.0), c_hi.clamp(min=2.0)
    f = dict(dtype=pts.dtype, device=pts.device)
    dim = torch.clamp(torch.log(c_hi / c_lo) / torch.log(torch.tensor(r_hi / r_lo, **f)),
                      0.7, 2.5)
    r_min = cfg.normal_radius if cfg.normal_radius > 0 else 2.4 * cfg.voxel_size
    r = torch.clamp(r_hi * (torch.full_like(c_hi, float(k)) / c_hi)
                    ** (torch.ones_like(dim) / dim), r_min, cfg.normal_r_max)
    if ps > 1:
        r = torch.repeat_interleave(r, ps)[:N]
    window = N if cfg.normal_window <= 0 else cfg.normal_window
    return _radius_normals(pts_m, mask, r, window, p)


def angle_deg(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Angle between unit normals, sign ignored (a plane's normal either
    way), in degrees."""
    a, b = a.double(), b.double()
    s = torch.linalg.norm(torch.linalg.cross(a, b, dim=-1), dim=-1)
    return torch.rad2deg(torch.atan2(s, (a * b).sum(-1).abs()))
