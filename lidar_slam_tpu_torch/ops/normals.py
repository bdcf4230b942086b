"""PCA surface normals (port of ``lidar_slam_tpu/ops/normals.py``).

The main path's normals are ``estimate_normals_adaptive`` with a slab window
over the x-sorted cloud: two neighbour-count probes pick a per-point radius
that targets ``k`` neighbours, then one moment pass accumulates the 0th, 1st
and 2nd moments of every neighbour inside that radius, and the covariance's
smallest eigenvector is the normal. Each tile of consecutive (x-sorted)
points only looks at one contiguous window of the cloud, found by binary
search over the running max of x — exact whenever the window covers the
tile's +-radius x-band.

Unlike the JAX package, the moments are accumulated directly in f32
(batched matmuls with TF32 off); the three-way bf16 split there exists for
the TPU's matrix unit only. Tiles are processed in chunks so the (tiles, ts,
window) distance block stays bounded. This is plain PyTorch, not a kernel;
the x-slab sweeps are the next candidate for a hand-written one.

``estimate_normals`` is the reference-shaped k-NN PCA (``normal_method=
"knn"``): the exact k nearest neighbours (``ops/knn.knn``), their covariance
about the centroid, the smallest eigenvector. ``stride > 1`` (radius and
adaptive) computes the normals of every stride-th row and repeats each one
over the skipped rows.
"""

from __future__ import annotations

import math

import torch

from ..utils import tracing
from .knn import knn, knn_chunk, sq_dist

_EPS = 1e-12
_CHUNK_ELEMS = 1 << 26  # distance-block elements per chunk of tiles


def smallest_eigvec_3x3(A: torch.Tensor) -> torch.Tensor:
    """Unit eigenvector of the smallest eigenvalue of symmetric (..., 3, 3) A
    (trigonometric eigenvalues, null-space direction from row cross
    products; +z for degenerate input)."""
    a00, a11, a22 = A[..., 0, 0], A[..., 1, 1], A[..., 2, 2]
    a01, a02, a12 = A[..., 0, 1], A[..., 0, 2], A[..., 1, 2]

    q = (a00 + a11 + a22) / 3.0
    p1 = a01 * a01 + a02 * a02 + a12 * a12
    p2 = (a00 - q) ** 2 + (a11 - q) ** 2 + (a22 - q) ** 2 + 2.0 * p1
    p = torch.sqrt(torch.clamp(p2 / 6.0, min=_EPS))

    b00, b11, b22 = (a00 - q) / p, (a11 - q) / p, (a22 - q) / p
    b01, b02, b12 = a01 / p, a02 / p, a12 / p
    detB = (
        b00 * (b11 * b22 - b12 * b12)
        - b01 * (b01 * b22 - b12 * b02)
        + b02 * (b01 * b12 - b11 * b02)
    )
    r = torch.clamp(detB / 2.0, -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    lam_min = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)

    eye = torch.eye(3, dtype=A.dtype, device=A.device)
    M = A - lam_min[..., None, None] * eye
    r0, r1, r2 = M[..., 0, :], M[..., 1, :], M[..., 2, :]
    c01 = torch.linalg.cross(r0, r1, dim=-1)
    c02 = torch.linalg.cross(r0, r2, dim=-1)
    c12 = torch.linalg.cross(r1, r2, dim=-1)
    n01 = torch.sum(c01 * c01, dim=-1)
    n02 = torch.sum(c02 * c02, dim=-1)
    n12 = torch.sum(c12 * c12, dim=-1)
    best = torch.argmax(torch.stack([n01, n02, n12], dim=-1), dim=-1)
    cands = torch.stack([c01, c02, c12], dim=-2)
    v = torch.gather(cands, -2, best[..., None, None].expand(*best.shape, 1, 3))
    v = v[..., 0, :]
    nrm = torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True))
    fallback = torch.tensor([0.0, 0.0, 1.0], dtype=A.dtype, device=A.device)
    ok = nrm[..., 0] > 1e-10
    return torch.where(ok[..., None], v / torch.clamp(nrm, min=_EPS),
                       fallback.expand(v.shape))


def _take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (..., N, C), idx (..., M, k) -> (..., M, k, C), lane by lane."""
    lead = x.shape[:-2]
    n_lanes = math.prod(lead)
    N = x.shape[-2]
    off = (torch.arange(n_lanes, device=x.device) * N).reshape(*lead, 1, 1)
    flat = (idx.to(torch.int64) + off).reshape(-1)
    return x.reshape(-1, x.shape[-1])[flat].reshape(*idx.shape, x.shape[-1])


def _orient_up(n: torch.Tensor, degenerate: torch.Tensor) -> torch.Tensor:
    """Flip to normal.z >= 0; (0, 0, 1) where ``degenerate``."""
    n = torch.where(n[..., 2:3] < 0, -n, n)
    up = torch.tensor([0.0, 0.0, 1.0], dtype=n.dtype, device=n.device)
    return torch.where(degenerate[..., None], up.expand(n.shape), n)


def estimate_normals(pts: torch.Tensor, mask: torch.Tensor, k: int = 20,
                     chunk: int = 2048) -> torch.Tensor:
    """k-NN PCA normals of a padded (..., N, 3) cloud (each leading-dim lane
    on its own): the k nearest valid points (self included), the covariance
    of the valid ones about their centroid, the smallest eigenvector
    flipped to +z; (0, 0, 1) for rows with fewer than 3 valid neighbours and
    for invalid rows.

    Traced: the search is a ``knn`` span inside the caller's (the engine's
    ``normals``), and ``normals.knn_chunks`` counts the target chunks it
    streams."""
    with tracing.span("knn"):
        idx, _ = knn(pts, pts, mask, k=k, chunk=chunk)
    N = pts.shape[-2]
    tracing.count("normals.knn_chunks", N // knn_chunk(N, k, chunk))
    nbr = _take_rows(pts, idx)                                   # (..., N, k, 3)
    w = _take_rows(mask[..., None].to(pts.dtype), idx)[..., 0]   # (..., N, k)
    cnt = torch.sum(w, dim=-1)
    cnt_safe = torch.clamp(cnt, min=1.0)
    centroid = torch.sum(nbr * w[..., None], dim=-2) / cnt_safe[..., None]
    d = (nbr - centroid[..., None, :]) * w[..., None]
    cov = torch.einsum("...ki,...kj->...ij", d, d) / cnt_safe[..., None, None]
    return _orient_up(smallest_eigvec_3x3(cov), (cnt < 3.0) | ~mask)


def _repeat_rows(sub: torch.Tensor, stride: int, mask: torch.Tensor) -> torch.Tensor:
    """Normals of every ``stride``-th row repeated over the skipped rows
    (truncated to N); invalid rows get (0, 0, 1)."""
    n = torch.repeat_interleave(sub, stride, dim=0)[: mask.shape[0]]
    up = torch.tensor([0.0, 0.0, 1.0], dtype=n.dtype, device=n.device)
    return torch.where(mask[:, None], n, up.expand(n.shape))


def _slab_starts(x_mono: torch.Tensor, tile_min_x: torch.Tensor, n: int,
                 window: int) -> torch.Tensor:
    starts = torch.searchsorted(x_mono, tile_min_x, side="left")
    return torch.clamp(starts, 0, max(n - window, 0))


def _tile_chunks(n_tiles: int, ts: int, window: int):
    step = max(1, _CHUNK_ELEMS // max(ts * window, 1))
    for t0 in range(0, n_tiles, step):
        yield t0, min(t0 + step, n_tiles)


def _windows(pts_m: torch.Tensor, starts: torch.Tensor, window: int):
    cols = starts[:, None] + torch.arange(window, device=pts_m.device)
    return pts_m[cols]  # (tiles, W, 3)


def _radius_counts2(pts_m: torch.Tensor, radii: tuple, window: int,
                    ts: int = 256, tgt: torch.Tensor | None = None) -> tuple:
    """Neighbour counts (f32) within each radius in ``radii``, one distance
    sweep, over the x-slab windows of the x-sorted ``pts_m``.

    ``tgt``: optional (M, 3) subset of query rows (counts are taken over all
    of ``pts_m``); ``window <= 0`` or ``>= N`` means one window of the whole
    cloud."""
    N = pts_m.shape[0]
    if tgt is None:
        tgt = pts_m
    M = tgt.shape[0]
    window = N if window <= 0 else min(window, N)
    r2s = [torch.tensor(r * r, dtype=pts_m.dtype, device=pts_m.device)
           for r in radii]
    r_max_s = max(float(r) for r in radii)
    ts = min(ts, M)
    # pad the query rows to a tile multiple by repeating the last row (its
    # counts are discarded and it cannot widen the last tile's x-span)
    pad = -M % ts
    if pad:
        tgt = torch.cat([tgt, tgt[-1:].expand(pad, 3)], dim=0)
    Mp = M + pad
    x_mono = torch.cummax(pts_m[:, 0], dim=0).values
    tiles = tgt.reshape(Mp // ts, ts, 3)
    tile_min_x = torch.min(tiles[:, :, 0], dim=1).values - r_max_s
    starts = _slab_starts(x_mono, tile_min_x, N, window)
    outs = [[] for _ in r2s]
    for t0, t1 in _tile_chunks(Mp // ts, ts, window):
        d2 = sq_dist(tiles[t0:t1], _windows(pts_m, starts[t0:t1], window))
        for out, r2 in zip(outs, r2s):
            out.append(torch.sum((d2 < r2).to(pts_m.dtype), dim=-1))
    return tuple(torch.cat(o).reshape(Mp)[:M] for o in outs)


def _feats10(t: torch.Tensor) -> torch.Tensor:
    """Per-point moment features [1, x, y, z, xx, yy, zz, xy, xz, yz]."""
    x, y, z = t[..., 0], t[..., 1], t[..., 2]
    return torch.stack(
        [torch.ones_like(x), x, y, z, x * x, y * y, z * z, x * y, x * z, y * z],
        dim=-1,
    )


def _normals_radius_slab(pts_m: torch.Tensor, mask: torch.Tensor,
                         radius: torch.Tensor, window: int,
                         ts: int = 256) -> torch.Tensor:
    """x-slab windowed radius-moment normals of an x-sorted cloud with
    per-point (N,) or scalar radii."""
    N = pts_m.shape[0]
    ts = min(ts, N)
    while N % ts:
        ts -= 1
    window = min(window, N)
    per_point = radius.dim() == 1
    r_tiles = (radius.reshape(N // ts, ts) if per_point
               else radius.expand(N // ts, ts))

    x_mono = torch.cummax(pts_m[:, 0], dim=0).values
    tiles = pts_m.reshape(N // ts, ts, 3)
    tile_min_x = (torch.min(tiles[:, :, 0], dim=1).values
                  - torch.max(r_tiles, dim=1).values)
    starts = _slab_starts(x_mono, tile_min_x, N, window)
    accs = []
    for t0, t1 in _tile_chunks(N // ts, ts, window):
        win = _windows(pts_m, starts[t0:t1], window)
        d2 = sq_dist(tiles[t0:t1], win)
        r = r_tiles[t0:t1]
        m = (d2 < (r * r)[..., None]).to(pts_m.dtype)
        accs.append(torch.matmul(m, _feats10(win)))  # (tiles, ts, 10)
    acc = torch.cat(accs).reshape(N, 10)

    cnt = acc[:, 0]
    cnt_safe = torch.clamp(cnt, min=1.0)
    mean = acc[:, 1:4] / cnt_safe[:, None]
    xx, yy, zz, xy, xz, yz = (acc[:, 4 + i] / cnt_safe for i in range(6))
    mx, my, mz = mean[:, 0], mean[:, 1], mean[:, 2]
    cov = torch.stack(
        [
            torch.stack([xx - mx * mx, xy - mx * my, xz - mx * mz], dim=-1),
            torch.stack([xy - mx * my, yy - my * my, yz - my * mz], dim=-1),
            torch.stack([xz - mx * mz, yz - my * mz, zz - mz * mz], dim=-1),
        ],
        dim=-2,
    )
    return _orient_up(smallest_eigvec_3x3(cov), (cnt < 3.0) | ~mask)


def estimate_normals_radius(pts: torch.Tensor, mask: torch.Tensor,
                            radius=1.0, window: int = 0,
                            stride: int = 1) -> torch.Tensor:
    """Radius-neighbourhood moment PCA normals of an x-sorted cloud.

    ``radius``: scalar or per-point (N,) tensor. ``window > 0`` sweeps x-slab
    windows of that many points; ``window <= 0`` (or >= N) one window of the
    whole cloud, which is the dense neighbourhood. Rows with fewer than 3
    neighbours, and invalid rows, get (0, 0, 1). ``stride > 1``: the normals
    of ``pts[::stride]`` (same window), repeated over the skipped rows."""
    N = pts.shape[0]
    radius = torch.as_tensor(radius, dtype=pts.dtype, device=pts.device)
    if stride > 1:
        sub = estimate_normals_radius(
            pts[::stride], mask[::stride],
            radius[::stride] if radius.dim() == 1 else radius, window=window,
        )
        return _repeat_rows(sub, stride, mask)
    pts_m = torch.where(mask[:, None], pts, torch.full_like(pts, 1.0e6))
    return _normals_radius_slab(pts_m, mask, radius,
                                N if window <= 0 else window)


def estimate_normals_adaptive(
    pts: torch.Tensor,
    mask: torch.Tensor,
    k: int = 20,
    r_probe: tuple = (2.0, 8.0),
    r_min: float = 1.2,
    r_max: float = 20.0,
    window: int = 0,
    probe_stride: int = 1,
    stride: int = 1,
) -> torch.Tensor:
    """Count-targeted per-point-radius moment normals (k-NN-ball emulation),
    as ``lidar_slam_tpu.ops.normals.estimate_normals_adaptive``:

    1. neighbour counts at the two ``r_probe`` radii in one sweep (on every
       ``probe_stride``-th point, the radius then replicated to the skipped
       rows of the voxel-key-sorted cloud),
    2. local dimension log(c_hi/c_lo) / log(r_hi/r_lo), clipped to [0.7, 2.5],
    3. r_i = r_hi * (k / c_hi)^(1/dim), clipped to [r_min, r_max],
    4. one moment pass with the per-point radii.

    ``stride > 1``: all of that on ``pts[::stride]`` with the count target
    ``max(k // stride, 4)`` (the thinned cloud holds 1/stride of the
    neighbours), the normals repeated over the skipped rows.
    """
    if stride > 1:
        sub = estimate_normals_adaptive(
            pts[::stride], mask[::stride], k=max(k // stride, 4),
            r_probe=r_probe, r_min=r_min, r_max=r_max, window=window,
            probe_stride=probe_stride,
        )
        return _repeat_rows(sub, stride, mask)
    N = pts.shape[0]
    pts_m = torch.where(mask[:, None], pts, torch.full_like(pts, 1.0e6))
    r_lo, r_hi = float(r_probe[0]), float(r_probe[1])
    ps = max(int(probe_stride), 1)
    if ps > 32:
        raise ValueError(f"probe_stride must be <= 32, got {ps}")
    tgt = pts_m[::ps] if ps > 1 else None
    c_lo, c_hi = _radius_counts2(
        pts_m, (r_lo, r_hi), window, ts=max(256 // ps, 8), tgt=tgt
    )
    c_lo = torch.clamp(c_lo, min=2.0)
    c_hi = torch.clamp(c_hi, min=2.0)
    f = dict(dtype=pts.dtype, device=pts.device)
    # divisions by tensors: true f32 division, as in the JAX graph (a Python
    # scalar divisor may become a reciprocal multiply on the GPU)
    log_ratio = torch.log(torch.tensor(r_hi / r_lo, **f))
    dim = torch.clamp(torch.log(c_hi / c_lo) / log_ratio, 0.7, 2.5)
    r_i = torch.clamp(
        r_hi * (torch.full_like(c_hi, float(k)) / c_hi)
        ** (torch.ones_like(dim) / dim),
        r_min, r_max,
    )
    if ps > 1:
        r_i = torch.repeat_interleave(r_i, ps)[:N]
    return estimate_normals_radius(pts, mask, radius=r_i, window=window)
