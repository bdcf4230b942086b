"""Point-to-plane ICP and its two correspondence searches, written plainly.

Per iteration (the configuration's ``ICPConfig``): correspondences at the
current transform, the RMS plane error over the valid source rows,
convergence when it is below ``min_error`` or moved less than
``tolerance`` since the last iteration (the transform then stays), else a
Gauss-Newton step on the mean-normalised normal equations, left-composed.
A run that spends its budget is not converged. The final error is taken
at the final transform (on a converged exit the last iteration's, whose
transform did not move). Invalid source rows sit at a far sentinel; ``sample_points``
takes the evenly strided rows ``(j * count) // n`` of the valid prefix.

Searches, each over B lanes:

- exact 1-NN: every source row against every valid target row, squared
  distance in the difference form, the first index of the least;
- the slab window (``knn_backend="slab_pallas"``): the target is x-sorted;
  sources go in tiles of 256 rows, and each tile searches only the
  ``window`` target rows from a start read from a 4,096-bin table of x
  (bins over the valid targets' x range, the start the first target whose
  running-max x reaches the bin of the tile's least x minus a 3 m margin,
  rounded down to a multiple of 128 and kept inside the target padded to a
  multiple of 128).
"""

from __future__ import annotations

import torch

from . import se3
from .prec import FP32, Precision

SENTINEL = 1.0e6
_BINS = 4096
_QUANT = 128


def strided_rows(count: torch.Tensor, n: int) -> torch.Tensor:
    j = torch.arange(n, device=count.device)
    c = count.to(torch.int64)[..., None]
    return torch.where(c > n, (j * c) // n, j)


def _gather(x, idx):
    return torch.gather(x, 1, idx[..., None].expand(*idx.shape, x.shape[-1]))


def nn1_exact(src, tgt, tmask, chunk: int = 4096):
    """(B, S, 3) x (B, T, 3) -> first index of the least distance (B, S)."""
    tgt = torch.where(tmask[..., None], tgt, torch.full_like(tgt, SENTINEL))
    best_d = best_i = None
    for o in range(0, tgt.shape[1], chunk):
        t = tgt[:, o:o + chunk]
        dx = src[:, :, None, 0] - t[:, None, :, 0]
        dy = src[:, :, None, 1] - t[:, None, :, 1]
        dz = src[:, :, None, 2] - t[:, None, :, 2]
        d, i = torch.min(dx * dx + dy * dy + dz * dz, -1)
        i = i + o
        if best_d is None:
            best_d, best_i = d, i
        else:
            take = d < best_d
            best_d, best_i = torch.where(take, d, best_d), torch.where(take, i, best_i)
    return best_i


class SlabSearch:
    """The slab-window search over B targets, laid out once."""

    def __init__(self, tgt, tmask, window: int, margin: float = 3.0, ts: int = 256):
        B, T, _ = tgt.shape
        pad = -T % _QUANT
        t = torch.where(tmask[..., None], tgt, torch.full_like(tgt, SENTINEL))
        self.tgt = torch.cat([t, torch.full((B, pad, 3), SENTINEL, dtype=t.dtype,
                                            device=t.device)], 1)
        xs = tgt[..., 0]
        inf = torch.full_like(xs, float("inf"))
        lo = torch.where(tmask, xs, inf).min(-1).values
        hi = torch.where(tmask, xs, -inf).max(-1).values
        h = torch.clamp((hi - lo) / _BINS, min=1e-6)
        x_mono = torch.cummax(t[..., 0], -1).values.contiguous()
        edges = lo[:, None] + h[:, None] * torch.arange(_BINS, dtype=t.dtype,
                                                        device=t.device)
        self.lut = torch.searchsorted(x_mono, edges.contiguous(), side="left")
        self.lo, self.inv_h = lo, torch.ones_like(h) / h
        self.window = min(window, self.tgt.shape[1])
        self.margin, self.ts = margin, ts

    def __call__(self, src):
        B, S, _ = src.shape
        ts = min(self.ts, max(8, S))
        pad = -S % ts
        sp = torch.cat([src, torch.full((B, pad, 3), SENTINEL, dtype=src.dtype,
                                        device=src.device)], 1)
        tiles = sp.reshape(B, -1, ts, 3)
        tmin = tiles[..., 0].min(-1).values - self.margin
        b = torch.clamp(torch.floor((tmin - self.lo[:, None]) * self.inv_h[:, None]),
                        0, _BINS - 1).to(torch.int64)
        starts = torch.div(torch.gather(self.lut, 1, b), _QUANT,
                           rounding_mode="floor") * _QUANT
        starts = torch.clamp(starts, 0, max(self.tgt.shape[1] - self.window, 0))
        cols = starts[..., None] + torch.arange(self.window, device=src.device)
        win = torch.gather(self.tgt, 1, cols.reshape(B, -1, 1).expand(-1, -1, 3))
        win = win.reshape(B, -1, self.window, 3)
        dx = tiles[..., :, None, 0] - win[..., None, :, 0]
        dy = tiles[..., :, None, 1] - win[..., None, :, 1]
        dz = tiles[..., :, None, 2] - win[..., None, :, 2]
        am = torch.argmin(dx * dx + dy * dy + dz * dz, -1)
        return (am + starts[..., None]).reshape(B, -1)[:, :S]


def plane_error(cur, matched, nrm, w, denom):
    d = ((matched - cur) * nrm).sum(-1)
    return torch.sqrt((d * d * w).sum(-1) / denom)


def gn_step(cur, matched, nrm, w, damping, p: Precision):
    """One Gauss-Newton step of the point-to-plane error, (B, 4, 4)."""
    J = torch.cat([torch.linalg.cross(cur, nrm, dim=-1), nrm], -1)   # (B, S, 6)
    b = ((matched - cur) * nrm).sum(-1)
    denom = torch.clamp(w.sum(-1), min=1.0)
    Jw = (J * w[..., None]).transpose(1, 2)
    A = p.mm(Jw, J) / denom[:, None, None] + damping * torch.eye(
        6, dtype=cur.dtype, device=cur.device)
    rhs = p.mm(Jw, b[..., None])[..., 0] / denom[:, None]
    x = torch.linalg.solve(A, rhs)
    return se3.from_rt(se3.exp_so3(x[:, :3]), x[:, 3:])


def icp(src, smask, tgt, tmask, tnormals, cfg, init, search: str,
        window: int = 4096, inactive=None, p: Precision = FP32):
    """Register B sources onto B targets (all (B, N, 3)); ``cfg`` is an
    ``ICPConfig``. Returns ``(T (B, 4, 4), converged (B,), iterations (B,),
    final_error (B,))``."""
    if cfg.coarse_iterations > 0 or cfg.target_points > 0:
        raise NotImplementedError("coarse_iterations / target_points")
    B = tgt.shape[0]
    src, tgt, tnormals = p.inp(src), p.inp(tgt), p.inp(tnormals)
    T = p.inp(init.expand(B, 4, 4).clone())
    if search == "slab":
        find = SlabSearch(tgt, tmask, window)
    else:
        def find(s):
            return nn1_exact(s, tgt, tmask)
    tgt_m = torch.where(tmask[..., None], tgt, torch.full_like(tgt, SENTINEL))

    def match(T, pts):
        cur = se3.apply(T, pts, p)
        i = find(cur)
        return cur, _gather(tgt_m, i), _gather(tnormals, i)

    src = torch.where(smask[..., None], src, torch.full_like(src, SENTINEL))
    if 0 < cfg.sample_points < src.shape[1]:
        idx = strided_rows(smask.sum(-1), cfg.sample_points)
        src, smask = _gather(src, idx), torch.gather(smask, 1, idx)
    w = smask.to(src.dtype)
    denom = torch.clamp(w.sum(-1), min=1.0)
    it = torch.zeros(B, dtype=torch.int32, device=src.device)
    conv = torch.zeros(B, dtype=torch.bool, device=src.device) if inactive is None \
        else inactive.clone()
    prev = torch.full((B,), float("inf"), dtype=src.dtype, device=src.device)
    active = ~conv
    while bool(active.any()) and int(it.max()) < cfg.max_iterations:
        cur, m, n = match(T, src)
        err = plane_error(cur, m, n, w, denom)
        c = (err < cfg.min_error) | ((prev - err).abs() < cfg.tolerance)
        step = p.mm(gn_step(cur, m, n, w, cfg.solver_damping, p), T)
        T = torch.where((active & ~c)[:, None, None], step, T)
        prev = torch.where(active, err, prev)
        conv = torch.where(active, c, conv)
        it = it + active.to(torch.int32)
        active = active & ~c & (it < cfg.max_iterations)
    cur, m, n = match(T, src)
    return T, conv, it, plane_error(cur, m, n, w, denom)
