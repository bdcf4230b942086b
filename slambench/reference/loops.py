"""Loop detection, written plainly: Scan Context retrieval, then gated
verification ICP (the configuration's ``LoopClosureConfig`` and
``ScanContextConfig``).

- Descriptor: rings x sectors over range [min_range, max_range] and angle
  atan2(y, x) + pi, the greatest z in each bin, 0 for an empty bin.
- Distance of a query to a DB entry: 1 - the best cosine similarity over
  the query's column shifts (dot products summed in float64), with the
  shift that gives it; 1 where a norm is below 1e-10.
- Candidates: DB frames at least ``frame_gap`` older than the query, with a
  distance under ``sc_distance_threshold``, nearest first (ties to the
  older frame); at most ``max_candidates * (1 + verify_extra_tranches)``.
- Verification, a tranche of ``max_candidates`` at a time, a tranche only
  while fewer than ``max_candidates`` loops were accepted and it holds a
  candidate: from the yaw of the best shift (``yaw_seed``) or the identity,
  optionally ``verify_coarse_iterations`` Gauss-Newton steps on an evenly
  strided ``verify_coarse_sample`` of the query with exact 1-NN, a
  candidate whose coarse plane error exceeds ``verify_coarse_reject``
  dropped; then ICP (``icp_max_iterations``, ``verify_tolerance``,
  ``verify_sample``) with exact 1-NN. A candidate is accepted when its ICP
  converged with a final error under ``icp_fitness_threshold``; the first
  ``max_candidates`` acceptances in distance order are kept.
"""

from __future__ import annotations

import math
from types import SimpleNamespace

import torch

from . import se3
from .icp import SENTINEL, _gather, gn_step, icp, nn1_exact, plane_error, strided_rows
from .prec import FP32, Precision


def descriptor(pts, mask, sc) -> torch.Tensor:
    R, S = sc.num_rings, sc.num_sectors
    x, y, z = pts[:, 0], pts[:, 1], pts[:, 2]
    rng = torch.sqrt(x * x + y * y)
    ang = torch.atan2(y, x) + math.pi
    ok = mask & (rng <= sc.max_range) & (rng >= sc.min_range)
    f = dict(dtype=pts.dtype, device=pts.device)
    ring = torch.clamp((rng / torch.tensor(sc.max_range / R, **f)).to(torch.int64), 0, R - 1)
    sector = torch.clamp((ang / torch.tensor(2 * math.pi / S, **f)).to(torch.int64), 0, S - 1)
    desc = torch.full((R * S,), -math.inf, **f)
    desc = desc.scatter_reduce(0, (ring * S + sector)[ok], z[ok], reduce="amax")
    desc = torch.where(torch.isinf(desc), torch.zeros_like(desc), desc)
    return desc.reshape(R, S)


def distances(query, db, db_norm):
    """(F,) distances of one (R, S) query to (F, R, S) descriptors, and the
    best shift of each."""
    S = query.shape[-1]
    F = db.shape[0]
    rolled = torch.stack([torch.roll(query, s, dims=-1) for s in range(S)]).reshape(S, -1)
    dots = (rolled.double() @ db.reshape(F, -1).double().T).float()
    norm = torch.sqrt((query * query).sum()) * db_norm
    sims = dots / torch.clamp(norm, min=1e-30)[None, :]
    shift = torch.argmax(sims, 0)
    dist = 1.0 - sims.gather(0, shift[None])[0]
    return torch.where(norm < 1e-10, torch.ones_like(dist), dist), shift


def candidates(q, desc, desc_norm, in_db, cfg):
    """The candidate frames of query ``q`` in retrieval order, with their
    distances and best shifts (frames 0 .. q - 1 of the DB)."""
    F = desc.shape[0]
    dist, shift = distances(desc[q], desc, desc_norm)
    frames = torch.arange(F, device=desc.device)
    ok = in_db & (frames < q) & ((q - frames) >= cfg.frame_gap) & (dist < cfg.sc_distance_threshold)
    if not bool(in_db[q]):
        ok = torch.zeros_like(ok)
    M = cfg.max_candidates * (1 + max(cfg.verify_extra_tranches, 0))
    key = torch.where(ok, dist, torch.full_like(dist, math.inf))
    order = torch.sort(key, stable=True).indices[:M]
    keep = torch.isfinite(key[order])
    return order[keep], dist[order[keep]], shift[order[keep]]


def verify(q_pts, q_mask, cand, clouds, masks, normals, shifts, lc, sc, icp_cfg,
           p: Precision = FP32):
    """Accepted ``(match, transform)`` of one query over its candidates."""
    K = lc.max_candidates
    dev = q_pts.device
    accepted = []
    for t0 in range(0, len(cand), K):
        if len(accepted) >= K:
            break
        sl = slice(t0, min(t0 + K, len(cand)))
        idx = cand[sl]
        B = idx.shape[0]
        cl, mk, nr = p.inp(clouds(idx)), masks(idx), p.inp(normals(idx))
        if lc.yaw_seed:
            s = shifts[sl].to(torch.float32)
            s = torch.where(s > sc.num_sectors / 2.0, s - sc.num_sectors, s)
            yaw = s * (2.0 * math.pi / sc.num_sectors)
            w = torch.stack([torch.zeros_like(yaw), torch.zeros_like(yaw), yaw], -1)
            T = se3.from_rt(se3.exp_so3(w), torch.zeros((B, 3), device=dev))
        else:
            T = torch.eye(4, device=dev).expand(B, 4, 4).clone()
        qp = p.inp(q_pts)[None].expand(B, -1, -1)
        qm = q_mask[None].expand(B, -1)
        hopeless = torch.zeros(B, dtype=torch.bool, device=dev)
        if lc.verify_coarse_iterations > 0 and lc.verify_coarse_sample < q_pts.shape[0]:
            disp = torch.where(qm[..., None], qp, torch.full_like(qp, SENTINEL))
            ci = strided_rows(qm.sum(-1), lc.verify_coarse_sample)
            cp, cm = _gather(disp, ci), torch.gather(qm, 1, ci)
            cw = cm.to(torch.float32)
            cl_m = torch.where(mk[..., None], cl, torch.full_like(cl, SENTINEL))

            def match(T):
                cur = se3.apply(T, cp, p)
                i = nn1_exact(cur, cl, mk)
                return cur, _gather(cl_m, i), _gather(nr, i)

            for _ in range(lc.verify_coarse_iterations):
                cur, m, n = match(T)
                T = p.mm(gn_step(cur, m, n, cw, icp_cfg.solver_damping, p), T)
            cur, m, n = match(T)
            cerr = plane_error(cur, m, n, cw, torch.clamp(cw.sum(-1), min=1.0))
            if lc.verify_coarse_reject > 0:
                hopeless = cerr > lc.verify_coarse_reject
        Tf, conv, _, fit = icp(qp, qm, cl, mk, nr, icp_cfg, T, "exact",
                               inactive=hopeless, p=p)
        ok = conv & ~hopeless & (fit < lc.icp_fitness_threshold)
        for k in range(B):
            if bool(ok[k]) and len(accepted) < K:
                accepted.append((int(idx[k]), Tf[k]))
    return accepted


def verify_icp_config(lc) -> SimpleNamespace:
    """The verification ICP's settings: the loop config's budget, tolerance
    and sample, the ICP defaults otherwise (min_error and damping 1e-9)."""
    return SimpleNamespace(max_iterations=lc.icp_max_iterations,
                           tolerance=lc.verify_tolerance, min_error=1e-9,
                           solver_damping=1e-9, sample_points=lc.verify_sample,
                           coarse_iterations=0, target_points=0)
