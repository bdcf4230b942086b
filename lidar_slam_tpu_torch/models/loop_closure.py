"""Two-stage loop-closure detection over a fixed-capacity keyframe database
(port of ``lidar_slam_tpu/models/loop_closure.py``).

- The DB is a set of preallocated per-frame tensors indexed by frame number
  (descriptors, clouds, masks, normals, an ``in_db`` flag), written IN PLACE
  by :func:`add_frame` (JAX donates the buffers instead).
- Stage 1: ONE matmul of the 60 rolled query descriptors against the whole
  DB (or, with ``ring_key_prefilter = k > 0``, against the k entries
  nearest in ring key, the rest at +inf), the candidate mask, and a STABLE
  ascending sort that keeps the best M = max_candidates * (1 +
  verify_extra_tranches) (ties keep the lower frame index, as ``lax.top_k``
  does).
- Stage 2: verification in gated tranches of ``max_candidates`` lanes, each
  tranche one batched ICP whose every correspondence search is ONE K2
  launch over all its lanes: the hoisted coarse phase, the coarse-reject
  gate, the fine verify, then the accept quota.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch

from ..config import ICPConfig, LoopClosureConfig, ScanContextConfig
from ..ops import knn_cuda, se3
from ..ops.icp import _gather_rows, _plane_error, icp_point_to_plane, solve_point_to_plane
from ..ops.scan_context import (
    sc_distances,
    sc_distances_ring_prefiltered,
    scan_context,
    shift_to_yaw,
)
from ..types import PointCloud, strided_prefix_idx


@dataclass
class KeyframeDB:
    """Per-frame keyframe storage (reference loop_closure.hpp:53-59)."""

    desc: torch.Tensor        # (F, R, S)
    desc_norm: torch.Tensor   # (F,)
    clouds: torch.Tensor      # (F, N, 3)
    cloud_mask: torch.Tensor  # (F, N) bool
    normals: torch.Tensor     # (F, N, 3)
    in_db: torch.Tensor       # (F,) bool — frame was addFrame'd
    last_frame: int = -1      # most recently added frame (-1 = none)


def init_db(max_frames: int, n_points: int, sc: ScanContextConfig,
            device=None) -> KeyframeDB:
    f32 = dict(dtype=torch.float32, device=device)
    return KeyframeDB(
        desc=torch.zeros((max_frames, sc.num_rings, sc.num_sectors), **f32),
        desc_norm=torch.zeros((max_frames,), **f32),
        clouds=torch.zeros((max_frames, n_points, 3), **f32),
        cloud_mask=torch.zeros((max_frames, n_points), dtype=torch.bool,
                               device=device),
        normals=torch.zeros((max_frames, n_points, 3), **f32),
        in_db=torch.zeros((max_frames,), dtype=torch.bool, device=device),
        last_frame=-1,
    )


def add_frame(db: KeyframeDB, cloud: PointCloud, frame: int,
              sc_cfg: ScanContextConfig, enabled: bool,
              normals: torch.Tensor) -> KeyframeDB:
    """addFrame (loop_closure.hpp:53-59), in place: the cloud, mask and
    normals are stored for every frame; the descriptor (from the FULL cloud)
    and ``in_db`` only when ``enabled`` (the frame-skip path adds nothing to
    the DB, slam_node.cpp:125-130)."""
    n_out = db.clouds.shape[1]
    if n_out >= cloud.points.shape[0]:
        pts, mask, nrm = cloud.points, cloud.mask, normals
    else:
        idx = strided_prefix_idx(cloud.count(), n_out)
        pts, mask, nrm = cloud.points[idx], cloud.mask[idx], normals[idx]
    db.clouds[frame] = pts
    db.cloud_mask[frame] = mask
    db.normals[frame] = nrm
    if enabled:
        desc = scan_context(cloud.points, cloud.mask, sc_cfg)
        db.desc[frame] = desc
        db.desc_norm[frame] = torch.sqrt(torch.sum(desc * desc))
        db.in_db[frame] = True
        db.last_frame = frame
    return db


def add_frame_lanes(db: KeyframeDB, cloud: PointCloud, frame: int,
                    sc_cfg: ScanContextConfig, enabled: list,
                    normals: torch.Tensor) -> KeyframeDB:
    """:func:`add_frame` for B lanes in lockstep, in place: ``db`` holds
    (B, F, ...) tensors and a per-lane ``last_frame`` list, ``cloud`` and
    ``normals`` are (B, N, ...), ``enabled`` one bool per lane. One write
    per field for all lanes, one Scan Context scatter; lane b's rows equal
    :func:`add_frame` on lane b's cloud."""
    n_out = db.clouds.shape[2]
    if n_out >= cloud.points.shape[1]:
        pts, mask, nrm = cloud.points, cloud.mask, normals
    else:
        idx = strided_prefix_idx(cloud.count(), n_out)
        idx3 = idx[..., None].expand(-1, -1, 3)
        pts, mask = torch.gather(cloud.points, 1, idx3), torch.gather(cloud.mask, 1, idx)
        nrm = torch.gather(normals, 1, idx3)
    db.clouds[:, frame] = pts
    db.cloud_mask[:, frame] = mask
    db.normals[:, frame] = nrm
    if any(enabled):
        en = torch.tensor(enabled, device=db.desc.device)
        desc = scan_context(cloud.points, cloud.mask, sc_cfg)
        # each lane's norm as add_frame takes it (a full sum of one descriptor)
        norm = torch.stack([torch.sqrt(torch.sum(d * d)) for d in desc])
        db.desc[:, frame] = torch.where(en[:, None, None], desc, db.desc[:, frame])
        db.desc_norm[:, frame] = torch.where(en, norm, db.desc_norm[:, frame])
        db.in_db[:, frame] |= en
        db.last_frame = [frame if e else f for e, f in zip(enabled, db.last_frame)]
    return db


@dataclass
class LoopDetections:
    """Result block (mirrors LoopClosureResult, loop_closure.hpp:25-31):
    length-M arrays ascending by SC distance; at most ``max_candidates``
    accepted."""

    accepted: torch.Tensor        # (M,) bool
    query_frame: int
    match_frame: torch.Tensor     # (M,) int64
    transform: torch.Tensor       # (M, 4, 4) query sensor frame -> match frame
    sc_distance: torch.Tensor     # (M,)
    icp_fitness: torch.Tensor     # (M,)
    coarse_fitness: torch.Tensor  # (M,)
    n_valid: int                  # candidates passing the SC gate
    fine_fired: bool              # >= 1 fine verify phase ran


def detect(
    db: KeyframeDB,
    cfg: LoopClosureConfig = LoopClosureConfig(),
    sc_cfg: ScanContextConfig = ScanContextConfig(),
    nn1_fn: Optional[Callable] = None,
    query: Optional[int] = None,
) -> LoopDetections:
    """detect() for frame ``query`` (default: the most recently added frame).

    Candidates are strictly older than the query by at least ``frame_gap``,
    so a query returns the same at any later time; a query frame that was
    never added rejects everything. ``nn1_fn`` is the exact batched 1-NN
    (default K2, ``knn_cuda.nn1``). One lane of :func:`detect_lanes`."""
    q = db.last_frame if query is None else int(query)
    lanes = KeyframeDB(desc=db.desc[None], desc_norm=db.desc_norm[None],
                       clouds=db.clouds[None], cloud_mask=db.cloud_mask[None],
                       normals=db.normals[None], in_db=db.in_db[None],
                       last_frame=[db.last_frame])
    return detect_lanes(lanes, cfg, sc_cfg, nn1_fn, [q],
                        explicit=query is not None)[0]


def detect_lanes(
    db: KeyframeDB,
    cfg: LoopClosureConfig,
    sc_cfg: ScanContextConfig,
    nn1_fn: Optional[Callable],
    queries: list,
    explicit: bool = True,
) -> list:
    """:func:`detect` for B lanes (a batched engine's DB: (B, F, ...)
    tensors), lane b querying frame ``queries[b]``; one
    :class:`LoopDetections` per lane, each what :func:`detect` gives on that
    lane alone.

    Retrieval runs once per lane. Verification runs tranche by tranche for
    all lanes together: a tranche is ONE batched ICP over B x
    ``max_candidates`` lanes, so each of its correspondence searches is one
    K2 launch for every lane. A lane whose tranche gate is closed (nothing
    valid, or its quota already met) or whose fine gate is closed enters
    that ICP inactive and takes the values :func:`detect` gives it without
    running it. ``explicit``: a query frame that was never added rejects
    everything."""
    if nn1_fn is None:
        nn1_fn = knn_cuda.nn1
    B, F = db.desc.shape[:2]
    K = cfg.max_candidates
    NT = 1 + max(cfg.verify_extra_tranches, 0)
    M = NT * K
    device = db.desc.device
    frames = torch.arange(F, device=device)
    f32 = dict(dtype=torch.float32, device=device)
    inf = float("inf")

    # stage 1, one retrieval per lane
    q_safe = [max(int(q), 0) for q in queries]
    idx_l, dist_l, shift_l, nval_l = [], [], [], []
    for b, q in enumerate(queries):
        qs = q_safe[b]
        if cfg.ring_key_prefilter > 0:
            dist, best_shift = sc_distances_ring_prefiltered(
                db.desc[b, qs], db.desc[b], db.desc_norm[b],
                k=min(cfg.ring_key_prefilter, F),
            )
        else:
            dist, best_shift = sc_distances(db.desc[b, qs], db.desc[b],
                                            db.desc_norm[b])
        cand_ok = (
            db.in_db[b]
            & (frames < qs)
            & ((qs - frames) >= cfg.frame_gap)
            & (dist < cfg.sc_distance_threshold)
        )
        if q < 0 or (explicit and not bool(db.in_db[b, qs])):
            cand_ok = torch.zeros_like(cand_ok)
        masked = torch.where(cand_ok, dist, torch.full_like(dist, inf))
        order = torch.sort(masked, stable=True).indices
        idx_l.append(order[:M])
        dist_l.append(masked[order[:M]])
        shift_l.append(best_shift[order[:M]])
        nval_l.append(cand_ok.sum())
    cand_idx = torch.stack(idx_l)                      # (B, M)
    cand_dist = torch.stack(dist_l)
    cand_valid = torch.isfinite(cand_dist)
    valid_h = cand_valid.cpu().tolist()
    n_valid = torch.stack(nval_l).cpu().tolist()

    lane = torch.arange(B, device=device)
    qt = torch.tensor(q_safe, device=device)
    query_pts, query_mask = db.clouds[lane, qt], db.cloud_mask[lane, qt]
    cand_clouds = db.clouds[lane[:, None], cand_idx]      # (B, M, N, 3)
    cand_masks = db.cloud_mask[lane[:, None], cand_idx]   # (B, M, N)
    cand_normals = db.normals[lane[:, None], cand_idx]    # (B, M, N, 3)
    N = db.clouds.shape[2]

    vc = cfg.verify_coarse_iterations
    do_coarse = vc > 0 and cfg.verify_coarse_sample < N
    icp_cfg = ICPConfig(
        max_iterations=cfg.icp_max_iterations,
        tolerance=cfg.verify_tolerance,
        sample_points=cfg.verify_sample,
        coarse_iterations=0,
        coarse_sample=cfg.verify_coarse_sample,
    )

    if cfg.yaw_seed:
        yaw = shift_to_yaw(torch.stack(shift_l), sc_cfg.num_sectors)
        zeros = torch.zeros_like(yaw)
        w = torch.stack([zeros, zeros, yaw], dim=-1)
        init_T = se3.from_rt(se3.exp_so3(w), torch.zeros((B, M, 3), **f32))
    else:
        init_T = torch.eye(4, **f32).expand(B, M, 4, 4)

    def rep(x):
        """Per lane -> per (lane, candidate) of a tranche."""
        return x.repeat_interleave(K, dim=0)

    if do_coarse:
        q_disp = torch.where(query_mask[..., None], query_pts,
                             torch.full_like(query_pts, 1.0e6))
        csrc = PointCloud(q_disp, query_mask).subsample(
            cfg.verify_coarse_sample
        )
        cw = csrc.mask.to(torch.float32)
        cdenom = torch.clamp(torch.sum(cw, dim=-1), min=1.0)
        c_pts, c_mask, c_w, c_denom = (rep(x) for x in
                                       (csrc.points, csrc.mask, cw, cdenom))

    def coarse_phase(cl, mk, nr, T):
        """The ICP coarse warm start on the tranche's lanes, plus each
        lane's coarse-sample plane RMS at the resulting transform."""

        def match(cur):
            idx, _ = nn1_fn(cur, cl, mk)
            return _gather_rows(cl, idx), _gather_rows(nr, idx)

        for _ in range(vc):
            cur = se3.apply(T, c_pts)
            matched, nrm = match(cur)
            delta = solve_point_to_plane(cur, matched, nrm, c_mask,
                                         icp_cfg.solver_damping)
            T = se3.compose(delta, T)
        cur = se3.apply(T, c_pts)
        matched, nrm = match(cur)
        return T, _plane_error(cur, matched, nrm, c_w, c_denom)

    def verify(cl, mk, nr, T0, skip):
        res = icp_point_to_plane(
            PointCloud(rep(query_pts), rep(query_mask)), PointCloud(cl, mk),
            nr, icp_cfg, T0, nn1_fn=nn1_fn, inactive=skip,
        )
        return res.transformation, res.converged, res.final_error

    reject = cfg.verify_coarse_reject if do_coarse else 0.0
    eye = torch.eye(4, **f32)

    def tranche(sl, gate):
        """Tranche ``[sl, sl + K)`` of every lane whose ``gate`` is open:
        ``(tf, conv, fit, cerr)`` as (B, K, ...) and each lane's fine
        gate."""
        g = torch.tensor(gate, device=device)
        if not any(gate):
            return (eye.expand(B, K, 4, 4),
                    torch.zeros((B, K), dtype=torch.bool, device=device),
                    torch.full((B, K), inf, **f32),
                    torch.full((B, K), inf, **f32), [False] * B)
        cl, mk, nr, T0, valid = (
            x[:, sl : sl + K].reshape(B * K, *x.shape[2:])
            for x in (cand_clouds, cand_masks, cand_normals, init_T, cand_valid)
        )
        gk = rep(g)
        if not do_coarse:
            tf, conv, fit = verify(cl, mk, nr, T0, ~valid | ~gk)
            cerr = torch.full((B * K,), inf, **f32)
            fine = list(gate)
        else:
            Tc, cerr = coarse_phase(cl, mk, nr, T0)
            if reject > 0:
                hopeless = cerr > reject
            else:
                hopeless = torch.zeros((B * K,), dtype=torch.bool, device=device)
            inact = ~valid | hopeless
            fine_t = (~inact).reshape(B, K).any(dim=-1) & g
            fine = fine_t.cpu().tolist()
            if any(fine):
                tf, conv, fit = verify(cl, mk, nr, Tc, inact | ~rep(fine_t))
                fk = rep(fine_t)
                tf = torch.where(fk[:, None, None], tf, Tc)
                conv = conv & fk
                fit = torch.where(fk, fit, torch.full_like(fit, inf))
            else:
                tf = Tc
                conv = torch.zeros((B * K,), dtype=torch.bool, device=device)
                fit = torch.full((B * K,), inf, **f32)
            conv = conv & ~hopeless
            fit = torch.where(hopeless, torch.full_like(fit, inf), fit)
        # lanes whose tranche did not run keep the values of a skipped one
        tf = torch.where(gk[:, None, None], tf, eye)
        conv = conv & gk
        fit = torch.where(gk, fit, torch.full_like(fit, inf))
        cerr = torch.where(gk, cerr, torch.full_like(cerr, inf))
        return (tf.reshape(B, K, 4, 4), conv.reshape(B, K), fit.reshape(B, K),
                cerr.reshape(B, K), fine)

    thr = cfg.icp_fitness_threshold
    tf, conv, fit, cerr, fine_any = tranche(0, [any(v[:K]) for v in valid_h])
    tfs, convs, fits, cerrs = [tf], [conv], [fit], [cerr]
    if NT > 1:
        acc0 = cand_valid[:, :K] & conv & (fit < thr)
        n_acc = acc0.sum(dim=-1).cpu().tolist()
    for t in range(1, NT):
        sl = t * K
        gate = [n_acc[b] < K and any(valid_h[b][sl : sl + K]) for b in range(B)]
        tf_t, conv_t, fit_t, cerr_t, ff_t = tranche(sl, gate)
        tfs.append(tf_t)
        convs.append(conv_t)
        fits.append(fit_t)
        cerrs.append(cerr_t)
        fine_any = [a or f for a, f in zip(fine_any, ff_t)]
        if t + 1 < NT:
            acc_t = cand_valid[:, sl : sl + K] & conv_t & (fit_t < thr)
            n_acc = [a + n for a, n in zip(n_acc, acc_t.sum(dim=-1).cpu().tolist())]
    tf, conv, fit, cerr = (torch.cat(x, dim=1) for x in (tfs, convs, fits, cerrs))

    accepted = cand_valid & conv & (fit < thr)
    # quota: keep the first K acceptances in ascending-distance order
    accepted = accepted & (torch.cumsum(accepted.to(torch.int32), -1) <= K)
    return [
        LoopDetections(
            accepted=accepted[b],
            query_frame=q_safe[b],
            match_frame=cand_idx[b],
            transform=tf[b],
            sc_distance=cand_dist[b],
            icp_fitness=fit[b],
            coarse_fitness=cerr[b],
            n_valid=int(n_valid[b]),
            fine_fired=bool(fine_any[b]),
        )
        for b in range(B)
    ]
