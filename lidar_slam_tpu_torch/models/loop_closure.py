"""Two-stage loop-closure detection over a fixed-capacity keyframe database
(port of ``lidar_slam_tpu/models/loop_closure.py``).

- The DB is a set of preallocated per-frame tensors indexed by frame number
  (descriptors, clouds, masks, normals, an ``in_db`` flag), written IN PLACE
  by :func:`add_frame` (JAX donates the buffers instead).
- Stage 1: ONE matmul of the 60 rolled query descriptors against the whole
  DB, the candidate mask, and a STABLE ascending sort that keeps the best
  M = max_candidates * (1 + verify_extra_tranches) (ties keep the lower
  frame index, as ``lax.top_k`` does).
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
from ..ops.scan_context import sc_distances, scan_context, shift_to_yaw
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
    (default K2, ``knn_cuda.nn1``)."""
    if cfg.ring_key_prefilter > 0:
        raise NotImplementedError("ring_key_prefilter is not ported")
    if nn1_fn is None:
        nn1_fn = knn_cuda.nn1
    F = db.desc.shape[0]
    K = cfg.max_candidates
    device = db.desc.device
    q = db.last_frame if query is None else int(query)
    q_safe = max(q, 0)

    dist, best_shift = sc_distances(db.desc[q_safe], db.desc, db.desc_norm)
    frames = torch.arange(F, device=device)
    cand_ok = (
        db.in_db
        & (frames < q_safe)
        & ((q_safe - frames) >= cfg.frame_gap)
        & (dist < cfg.sc_distance_threshold)
    )
    if q < 0 or (query is not None and not bool(db.in_db[q_safe])):
        cand_ok = torch.zeros_like(cand_ok)

    NT = 1 + max(cfg.verify_extra_tranches, 0)
    M = NT * K
    masked = torch.where(cand_ok, dist, torch.full_like(dist, float("inf")))
    order = torch.sort(masked, stable=True).indices
    cand_idx = order[:M]
    cand_dist = masked[cand_idx]
    cand_valid = torch.isfinite(cand_dist)
    valid_h = cand_valid.cpu().tolist()

    query_cloud = PointCloud(db.clouds[q_safe], db.cloud_mask[q_safe])
    cand_clouds = db.clouds[cand_idx]      # (M, N, 3)
    cand_masks = db.cloud_mask[cand_idx]   # (M, N)
    cand_normals = db.normals[cand_idx]    # (M, N, 3)
    N = db.clouds.shape[1]

    vc = cfg.verify_coarse_iterations
    do_coarse = vc > 0 and cfg.verify_coarse_sample < N
    icp_cfg = ICPConfig(
        max_iterations=cfg.icp_max_iterations,
        tolerance=cfg.verify_tolerance,
        sample_points=cfg.verify_sample,
        coarse_iterations=0,
        coarse_sample=cfg.verify_coarse_sample,
    )

    f32 = dict(dtype=torch.float32, device=device)
    if cfg.yaw_seed:
        yaw = shift_to_yaw(best_shift[cand_idx], sc_cfg.num_sectors)
        zeros = torch.zeros_like(yaw)
        w = torch.stack([zeros, zeros, yaw], dim=-1)
        init_T = se3.from_rt(se3.exp_so3(w), torch.zeros((M, 3), **f32))
    else:
        init_T = torch.eye(4, **f32).expand(M, 4, 4)

    if do_coarse:
        q_disp = torch.where(query_cloud.mask[:, None], query_cloud.points,
                             torch.full_like(query_cloud.points, 1.0e6))
        csrc = PointCloud(q_disp, query_cloud.mask).subsample(
            cfg.verify_coarse_sample
        )
        cw = csrc.mask.to(torch.float32)
        cdenom = torch.clamp(torch.sum(cw), min=1.0)

    def coarse_phase(cl, mk, nr, T):
        """The ICP coarse warm start on ``len(cl)`` lanes, plus each lane's
        coarse-sample plane RMS at the resulting transform."""
        B = cl.shape[0]
        pts = csrc.points[None].expand(B, -1, -1)
        cmask = csrc.mask[None].expand(B, -1)

        def match(cur):
            idx, _ = nn1_fn(cur, cl, mk)
            return _gather_rows(cl, idx), _gather_rows(nr, idx)

        for _ in range(vc):
            cur = se3.apply(T, pts)
            matched, nrm = match(cur)
            delta = solve_point_to_plane(cur, matched, nrm, cmask,
                                         icp_cfg.solver_damping)
            T = se3.compose(delta, T)
        cur = se3.apply(T, pts)
        matched, nrm = match(cur)
        return T, _plane_error(cur, matched, nrm, cw, cdenom)

    def verify(cl, mk, nr, T0, skip):
        res = icp_point_to_plane(
            query_cloud, PointCloud(cl, mk), nr, icp_cfg, T0,
            nn1_fn=nn1_fn, inactive=skip,
        )
        return res.transformation, res.converged, res.final_error

    def skipped(k):
        return (
            torch.eye(4, **f32).expand(k, 4, 4),
            torch.zeros((k,), dtype=torch.bool, device=device),
            torch.full((k,), float("inf"), **f32),
            torch.full((k,), float("inf"), **f32),
            False,
        )

    reject = cfg.verify_coarse_reject if do_coarse else 0.0

    def tranche(sl, run_gate):
        if not run_gate:
            return skipped(K)
        cl = cand_clouds[sl : sl + K]
        mk = cand_masks[sl : sl + K]
        nr = cand_normals[sl : sl + K]
        T0 = init_T[sl : sl + K]
        valid = cand_valid[sl : sl + K]
        if not do_coarse:
            tf, conv, fit = verify(cl, mk, nr, T0, ~valid)
            return tf, conv, fit, torch.full((K,), float("inf"), **f32), True
        Tc, cerr = coarse_phase(cl, mk, nr, T0)
        if reject > 0:
            hopeless = cerr > reject
        else:
            hopeless = torch.zeros((K,), dtype=torch.bool, device=device)
        inact = ~valid | hopeless
        fine_gate = bool((~inact).any())
        if fine_gate:
            tf, conv, fit = verify(cl, mk, nr, Tc, inact)
        else:
            tf = Tc
            conv = torch.zeros((K,), dtype=torch.bool, device=device)
            fit = torch.full((K,), float("inf"), **f32)
        conv = conv & ~hopeless
        fit = torch.where(hopeless, torch.full_like(fit, float("inf")), fit)
        return tf, conv, fit, cerr, fine_gate

    thr = cfg.icp_fitness_threshold
    tf, conv, fit, cerr, fine_any = tranche(0, any(valid_h[:K]))
    acc0 = cand_valid[:K] & conv & (fit < thr)
    n_acc = int(acc0.sum())
    tfs, convs, fits, cerrs = [tf], [conv], [fit], [cerr]
    for t in range(1, NT):
        sl = t * K
        gate = n_acc < K and any(valid_h[sl : sl + K])
        tf_t, conv_t, fit_t, cerr_t, ff_t = tranche(sl, gate)
        tfs.append(tf_t)
        convs.append(conv_t)
        fits.append(fit_t)
        cerrs.append(cerr_t)
        fine_any = fine_any or ff_t
        acc_t = cand_valid[sl : sl + K] & conv_t & (fit_t < thr)
        n_acc += int(acc_t.sum())
    tf, conv, fit, cerr = (torch.cat(x) for x in (tfs, convs, fits, cerrs))

    accepted = cand_valid & conv & (fit < thr)
    # quota: keep the first K acceptances in ascending-distance order
    accepted = accepted & (torch.cumsum(accepted.to(torch.int32), 0) <= K)
    return LoopDetections(
        accepted=accepted,
        query_frame=q_safe,
        match_frame=cand_idx,
        transform=tf,
        sc_distance=cand_dist,
        icp_fitness=fit,
        coarse_fitness=cerr,
        n_valid=int(cand_ok.sum()),
        fine_fired=fine_any,
    )
