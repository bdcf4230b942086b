"""Point-to-plane ICP (port of ``lidar_slam_tpu/ops/icp.py``).

Same per-iteration math and bookkeeping as the JAX package (reference
icp.hpp:157-258): 1-NN correspondences -> RMS plane error (recorded before
the solve) -> convergence test (err < min_error or |prev - err| < tolerance)
-> mean-normalised Gauss-Newton 6-DoF solve -> left-composed delta with the
raw translation; ``converged`` stays False when the budget runs out; the
final error is recomputed with the final correspondences, except on a
converged exit, where the last iteration's correspondences are the final
ones and are reused (``icp.py:223-234``).

The ``lax.while_loop`` becomes a Python loop over lanes: the inputs may carry
a leading batch of B lanes (loop verification runs its candidates as one
batch). Each iteration runs every lane's correspondence search in one call
and then updates only the lanes still active, so a converged or inactive
lane stays frozen exactly as under ``vmap``; the loop ends when no lane is
active.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..config import ICPConfig
from ..types import ICPResult, PointCloud, strided_prefix_idx
from ..utils import tracing
from . import knn_cuda, se3
from .linalg import solve_psd_small
from .normals import estimate_normals


def _lane_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` as one 2-D product per leading-dim lane: a lane's normal
    equations then round the same however many lanes run with it (a
    batched cuBLAS call takes another plan for another batch size, and a
    lane of a batch parted from the lane alone by a few ulps, which
    failing ICPs amplify)."""
    if a.dim() == 2:
        return a @ b
    lead = a.shape[:-2]
    a2 = a.reshape(-1, *a.shape[-2:])
    b2 = b.reshape(-1, *b.shape[-2:])
    out = torch.stack([x @ y for x, y in zip(a2, b2)])
    return out.reshape(*lead, *out.shape[-2:])


def lane_compose(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``se3.compose`` of (..., 4, 4) lanes with each lane its own
    batch-of-one product, so a lane's pose rounds as a one-lane batch's
    does however many lanes run with it (for :func:`_lane_mm`'s reason;
    one lane is ``se3.compose`` itself)."""
    if a.dim() == 2:
        return se3.compose(a, b)
    a3, b3 = a.reshape(-1, 4, 4), b.reshape(-1, 4, 4)
    if a3.shape[0] == 1:
        return se3.compose(a3, b3).reshape(a.shape)
    return torch.cat([se3.compose(x, y) for x, y in zip(a3.split(1), b3.split(1))]
                     ).reshape(a.shape)


def solve_point_to_plane(
    src: torch.Tensor,
    tgt_matched: torch.Tensor,
    normals: torch.Tensor,
    weights: torch.Tensor,
    damping: float = 1e-9,
) -> torch.Tensor:
    """One Gauss-Newton step; (..., N, 3) inputs -> (..., 4, 4) delta.

    The normal equations are mean-normalised (summed then divided by the
    valid count) for f32 conditioning, as in the JAX package."""
    pxn = torch.linalg.cross(src, normals, dim=-1)
    J = torch.cat([pxn, normals], dim=-1)                      # (..., N, 6)
    b = torch.sum((tgt_matched - src) * normals, dim=-1)        # (..., N)
    w = weights.to(src.dtype)
    denom = torch.clamp(torch.sum(w, dim=-1), min=1.0)          # (...)
    JwT = (J * w[..., None]).transpose(-1, -2)
    eye = torch.eye(6, dtype=src.dtype, device=src.device)
    A = _lane_mm(JwT, J) / denom[..., None, None] + damping * eye
    rhs = _lane_mm(JwT, b[..., None])[..., 0] / denom[..., None]
    x = solve_psd_small(A, rhs)
    return se3.from_rt(se3.exp_so3(x[..., :3]), x[..., 3:])


def _lane_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum over the last dim as one 1-D reduction per leading-dim lane,
    for the reason of :func:`_lane_mm`: a row sum over a batch is split
    over blocks by the batch's size, and a lane's plane error then decides
    its convergence test differently alone and in a batch."""
    flat = x.reshape(-1, x.shape[-1])
    if flat.shape[0] == 1:
        return flat[0].sum().reshape(x.shape[:-1])
    return torch.stack([row.sum() for row in flat]).reshape(x.shape[:-1])


def _plane_error(cur, matched, normals, w, denom):
    d = torch.sum((matched - cur) * normals, dim=-1)
    return torch.sqrt(_lane_sum(d * d * w) / denom)


def _gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, T, C), idx (B, S) -> (B, S, C)."""
    idx = idx.to(torch.int64)
    return torch.gather(x, 1, idx[..., None].expand(*idx.shape, x.shape[-1]))


def icp_point_to_plane(
    src: PointCloud,
    tgt: PointCloud,
    tgt_normals: torch.Tensor,
    config: ICPConfig = ICPConfig(),
    init_transform: Optional[torch.Tensor] = None,
    nn1_fn: Optional[Callable] = None,
    inactive: Optional[torch.Tensor] = None,
) -> ICPResult:
    """Register ``src`` onto ``tgt``: returns T with T(src) ~= tgt.

    Unbatched inputs are (N, 3) clouds; batched inputs carry B lanes in
    front of the target ((B, T, 3)); a single (N, 3) source is shared by all
    lanes. Backend protocols, as in the JAX package:

    - plain ``nn1_fn(src (B,S,3), tgt (B,T,3), mask (B,T)) -> (idx, d2)``
      (default: K2, ``knn_cuda.nn1``);
    - ``nn1_fn.prepare(tgt, mask)`` -> ``query(src) -> (idx, d2)``, built once;
    - ``nn1_fn.prepare_match(tgt, mask, normals)`` -> ``query(cur) ->
      (matched, normals, d2)`` for all lanes at once (K1's fused form: one
      launch a query, each lane against its own target).

    ``inactive`` (bool per lane): the lane starts converged; only the final
    correspondence pass runs for it.

    Traced as an ``icp`` span (with the K1 and K2 launches it made):
    ``coarse``, an ``iter`` per loop pass ending at its ``icp.active``
    read, and ``final``.
    """
    with tracing.span("icp", kernels=knn_cuda.KERNELS):
        return _icp(src, tgt, tgt_normals, config, init_transform, nn1_fn,
                    inactive)


def _icp(src, tgt, tgt_normals, config, init_transform, nn1_fn, inactive):
    batched = tgt.points.dim() == 3
    if not batched:
        tgt = PointCloud(tgt.points[None], tgt.mask[None])
        tgt_normals = tgt_normals[None]
    B = tgt.points.shape[0]
    dtype, device = tgt.points.dtype, tgt.points.device
    if src.points.dim() == 2:
        src = PointCloud(
            src.points[None].expand(B, -1, -1), src.mask[None].expand(B, -1)
        )
    if nn1_fn is None:
        nn1_fn = knn_cuda.nn1
    if init_transform is None:
        init_transform = se3.identity(dtype, device)
    T = init_transform.to(dtype).expand(B, 4, 4).clone()

    if 0 < config.target_points < tgt.points.shape[-2]:
        t_idx = strided_prefix_idx(tgt.count(), config.target_points)
        tgt = PointCloud(_gather_rows(tgt.points, t_idx),
                         torch.gather(tgt.mask, 1, t_idx))
        tgt_normals = _gather_rows(tgt_normals, t_idx)

    prepare_match = getattr(nn1_fn, "prepare_match", None)
    if prepare_match is not None:
        match_q = prepare_match(tgt.points, tgt.mask, tgt_normals)

        def match_query(cur):
            m, n, _ = match_q(cur)
            return m, n

    else:
        prepare = getattr(nn1_fn, "prepare", None)
        if prepare is not None:
            nn_query = prepare(tgt.points, tgt.mask)
        else:
            def nn_query(s):
                return nn1_fn(s, tgt.points, tgt.mask)

        def match_query(cur):
            idx, _ = nn_query(cur)
            return _gather_rows(tgt.points, idx), _gather_rows(tgt_normals, idx)

    # Invalid source rows go to the far sentinel: they are weight-masked
    # everywhere, but the slab window must not see padding at the origin.
    src = PointCloud(
        torch.where(src.mask[..., None], src.points,
                    torch.full_like(src.points, 1.0e6)),
        src.mask,
    )
    full_src = src
    if 0 < config.sample_points < src.points.shape[-2]:
        src = src.subsample(config.sample_points)

    if config.coarse_iterations > 0 and config.coarse_sample < src.points.shape[-2]:
        with tracing.span("coarse"):
            csrc = full_src.subsample(config.coarse_sample)
            for _ in range(config.coarse_iterations):
                cur = se3.apply(T, csrc.points)
                matched, nrm = match_query(cur)
                delta = solve_point_to_plane(
                    cur, matched, nrm, csrc.mask, config.solver_damping
                )
                T = lane_compose(delta, T)

    w = src.mask.to(dtype)
    denom = torch.clamp(torch.sum(w, dim=-1), min=1.0)
    max_it = config.max_iterations

    def correspondences(T):
        cur = se3.apply(T, src.points)
        matched, nrm = match_query(cur)
        return cur, matched, nrm

    it = torch.zeros((B,), dtype=torch.int32, device=device)
    prev_err = torch.full((B,), float("inf"), dtype=dtype, device=device)
    if inactive is None:
        converged = torch.zeros((B,), dtype=torch.bool, device=device)
    else:
        converged = torch.as_tensor(inactive, device=device).reshape(B).clone()
    hist = torch.zeros((B, max_it + 1), dtype=dtype, device=device)
    cur = matched = nrm = torch.zeros_like(src.points)
    slots = torch.arange(max_it + 1, device=device)

    active = (it < max_it) & ~converged
    go = tracing.host_read("icp.active", active.any())
    while go:
        with tracing.span("iter"):
            c_cur, c_matched, c_nrm = correspondences(T)
            err = _plane_error(c_cur, c_matched, c_nrm, w, denom)
            conv = (err < config.min_error) | (
                torch.abs(prev_err - err) < config.tolerance
            )
            delta = solve_point_to_plane(
                c_cur, c_matched, c_nrm, src.mask, config.solver_damping
            )
            T_new = torch.where(conv[:, None, None], T, lane_compose(delta, T))
            a = active
            hist = torch.where(
                a[:, None] & (slots[None, :] == it[:, None]), err[:, None], hist
            )
            T = torch.where(a[:, None, None], T_new, T)
            prev_err = torch.where(a, err, prev_err)
            converged = torch.where(a, conv, converged)
            a3 = a[:, None, None]
            cur = torch.where(a3, c_cur, cur)
            matched = torch.where(a3, c_matched, matched)
            nrm = torch.where(a3, c_nrm, nrm)
            it = it + a.to(torch.int32)
            active = (it < max_it) & ~converged
            go = tracing.host_read("icp.active", active.any())

    # Final error with the final correspondences: reuse the last iteration's
    # on a converged exit, recompute on budget exhaustion or a zero-iteration
    # (inactive) start.
    with tracing.span("final"):
        need = ~(converged & (it > 0))
        if tracing.host_read("icp.need", need.any()):
            f_cur, f_matched, f_nrm = correspondences(T)
            n3 = need[:, None, None]
            cur = torch.where(n3, f_cur, cur)
            matched = torch.where(n3, f_matched, matched)
            nrm = torch.where(n3, f_nrm, nrm)
        final_err = _plane_error(cur, matched, nrm, w, denom)
        hist = torch.where(slots[None, :] == it[:, None], final_err[:, None],
                           hist)

    res = ICPResult(T, converged, it, hist, final_err)
    if not batched:
        res = ICPResult(T[0], converged[0], it[0], hist[0], final_err[0])
    return res


def icp_point_to_plane_auto(
    src: PointCloud,
    tgt: PointCloud,
    config: ICPConfig = ICPConfig(),
    init_transform: Optional[torch.Tensor] = None,
) -> ICPResult:
    """Reference-shaped API: estimates the target's k-NN PCA normals
    (``config.normal_k`` neighbours) and then registers (reference
    icp.hpp:166-171)."""
    normals = estimate_normals(tgt.points, tgt.mask, k=config.normal_k)
    return icp_point_to_plane(src, tgt, normals, config, init_transform)
