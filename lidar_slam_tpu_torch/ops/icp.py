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

The arithmetic of each iteration after the correspondence search is one
``icp_step`` launch (``ops/icp_cuda.py``, ``csrc/icp_step.cu``): the plane
error, the convergence test, the 6 x 6 solve, the SE(3) update and the
bookkeeping of every lane, and the flag the host reads once an iteration.
The loop is the same on every device; the launch comes from the tensors'
device (``cuda_lib.use_kernel``): the kernel for CUDA tensors, its plain
version :func:`icp_step_torch` for CPU tensors.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..config import ICPConfig
from ..types import ICPResult, PointCloud, strided_prefix_idx
from ..utils import tracing
from . import cuda_lib, icp_cuda, knn_cuda, se3
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


def _matcher(nn1_fn, tgt_pts, tgt_mask, tgt_normals):
    """``match(cur) -> (pts, nrm, idx)`` for the search backend ``nn1_fn``
    (the protocols of :func:`icp_point_to_plane`), laid out once: K1's fused
    form gives the matched rows themselves (``idx`` None); a backend that
    returns indices gives the targets, their normals and the index (int32
    on the card, for ``icp_step`` to gather)."""
    prepare_match = getattr(nn1_fn, "prepare_match", None)
    if prepare_match is not None:
        match_q = prepare_match(tgt_pts, tgt_mask, tgt_normals)

        def match(cur):
            m, n, _ = match_q(cur)
            return m, n, None

        return match
    prepare = getattr(nn1_fn, "prepare", None)
    if prepare is not None:
        nn_query = prepare(tgt_pts, tgt_mask)
    else:
        def nn_query(s):
            return nn1_fn(s, tgt_pts, tgt_mask)

    def match(cur):
        idx, _ = nn_query(cur)
        if idx.is_cuda and idx.dtype != torch.int32:
            idx = idx.to(torch.int32)
        return tgt_pts, tgt_normals, idx

    return match


def _rows(match):
    """The matched points and normals of a ``match`` result."""
    pts, nrm, idx = match
    if idx is None:
        return pts, nrm
    return _gather_rows(pts, idx), _gather_rows(nrm, idx)


def icp_step_torch(mode: str, st: icp_cuda.IcpState, cur: torch.Tensor,
                   src=None, mask=None, match=None) -> None:
    """Plain version of the ``icp_step`` kernel (``icp_cuda.launch``, same
    arguments), in place on ``st``: ``apply`` writes ``cur = T src``;
    ``coarse`` composes every lane with its Gauss-Newton step; ``step`` is
    the arithmetic of one iteration of :func:`_icp_loop` (recording a
    converging lane's error as its final one too) and writes ``st.flags``;
    ``final`` writes ``st.err``: the plane error of the lanes that need the
    final pass and the last iteration's of the others (of every lane, for a
    state without a loop)."""
    if mode == "apply":
        cur.copy_(se3.apply(st.T, src))
        return
    matched, nrm = _rows(match)
    if mode == "coarse":
        delta = solve_point_to_plane(cur, matched, nrm, mask, st.damping)
        st.T.copy_(lane_compose(delta, st.T))
        return
    w = mask.to(cur.dtype)
    denom = torch.clamp(torch.sum(w, dim=-1), min=1.0)
    err = _plane_error(cur, matched, nrm, w, denom)
    if st.it is None:
        st.err.copy_(err)
        return
    slots = torch.arange(st.hist.shape[1], device=cur.device)[None, :]
    if mode == "final":
        need = ~(st.converged & (st.it > 0))
        f = torch.where(need, err, st.prev_err)
        st.err.copy_(f)
        st.hist.copy_(torch.where(slots == st.it[:, None], f[:, None], st.hist))
        return
    conv = (err < st.min_error) | (torch.abs(st.prev_err - err) < st.tolerance)
    delta = solve_point_to_plane(cur, matched, nrm, mask, st.damping)
    a = (st.it < st.max_it) & ~st.converged
    T_new = torch.where(conv[:, None, None], st.T, lane_compose(delta, st.T))
    hist = torch.where(a[:, None] & (slots == st.it[:, None]), err[:, None],
                       st.hist)
    st.T.copy_(torch.where(a[:, None, None], T_new, st.T))
    st.prev_err.copy_(torch.where(a, err, st.prev_err))
    st.converged.copy_(torch.where(a, conv, st.converged))
    st.it.add_(a.to(torch.int32))
    st.hist.copy_(torch.where((a & conv)[:, None] & (slots == st.it[:, None]),
                              err[:, None], hist))
    st.flags.copy_(torch.stack([
        ((st.it < st.max_it) & ~st.converged).any(),
        (~(st.converged & (st.it > 0))).any()]).to(torch.int32))


def _launch_for(t: torch.Tensor):
    """The ``icp_step`` launch for ``t``'s device: the kernel for CUDA
    tensors, its plain version for CPU tensors."""
    return icp_cuda.launch if cuda_lib.use_kernel(t) else icp_step_torch


def _coarse_passes(st, src: PointCloud, match, iterations: int, launch):
    cur = torch.empty(src.points.shape, dtype=src.points.dtype,
                      device=src.points.device)
    for _ in range(iterations):
        launch("apply", st, cur, src=src.points)
        launch("coarse", st, cur, mask=src.mask, match=match(cur))
    return cur


def coarse_icp(T: torch.Tensor, src: PointCloud, match, iterations: int,
               damping: float, launch=None):
    """``iterations`` coarse Gauss-Newton passes from ``T`` (B, 4, 4) for
    the B-lane source ``src``, every lane composing (no convergence test),
    then each lane's plane RMS error at the result: ``(T, err)``. ``match``
    as :func:`_matcher` makes it. A pass is two ``icp_step`` launches
    (``apply``, ``coarse``) around the search and the error two more
    (``apply``, ``final``); ``launch`` (a test seam) replaces the one the
    tensors' device picks."""
    launch = launch or _launch_for(src.points)
    st = icp_cuda.new_state(T.clone(memory_format=torch.contiguous_format),
                            damping)
    cur = _coarse_passes(st, src, match, iterations, launch)
    launch("apply", st, cur, src=src.points)
    launch("final", st, cur, mask=src.mask, match=match(cur))
    return st.T, st.err


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
    with tracing.span("icp", kernels=knn_cuda.KERNELS + icp_cuda.KERNELS):
        return _icp(src, tgt, tgt_normals, config, init_transform, nn1_fn,
                    inactive)


def _icp(src, tgt, tgt_normals, config, init_transform, nn1_fn, inactive,
         launch=None):
    """:func:`icp_point_to_plane`; ``launch`` (a test seam) replaces the
    ``icp_step`` launch that the tensors' device picks."""
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

    match = _matcher(nn1_fn, tgt.points, tgt.mask, tgt_normals)

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

    csrc = None
    if config.coarse_iterations > 0 and config.coarse_sample < src.points.shape[-2]:
        csrc = full_src.subsample(config.coarse_sample)
    if inactive is None:
        converged = torch.zeros((B,), dtype=torch.bool, device=device)
    else:
        converged = torch.as_tensor(inactive, device=device).reshape(B).clone()
    res = _icp_loop(src, csrc, match, T, converged, config,
                    launch or _launch_for(tgt.points))
    if not batched:
        res = ICPResult(res.transformation[0], res.converged[0],
                        res.num_iterations[0], res.error_history[0],
                        res.final_error[0])
    return res


def _icp_loop(src, csrc, match, T, converged, config, launch):
    """The ICP loop with the arithmetic of each iteration in one
    ``icp_step`` launch (``launch``): an iteration is the ``apply`` launch,
    the search and the ``step`` launch, then one read of the flag that the
    step wrote. A converged exit's final error is its last iteration's; the
    final pass runs for the lanes that need it."""
    max_it = config.max_iterations
    st = icp_cuda.new_state(T, config.solver_damping, converged, max_it,
                            config.min_error, config.tolerance)
    if csrc is not None:
        with tracing.span("coarse"):
            _coarse_passes(st, csrc, match, config.coarse_iterations, launch)

    cur = torch.empty(src.points.shape, dtype=src.points.dtype,
                      device=src.points.device)
    active = ~st.converged if max_it > 0 else torch.zeros_like(st.converged)
    go = tracing.host_read("icp.active", active.any())
    ran = False
    while go:
        with tracing.span("iter"):
            launch("apply", st, cur, src=src.points)
            launch("step", st, cur, mask=src.mask, match=match(cur))
            ran = True
            go = tracing.host_read("icp.active", st.flags[0])

    with tracing.span("final"):
        need = st.flags[1] if ran else (~(st.converged & (st.it > 0))).any()
        if tracing.host_read("icp.need", need):
            launch("apply", st, cur, src=src.points)
            launch("final", st, cur, mask=src.mask, match=match(cur))
            final_err = st.err
        else:
            final_err = st.prev_err
    return ICPResult(st.T, st.converged, st.it, st.hist, final_err)


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
