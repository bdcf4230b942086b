"""SE(3) pose-graph Levenberg-Marquardt (port of
``lidar_slam_tpu/models/pose_graph.py``).

Same factor graph (reference pose_graph.cpp:6-171): a prior on pose 0,
odometry BetweenFactors with sigmas scaled by 1 + 10 * fitness, loop
BetweenFactors; GTSAM's LM schedule and error convention. The damped
Gauss-Newton step is, as in the JAX package, one of two inner solvers:

- ``relative_param=True, solver="woodbury"`` (the default): the exact
  Woodbury solve in the relative parameterisation (diagonal + rank-6L normal
  matrix: one prefix sum over frames and one 6L x 6L Cholesky);
- any other configuration: matrix-free conjugate gradient on
  (J^T J + lam I) d = -J^T r, with J^T y and J x by ``torch.func`` autodiff
  of the residual function (:func:`_normal_equations`), in the relative or
  the absolute (right-retraction) parameterisation.

:func:`optimize` is dtype-generic. Finalize runs the default config's LM in
float64 on the device; other configs run :func:`optimize_chunked`, float32
chunks of the configured solver with a float64 Woodbury backstop. Native
float64 on the card replaces the JAX package's emulated-f64 and NumPy-f64
tiers. Pose chains are rebuilt by a log-depth doubling prefix product of
batched 4x4 matmuls (the JAX ``lax.associative_scan``).

Factors are written IN PLACE; ``n_poses``, ``n_loops`` and
``n_loops_dropped`` are host integers.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from ..config import PoseGraphConfig
from ..ops import se3
from ..utils import tracing


@dataclass
class PoseGraphState:
    """Fixed-capacity factor-graph storage. Odometry factor k (k >= 1)
    connects poses (k-1, k)."""

    poses: torch.Tensor       # (F, 4, 4) raw-chained estimates
    n_poses: int
    odom_rel: torch.Tensor    # (F, 4, 4) measured k-1 -> k
    odom_valid: torch.Tensor  # (F,) bool
    odom_scale: torch.Tensor  # (F,) 1 + 10 * fitness
    loop_from: torch.Tensor   # (L,) int64
    loop_to: torch.Tensor     # (L,) int64
    loop_rel: torch.Tensor    # (L, 4, 4)
    loop_valid: torch.Tensor  # (L,) bool
    n_loops: int = 0
    n_loops_dropped: int = 0

    def replace(self, **kw) -> "PoseGraphState":
        return dataclasses.replace(self, **kw)

    def to(self, dtype: torch.dtype) -> "PoseGraphState":
        """Copy with the float tensors in ``dtype``."""
        return self.replace(
            poses=self.poses.to(dtype), odom_rel=self.odom_rel.to(dtype),
            odom_scale=self.odom_scale.to(dtype),
            loop_rel=self.loop_rel.to(dtype),
        )


def _eyes(n: int, device) -> torch.Tensor:
    return torch.eye(4, dtype=torch.float32, device=device).repeat(n, 1, 1)


def init_state(max_frames: int, max_loops: int, device=None) -> PoseGraphState:
    return PoseGraphState(
        poses=_eyes(max_frames, device),
        n_poses=1,  # pose 0 = identity + prior (slam_node.cpp:64-66)
        odom_rel=_eyes(max_frames, device),
        odom_valid=torch.zeros((max_frames,), dtype=torch.bool, device=device),
        odom_scale=torch.ones((max_frames,), dtype=torch.float32, device=device),
        loop_from=torch.zeros((max_loops,), dtype=torch.int64, device=device),
        loop_to=torch.zeros((max_loops,), dtype=torch.int64, device=device),
        loop_rel=_eyes(max_loops, device),
        loop_valid=torch.zeros((max_loops,), dtype=torch.bool, device=device),
    )


def add_odometry(state: PoseGraphState, to_idx: int, rel: torch.Tensor,
                 fitness: torch.Tensor, valid: bool = True) -> PoseGraphState:
    """Odometry factor (to_idx-1 -> to_idx), in place; the raw estimate is
    chained from the previous one (pose_graph.cpp:81-116)."""
    state.poses[to_idx] = se3.compose(state.poses[to_idx - 1], rel)
    state.n_poses = max(state.n_poses, to_idx + 1)
    state.odom_rel[to_idx] = rel
    state.odom_valid[to_idx] = bool(valid)
    state.odom_scale[to_idx] = 1.0 + fitness * 10.0
    return state


def add_loop(state: PoseGraphState, from_idx: int, to_idx: int,
             rel: torch.Tensor, valid: bool = True) -> PoseGraphState:
    """Loop BetweenFactor (pose_graph.cpp:118-141), in place. Accepted loops
    beyond capacity are dropped and counted."""
    if not valid:
        return state
    i = state.n_loops
    if i >= state.loop_valid.shape[0]:
        state.n_loops_dropped += 1
        return state
    state.loop_from[i] = int(from_idx)
    state.loop_to[i] = int(to_idx)
    state.loop_rel[i] = rel
    state.loop_valid[i] = True
    state.n_loops = i + 1
    return state


def compact_loops(state: PoseGraphState) -> PoseGraphState:
    """Copy restricted to the valid loop factors, padded to a power of two
    (the Woodbury solve costs O((6L)^3) in the loop axis)."""
    sel = torch.nonzero(state.loop_valid).flatten()
    n = int(sel.numel())
    Lc = max(1, 1 << (max(n, 1) - 1).bit_length())
    if Lc >= state.loop_valid.shape[0]:
        return state
    pad = Lc - n
    dev = state.loop_rel.device
    zeros = torch.zeros((pad,), dtype=torch.int64, device=dev)
    return state.replace(
        loop_from=torch.cat([state.loop_from[sel], zeros]),
        loop_to=torch.cat([state.loop_to[sel], zeros]),
        loop_rel=torch.cat([state.loop_rel[sel],
                            _eyes(pad, dev).to(state.loop_rel.dtype)]),
        loop_valid=torch.cat([torch.ones((n,), dtype=torch.bool, device=dev),
                              torch.zeros((pad,), dtype=torch.bool, device=dev)]),
        n_loops=min(state.n_loops, Lc),
    )


def window_loops(state: PoseGraphState, window: int) -> PoseGraphState:
    """View of ``state`` restricted to the NEWEST ``window`` loop factors.

    The Woodbury solve's Cholesky is (6 * loop capacity)^2 per LM iteration
    however many loops were accepted; the optimize-on-find chunk
    (slam_node.cpp:112-115 semantics) uses this view to pay (6 * window)^2,
    while finalize keeps optimizing over every factor. Slots are filled in
    acceptance order, so the slice at ``clamp(n_loops - window, 0, capacity -
    window)`` keeps the most recent loops, the ones correcting CURRENT
    drift. Exact while ``n_loops <= window``; the identity for ``window <= 0``
    or ``window >= capacity``.

    A read-only view for :func:`optimize`: do not ``add_loop`` into it."""
    cap = state.loop_valid.shape[0]
    if window <= 0 or window >= cap:
        return state
    start = min(max(state.n_loops - window, 0), cap - window)
    sl = slice(start, start + window)
    return state.replace(
        loop_from=state.loop_from[sl], loop_to=state.loop_to[sl],
        loop_rel=state.loop_rel[sl], loop_valid=state.loop_valid[sl],
        n_loops=min(state.n_loops, window),
    )


def _between_residual(Ti, Tj, meas_inv):
    return se3.log(se3.compose(meas_inv, se3.compose(se3.inverse(Ti), Tj)))


def _whiten(cfg: PoseGraphConfig, dtype, device):
    """(prior, odom, loop) sigma 6-vectors: the f32 config values, cast."""
    def sig(rot_s, trans_s):
        return torch.tensor([rot_s] * 3 + [trans_s] * 3,
                            dtype=torch.float32).to(device=device, dtype=dtype)

    return (
        sig(cfg.prior_rotation_sigma, cfg.prior_translation_sigma),
        sig(cfg.odom_rotation_sigma, cfg.odom_translation_sigma),
        sig(cfg.loop_rotation_sigma, cfg.loop_translation_sigma),
    )


def _odom_weights(state: PoseGraphState, odom_sig):
    F = state.poses.shape[0]
    k = torch.arange(1, F, device=state.poses.device)
    odom_w = (state.odom_valid[1:] & (k < state.n_poses)).to(state.poses.dtype)
    scale = torch.clamp(state.odom_scale[1:], min=1e-12)
    return odom_w[:, None] / (odom_sig[None, :] * scale[:, None])


def _residuals(state: PoseGraphState, deltas: torch.Tensor,
               cfg: PoseGraphConfig) -> torch.Tensor:
    """All whitened residuals (1 + (F-1) + L, 6) at right-retracted poses;
    zero rows for invalid factors."""
    poses = se3.compose(state.poses, se3.exp(deltas))
    prior_sig, odom_sig, loop_sig = _whiten(cfg, poses.dtype, poses.device)
    r_prior = (se3.log(poses[0]) / prior_sig)[None, :]
    r_odom = _between_residual(poses[:-1], poses[1:],
                               se3.inverse(state.odom_rel[1:]))
    r_odom = r_odom * _odom_weights(state, odom_sig)
    r_loop = _between_residual(poses[state.loop_from], poses[state.loop_to],
                               se3.inverse(state.loop_rel))
    loop_w = state.loop_valid.to(poses.dtype)
    r_loop = r_loop * loop_w[:, None] / loop_sig[None, :]
    return torch.cat([r_prior, r_odom, r_loop], dim=0)


def _prefix_compose(M: torch.Tensor) -> torch.Tensor:
    """P_k = M_0 M_1 ... M_k by log-depth doubling (Hillis-Steele): each
    round composes every P_k with P_{k-off} in one batched matmul."""
    P = M
    off = 1
    while off < P.shape[0]:
        P = torch.cat([P[:off], se3.compose(P[:-off], P[off:])], dim=0)
        off *= 2
    return P


def _poses_from_rel_deltas(state: PoseGraphState, d: torch.Tensor) -> torch.Tensor:
    """Corrected poses in the relative parameterisation:
    P_0 = T_0 Exp(d_0); P_k = P_{k-1} (R_k Exp(d_k)), R_k = T_{k-1}^-1 T_k."""
    T = state.poses
    rels = se3.compose(se3.inverse(T[:-1]), T[1:])
    M0 = se3.compose(T[0], se3.exp(d[0]))[None]
    Mk = se3.compose(rels, se3.exp(d[1:]))
    return _prefix_compose(torch.cat([M0, Mk], dim=0))


def _residuals_rel(state: PoseGraphState, d: torch.Tensor,
                   cfg: PoseGraphConfig) -> torch.Tensor:
    """Whitened residuals under the relative parameterisation (equal to
    :func:`_residuals` at d = 0)."""
    T = state.poses
    prior_sig, odom_sig, loop_sig = _whiten(cfg, T.dtype, T.device)
    P = _poses_from_rel_deltas(state, d)
    r_prior = (se3.log(P[0]) / prior_sig)[None, :]
    rels = se3.compose(se3.inverse(T[:-1]), T[1:])
    rel_new = se3.compose(rels, se3.exp(d[1:]))
    r_odom = se3.log(se3.compose(se3.inverse(state.odom_rel[1:]), rel_new))
    r_odom = r_odom * _odom_weights(state, odom_sig)
    r_loop = _between_residual(P[state.loop_from], P[state.loop_to],
                               se3.inverse(state.loop_rel))
    loop_w = state.loop_valid.to(T.dtype)
    r_loop = r_loop * loop_w[:, None] / loop_sig[None, :]
    return torch.cat([r_prior, r_odom, r_loop], dim=0)


def _woodbury_solve(state: PoseGraphState, cfg: PoseGraphConfig, lam: float,
                    r0: torch.Tensor):
    """Exact damped Gauss-Newton step (J^T J + lam I) delta = -J^T r0 in the
    relative parameterisation, via Woodbury: J^T J + lam I = D + B B^T with
    diagonal D and B of rank 6L. Returns ``(delta (F, 6), ok)``; ``ok`` is
    False when the capacitance matrix is not positive definite (the JAX
    Cholesky then yields NaNs and LM rejects the step)."""
    F = state.poses.shape[0]
    L = state.loop_from.shape[0]
    T = state.poses
    prior_sig, odom_sig, loop_sig = _whiten(cfg, T.dtype, T.device)

    w_odom = _odom_weights(state, odom_sig)                      # (F-1, 6)
    w_prior = 1.0 / prior_sig                                    # (6,)
    w_loop = state.loop_valid.to(T.dtype)[:, None] / loop_sig[None, :]

    D = torch.cat([(w_prior ** 2)[None, :], w_odom ** 2], dim=0) + lam
    Dinv = 1.0 / D

    G = se3.adjoint(T)                                           # (F, 6, 6)
    H = se3.adjoint(se3.inverse(T[state.loop_to]))               # (L, 6, 6)
    lo = torch.minimum(state.loop_from, state.loop_to)
    hi = torch.maximum(state.loop_from, state.loop_to)
    one = torch.ones((), dtype=T.dtype, device=T.device)
    sgn = torch.where(state.loop_to >= state.loop_from, one, -one)
    X = sgn[:, None, None] * w_loop[:, :, None] * H              # (L, 6, 6)

    r_prior, r_odom, r_loop = r0[0], r0[1:F], r0[F:]

    def BT(z):
        V = torch.cumsum(torch.einsum("fij,fj->fi", G, z), dim=0)
        return torch.einsum("lij,lj->li", X, V[hi] - V[lo])

    def B(y):
        c = torch.einsum("lji,lj->li", X, y)
        diff = torch.zeros((F + 1, 6), dtype=r0.dtype, device=r0.device)
        # accumulating index_put_, not index_add_: on the GPU it sums equal
        # indices (loops that share a frame) in a fixed order, so two runs
        # give the same bits; index_add_'s atomic adds do not
        diff.index_put_((lo + 1,), c, accumulate=True)
        diff.index_put_((hi + 1,), -c, accumulate=True)
        A = torch.cumsum(diff[:F], dim=0)
        return torch.einsum("fji,fj->fi", G, A)

    g = torch.cat([(w_prior * r_prior)[None, :], w_odom * r_odom], dim=0)
    g = g + B(r_loop)

    GDG = torch.einsum("fij,fj,fkj->fik", G, Dinv, G)
    S = torch.cumsum(GDG, dim=0)
    a = torch.maximum(lo[:, None], lo[None, :])
    b = torch.minimum(hi[:, None], hi[None, :])
    Mab = torch.where((b > a)[..., None, None], S[b] - S[a],
                      torch.zeros((), dtype=T.dtype, device=T.device))
    Kb = torch.einsum("lab,lmbc,mdc->lamd", X, Mab, X)
    K = Kb.reshape(L * 6, L * 6) + torch.eye(L * 6, dtype=T.dtype,
                                             device=T.device)

    y1 = Dinv * (-g)
    bt = BT(y1).reshape(L * 6, 1)
    Lc, info = torch.linalg.cholesky_ex(K)
    alpha = torch.cholesky_solve(bt, Lc).reshape(L, 6)
    return y1 - Dinv * B(alpha), tracing.host_read("pg.cholesky", info, int) == 0


def _cg_solve(matvec, b: torch.Tensor, iters: int, tol: float) -> torch.Tensor:
    """Conjugate gradient on the damped normal equations (matrix-free), the
    JAX package's ``_cg_solve`` step for step: x0 = 0, stop at the first
    iteration whose squared residual is at most ``tol`` times |b|^2 (floored
    at 1e-30), or after ``iters`` iterations. The stop test reads the
    residual on the host once per iteration."""
    x = torch.zeros_like(b)
    r = b
    p = r
    rs = torch.sum(r * r)
    tol = tol * torch.clamp(rs, min=1e-30)
    i = 0
    while i < iters and tracing.host_read("pg.cg", rs > tol):
        Ap = matvec(p)
        alpha = rs / torch.clamp(torch.sum(p * Ap), min=1e-30)
        x = x + alpha * p
        r = r - alpha * Ap
        rs_new = torch.sum(r * r)
        p = r + (rs_new / torch.clamp(rs, min=1e-30)) * p
        rs = rs_new
        i += 1
    return x


def _retract(state: PoseGraphState, d: torch.Tensor,
             cfg: PoseGraphConfig) -> torch.Tensor:
    """Poses after the step ``d``: through the relative chain, or by right
    retraction T_k Exp(d_k) in the absolute parameterisation."""
    if cfg.relative_param:
        return _poses_from_rel_deltas(state, d)
    return se3.compose(state.poses, se3.exp(d))


def _normal_equations(state: PoseGraphState, cfg: PoseGraphConfig, lam: float):
    """``(g, matvec)`` of the damped normal equations linearized at d = 0:
    g = J^T r0 and matvec(x) = J^T J x + lam x, by autodiff (J is never
    formed). ``torch.func.vjp`` of the residuals gives J^T y, and J x is
    the vjp of that linear map (its transpose). ``torch.func.linearize``
    would give J x too, but its ``make_fx`` trace costs seconds per LM
    iteration, and ``torch.func.jvp`` stops on the 0-dim coefficients of
    the unbatched ``se3.exp``."""
    rel = cfg.relative_param

    def rfun(d):
        return _residuals_rel(state, d, cfg) if rel else _residuals(state, d, cfg)

    zero = torch.zeros((state.poses.shape[0], 6), dtype=state.poses.dtype,
                       device=state.poses.device)
    r0, vjp = torch.func.vjp(rfun, zero)
    g, jvp = torch.func.vjp(lambda y: vjp(y)[0], r0)

    def matvec(x):
        (jt,) = vjp(jvp(x)[0])
        return jt + lam * x

    return g, matvec


def _cg_step(state: PoseGraphState, cfg: PoseGraphConfig, lam: float):
    """The damped Gauss-Newton step by CG: ``(delta (F, 6), matvecs)``."""
    g, matvec = _normal_equations(state, cfg, lam)
    calls = 0

    def counted(x):
        nonlocal calls
        calls += 1
        return matvec(x)

    delta = _cg_solve(counted, -g, cfg.cg_iterations, cfg.cg_tolerance)
    return delta, calls


@dataclass
class OptimizeResult:
    poses: torch.Tensor
    final_error: float
    iterations: int
    converged: bool
    cg_matvecs: int = 0    # J^T J products the CG steps made (0: Woodbury)


def graph_error(state: PoseGraphState, cfg: PoseGraphConfig) -> float:
    """GTSAM-convention error: 0.5 * sum of squared whitened residuals."""
    zero = torch.zeros((state.poses.shape[0], 6), dtype=state.poses.dtype,
                       device=state.poses.device)
    r = _residuals(state, zero, cfg)
    return tracing.host_read("pg.cost", 0.5 * torch.sum(r * r), float)


def optimize(state: PoseGraphState, cfg: PoseGraphConfig = PoseGraphConfig(),
             max_iterations: int | None = None) -> OptimizeResult:
    """Levenberg-Marquardt over the whole graph in ``state.poses``' dtype:
    damped Gauss-Newton step (Woodbury for ``relative_param`` with
    ``solver="woodbury"``, CG otherwise), retract, Gram-Schmidt
    re-orthonormalisation, accept on the true cost with GTSAM's lambda
    schedule, stop on the relative/absolute error tolerance.

    ``max_iterations`` overrides ``cfg.max_iterations`` for this call; when
    the bound stops the LM before the tolerance test passed, the result
    reports ``converged=False`` (optimize-on-find keeps the graph pending
    then)."""
    max_it = cfg.max_iterations if max_iterations is None else max_iterations
    woodbury = cfg.relative_param and cfg.solver == "woodbury"
    poses = state.poses
    cost = graph_error(state, cfg)
    lam = cfg.lambda_init
    it = matvecs = 0
    done = False
    while it < max_it and not done and lam <= cfg.lambda_max:
        st = state.replace(poses=poses)
        if woodbury:
            zero = torch.zeros((poses.shape[0], 6), dtype=poses.dtype,
                               device=poses.device)
            r0 = _residuals_rel(st, zero, cfg)
            delta, ok = _woodbury_solve(st, cfg, lam, r0)
        else:
            # no solver-failure flag: a NaN cost fails the comparison below
            delta, calls = _cg_step(st, cfg, lam)
            matvecs += calls
            ok = True
        new_poses = se3.orthonormalize(_retract(st, delta, cfg))
        new_cost = graph_error(state.replace(poses=new_poses), cfg)
        if ok and new_cost < cost:
            decrease = cost - new_cost
            done = (decrease < cfg.absolute_error_tol
                    or decrease < cfg.relative_error_tol * cost)
            poses, cost = new_poses, new_cost
            lam = lam / cfg.lambda_factor
        else:
            lam = lam * cfg.lambda_factor
        it += 1
    return OptimizeResult(poses=poses, final_error=cost, iterations=it,
                          converged=done, cg_matvecs=matvecs)


def optimize_chunked(state: PoseGraphState,
                     cfg: PoseGraphConfig = PoseGraphConfig(), chunk: int = 10,
                     timing: dict | None = None) -> OptimizeResult:
    """LM to convergence as the JAX package's ``optimize_chunked`` drives it,
    without its emulated-f64 tier: float32 chunks of ``chunk`` iterations of
    the configured solver, each warm-started from the last chunk's poses at
    ``lambda_init``, stopped when a chunk converges, runs short, or lowers
    the cost by less than 1%; then, if still unconverged, the float64
    Woodbury LM from the chunks' poses (the JAX package's NumPy-f64
    ``optimize_host``), kept only if its error is lower. Iterations and CG
    matvecs are counted across both stages; the poses come back in float32.

    ``timing``: optional dict filled with each stage's wall seconds and
    iterations, ``f32_s``/``f32_it`` and ``f64_s``/``f64_it`` (every LM
    iteration reads its cost on the host, so a stage's work is done when its
    clock stops)."""
    with tracing.span("f32", timing, key="f32_s"):
        state = compact_loops(state).to(torch.float32)
        res = None
        total_it = matvecs = 0
        prev_err = float("inf")
        for _ in range(-(-cfg.max_iterations // chunk)):
            st = state if res is None else state.replace(poses=res.poses)
            res = optimize(st, cfg, max_iterations=chunk)
            total_it += res.iterations
            matvecs += res.cg_matvecs
            if res.converged or res.iterations < chunk:
                break
            if res.final_error > prev_err * 0.99:
                break  # a whole chunk moved the cost < 1%: float32 has stalled
            prev_err = res.final_error
    if timing is not None:
        timing["f32_it"] = total_it
    if not res.converged:
        with tracing.span("f64", timing, key="f64_s"):
            f64 = optimize(
                state.replace(poses=res.poses).to(torch.float64),
                dataclasses.replace(cfg, solver="woodbury", relative_param=True),
                max_iterations=cfg.max_iterations,
            )
            total_it += f64.iterations
            if f64.final_error < res.final_error:
                res = dataclasses.replace(f64, poses=f64.poses.to(torch.float32))
        if timing is not None:
            timing["f64_it"] = f64.iterations
    return dataclasses.replace(res, iterations=total_it, cg_matvecs=matvecs)
