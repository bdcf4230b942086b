"""The pose graph's matrix-free CG solver and its finalize ladder, port
against the JAX package, at small size on the CPU.

``PoseGraphConfig(solver="cg")`` and ``relative_param=False`` select the CG
step in both packages (``models/pose_graph.optimize``); finalize with such a
config is ``optimize_chunked``: float32 chunks, then the float64 Woodbury
backstop (the JAX package's NumPy-f64 ``optimize_host``). CG is iterative,
so float32 summation order moves its iterate: the port agrees with JAX to a
tolerance, not bit for bit, and each test states its own.
"""

import math
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidar_slam_tpu import config as jconfig
from lidar_slam_tpu.models import pose_graph as jpg
from lidar_slam_tpu.ops import se3 as jse3
from lidar_slam_tpu_torch import config
from lidar_slam_tpu_torch.models import pose_graph as pg
from lidar_slam_tpu_torch.ops import se3
from lidar_slam_tpu_torch.utils.metrics import ate_rmse

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_models import _graph  # noqa: E402

torch.set_num_threads(2)

CG = dict(solver="cg")
ABS = dict(relative_param=False)

# -- se3 tangents -------------------------------------------------------------

# rotation angles at and around every switch point of exp / log / log_so3:
# theta^2 against 1e-12 (the series of A, B; sin^2 in log_so3) and 0.01 (C,
# the log's V^-1 coefficient), a generic angle, and the near-pi branch
ANGLES = {
    "zero": 0.0,
    "below_1e-12": math.sqrt(0.5e-12),
    "above_1e-12": math.sqrt(2e-12),
    "below_0.01": math.sqrt(0.0099),
    "above_0.01": math.sqrt(0.0101),
    "generic": 1.0,
    "near_pi": math.pi - 5e-5,
}


@pytest.mark.parametrize("angle", list(ANGLES))
def test_se3_tangents_match_jax(angle):
    """``torch.func.jvp``/``vjp`` of the port's ``exp``, ``log_so3`` and
    ``log`` against ``jax.jvp``/``jax.vjp`` of the JAX ones at the same
    float32 point, tangent and cotangent: finite, and equal to 5e-6 (about
    40 float32 ulps of the O(1) derivatives; measured up to 1.1e-6)."""
    rng = np.random.default_rng(list(ANGLES).index(angle))
    axis = rng.normal(size=3)
    axis /= np.linalg.norm(axis)
    xi = np.concatenate([axis * ANGLES[angle], rng.normal(size=3)])
    xi = xi.astype(np.float32)[None]
    T = np.array(jse3.exp(jnp.asarray(xi)))
    tT = rng.normal(size=(1, 4, 4)).astype(np.float32)
    tT[:, 3] = 0.0
    cases = [
        (jse3.exp, se3.exp, xi, rng.normal(size=(1, 6)),
         rng.normal(size=(1, 4, 4))),
        (jse3.log_so3, se3.log_so3, T[:, :3, :3], rng.normal(size=(1, 3, 3)),
         rng.normal(size=(1, 3))),
        (jse3.log, se3.log, T, tT, rng.normal(size=(1, 6))),
    ]
    for jf, tf, x, tan, cot in cases:
        x = np.ascontiguousarray(x, np.float32)
        tan, cot = tan.astype(np.float32), cot.astype(np.float32)
        _, jj = jax.jvp(jf, (jnp.asarray(x),), (jnp.asarray(tan),))
        _, jvjp = jax.vjp(jf, jnp.asarray(x))
        (jv,) = jvjp(jnp.asarray(cot))
        _, tj = torch.func.jvp(tf, (torch.from_numpy(x),),
                               (torch.from_numpy(tan),))
        _, tvjp = torch.func.vjp(tf, torch.from_numpy(x))
        (tv,) = tvjp(torch.from_numpy(cot))
        for got, want in ((tj, jj), (tv, jv)):
            assert np.isfinite(got.numpy()).all(), tf.__name__
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                       atol=5e-6, err_msg=tf.__name__)


# -- the CG solve and the normal equations ------------------------------------


def _spd(n, seed):
    """A float32 SPD matrix with 6 distinct eigenvalues from 1 to 100: CG's
    |r|^2 / |b|^2 falls to 4e-5, 3e-9 and 4e-12 at iterations 6, 7 and 8,
    so a relative tolerance of 1e-6 or 1e-10 stops it at a decisive
    iteration, not one rounding away."""
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.normal(size=(n, n)))
    lam = np.repeat(np.logspace(0, 2, 6), -(-n // 6))[:n]
    return ((q * lam) @ q.T).astype(np.float32), rng.normal(size=n).astype(np.float32)


def _jax_cg(A, b, iters, tol):
    """The JAX package's ``_cg_solve``, with its matvecs counted."""
    calls = []

    def matvec(x):
        jax.debug.callback(lambda: calls.append(1))
        return jnp.asarray(A) @ x

    x = jpg._cg_solve(matvec, jnp.asarray(b), iters, tol)
    return np.asarray(x), len(calls)


@pytest.mark.parametrize("iters,tol,want", [(200, 1e-6, 7), (200, 1e-10, 8),
                                            (3, 1e-10, 3)])
def test_cg_solve_matches_jax(iters, tol, want):
    """On a fixed float32 SPD system (n = 60): the same number of
    iterations, to the tolerance or to the budget, and x equal to 1e-5
    relative to |x| (float32 dot products summed in another order)."""
    A, b = _spd(60, 0)
    xj, nj = _jax_cg(A, b, iters, tol)
    calls = []

    def matvec(x):
        calls.append(1)
        return torch.from_numpy(A) @ x

    xt = pg._cg_solve(matvec, torch.from_numpy(b), iters, tol).numpy()
    assert len(calls) == nj == want
    np.testing.assert_allclose(xt, xj, rtol=0, atol=1e-5 * np.abs(xj).max())
    if iters > want:
        x64 = np.linalg.solve(A.astype(np.float64), b.astype(np.float64))
        np.testing.assert_allclose(xt, x64, rtol=0, atol=1e-3)


def _jax_normal_equations(jst, jcfg, lam):
    """JAX ``optimize``'s CG linearization (pose_graph.py, the non-Woodbury
    branch), jitted: ``r0, J x`` by ``jax.linearize``, ``J^T y`` by
    ``jax.vjp``; returns ``(g, J^T J x + lam x)`` at ``x``."""
    zero = jnp.zeros((jst.poses.shape[0], 6), jnp.float32)

    def rfun(d):
        if jcfg.relative_param:
            return jpg._residuals_rel(jst, d, jcfg)
        return jpg._residuals(jst, d, jcfg)

    @jax.jit
    def run(x):
        r0, jvp_lin = jax.linearize(rfun, zero)
        _, vjp = jax.vjp(rfun, zero)
        return vjp(r0)[0], vjp(jvp_lin(x))[0] + lam * x

    return run


@pytest.mark.parametrize("kw", [CG, ABS], ids=["relative", "absolute"])
def test_normal_equations_match_jax(kw):
    """g = J^T r0 and x -> J^T J x + lam x for ``_residuals_rel`` and for
    ``_residuals`` on a 60-pose, 3-loop graph: to 1e-4 of the largest entry
    (whitened lever arms make entries span ~1e6; float32 throughout)."""
    gt, jst, st = _graph(60, 3, seed=1)
    lam = 1e-3
    x = np.random.default_rng(3).normal(size=(68, 6)).astype(np.float32)
    gj, want = map(np.asarray, _jax_normal_equations(
        jst, jconfig.PoseGraphConfig(**kw), lam)(jnp.asarray(x)))
    g, matvec = pg._normal_equations(st, config.PoseGraphConfig(**kw), lam)
    np.testing.assert_allclose(g.numpy(), gj, rtol=0,
                               atol=1e-4 * np.abs(gj).max())
    got = matvec(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())


# -- optimize ------------------------------------------------------------------


@pytest.fixture(scope="module")
def graph60():
    """60 poses, 3 loops, seed 3: the JAX CG LM converges in 3 iterations
    from these poses and from the poses moved by one and two ulps alike, so
    ``converged`` and ``iterations`` are decisive here (on seed 1 they are
    not: 19 iterations unconverged, and 4 converged one ulp away)."""
    return _graph(60, 3, seed=3)


@pytest.mark.parametrize("kw,atol,err_rtol", [(CG, 2e-4, 2e-5),
                                              (ABS, 2e-3, 1e-2)],
                         ids=["cg", "absolute"])
def test_bounded_optimize_follows_solver(graph60, kw, atol, err_rtol):
    """Two LM iterations (``max_iterations=2``, as optimize-on-find bounds
    them) with the CG solver, relative and absolute, against JAX: the same
    iterations and ``converged``, poses to ``atol`` m and the error to
    ``err_rtol``. The tolerances are the JAX solver's own spread: moving the
    input poses by one float32 ulp moves its result by 1.2e-4 m (relative;
    the port is 7e-5 m from it) and 7.3e-4 m (absolute, where every CG
    solve stops at its 120-iteration budget; the port is 3.5e-4 m away).
    The Woodbury step lands 4.6e-4 m (error 4.6e-5 relative) and 0.26 m
    from these results."""
    n = 60
    gt, jst, st = graph60
    res_j = jpg.optimize(jst, jconfig.PoseGraphConfig(**kw), max_iterations=2)
    res_t = pg.optimize(st, config.PoseGraphConfig(**kw), max_iterations=2)
    assert res_t.iterations == int(res_j.iterations) == 2
    assert res_t.converged == bool(res_j.converged) is False
    np.testing.assert_allclose(res_t.poses[:n].numpy(),
                               np.asarray(res_j.poses)[:n], rtol=0, atol=atol)
    assert res_t.final_error == pytest.approx(float(res_j.final_error),
                                              rel=err_rtol)
    assert res_t.cg_matvecs > 0


def test_unbounded_cg_optimize_matches_jax(graph60):
    """The CG LM to convergence: 3 iterations and converged in both, poses
    to 1e-4 m (the JAX result moves 3e-5 m under a one-ulp change of its
    input) and the error to 1e-5."""
    n = 60
    gt, jst, st = graph60
    res_j = jpg.optimize(jst, jconfig.PoseGraphConfig(**CG))
    res_t = pg.optimize(st, config.PoseGraphConfig(**CG))
    assert res_t.converged and bool(res_j.converged)
    assert res_t.iterations == int(res_j.iterations) == 3
    np.testing.assert_allclose(res_t.poses[:n].numpy(),
                               np.asarray(res_j.poses)[:n], rtol=0, atol=1e-4)
    assert res_t.final_error == pytest.approx(float(res_j.final_error), rel=1e-5)
    raw = st.poses[:n].numpy()
    assert ate_rmse(res_t.poses[:n].numpy(), gt) < ate_rmse(raw, gt)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_woodbury_matches_cg_optimum(dtype):
    """The port's own counterpart of the JAX package's test of that name,
    with its criteria: Woodbury's error at most 1.05 x CG's, and its ATE at
    most 1.2 x CG's + 0.05 m. A 128-pose graph (the JAX test's 256 poses
    take the float32 CG LM 24 unconverged iterations, ~50 s on the CPU)."""
    from tools.profile_pose_graph import build_graph

    n = cap = 128
    gt, rels, loops = build_graph(n, 6, seed=5)
    st = pg.init_state(cap, len(loops))
    for k in range(1, n):
        pg.add_odometry(st, k, torch.from_numpy(rels[k].astype(np.float32)),
                        torch.tensor(0.0))
    for i, j, rel in loops:
        pg.add_loop(st, i, j, torch.from_numpy(rel.astype(np.float32)))
    st = st.to(dtype)
    res_w = pg.optimize(st, config.PoseGraphConfig(solver="woodbury"))
    res_c = pg.optimize(st, config.PoseGraphConfig(solver="cg"))
    assert res_w.cg_matvecs == 0 < res_c.cg_matvecs
    gt32 = gt.astype(np.float32)
    ate_w = ate_rmse(res_w.poses[:n].numpy().astype(np.float32), gt32)
    ate_c = ate_rmse(res_c.poses[:n].numpy().astype(np.float32), gt32)
    assert res_w.final_error <= res_c.final_error * 1.05, (
        res_w.final_error, res_c.final_error)
    assert ate_w <= ate_c * 1.2 + 0.05, (ate_w, ate_c)


def test_optimize_chunked_absolute_matches_jax():
    """``optimize_chunked`` with ``relative_param=False`` on 300 poses
    (solver ``"cg"``: JAX then goes from its float32 chunks straight to the
    NumPy-f64 ``optimize_host``, the stage the port's float64 Woodbury LM
    stands for; its default solver would run the emulated-f64 tier first).
    Both start from the poses of one float64 Woodbury iteration: the
    absolute-parameterisation CG chunks lower the cost by less than 1% by
    the third chunk, and the backstop finishes. Both end converged after
    the same iterations in each stage, and the poses agree as
    ``test_f64_optimize_matches_host_f64`` holds them: 1e-6 m plus one
    float32 ulp of the coordinate."""
    n = 300
    gt, jst, st = _graph(n, 6, seed=5)
    start = jpg.optimize_host(jst, jconfig.PoseGraphConfig(), max_iterations=1)
    jst = jst._replace(poses=start.poses)
    st = st.replace(poses=torch.from_numpy(np.array(start.poses)))
    kw = dict(relative_param=False, solver="cg")
    tj, tt = {}, {}
    res_j = jpg.optimize_chunked(jst, jconfig.PoseGraphConfig(**kw), chunk=3,
                                 timing=tj)
    res_t = pg.optimize_chunked(st, config.PoseGraphConfig(**kw), chunk=3,
                                timing=tt)
    assert res_t.converged and bool(res_j.converged)
    assert "dd_it" not in tj
    assert tt["f32_it"] == tj["f32_it"] == 9
    assert tt["f64_it"] == tj["host_it"] > 0
    assert res_t.iterations == int(res_j.iterations) == 9 + tt["f64_it"]
    assert res_t.cg_matvecs > 0 and res_t.poses.dtype == torch.float32
    p_t, p_j = res_t.poses[:n, :3, 3].numpy(), np.asarray(res_j.poses)[:n, :3, 3]
    dt = np.abs(p_t - p_j)
    assert np.all(dt <= 1e-6 + np.spacing(np.abs(p_j))), dt.max()
    assert res_t.final_error == pytest.approx(float(res_j.final_error), rel=1e-6)
    assert res_t.final_error < float(start.final_error)
