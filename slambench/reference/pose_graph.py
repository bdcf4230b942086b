"""The pose graph, written plainly, and its optimum by Levenberg-Marquardt.

Factors (the configuration's ``PoseGraphConfig``): a prior on pose 0 at
the identity; odometry between poses k - 1 and k with the measured delta,
sigmas scaled by the factor's scale (1 + 10 x ICP fitness), where valid;
loops between match and query with their measured transform. A residual is
log(Z^-1 Pi^-1 Pj) (rotation first) divided by its sigmas; the cost is half
the sum of squares. The reference minimises it over right perturbations
P_k Exp(d_k), with each factor's 6 x 12 Jacobian by autodiff and the dense
normal equations, to a relative decrease of 1e-12 (float64; the control's
float32). A finalized trajectory is judged by how far this descent can
still lower the cost from it: at the optimum finalize is asked for, not
at all; a graph with many loops has several minima, so the descent starts
from the trajectory judged."""

from __future__ import annotations

import math

import torch

from . import se3
from .prec import FP32, Precision


def _sig(rot, trans, dtype, device):
    return torch.tensor([rot] * 3 + [trans] * 3, dtype=dtype, device=device)


def _between(Ti, Tj, Zinv, di, dj):
    Pi = Ti @ se3.exp(di)
    Pj = Tj @ se3.exp(dj)
    return se3.log(Zinv @ se3.inverse(Pi) @ Pj)


def _prior(T0, d0):
    return se3.log(T0 @ se3.exp(d0))


class Graph:
    def __init__(self, odom_rel, odom_valid, odom_scale, loop_from, loop_to,
                 loop_rel, cfg, p: Precision = FP32):
        dt = p.wide
        self.n = odom_rel.shape[0]
        dev = odom_rel.device
        self.odom_zinv = se3.inverse(odom_rel[1:].to(dt))
        w = odom_valid[1:].to(dt)[:, None] / (
            _sig(cfg.odom_rotation_sigma, cfg.odom_translation_sigma, dt, dev)[None, :]
            * torch.clamp(odom_scale[1:].to(dt), min=1e-12)[:, None])
        self.odom_w = w
        self.lf, self.lt = loop_from.to(torch.int64), loop_to.to(torch.int64)
        self.loop_zinv = se3.inverse(loop_rel.to(dt))
        self.loop_w = 1.0 / _sig(cfg.loop_rotation_sigma, cfg.loop_translation_sigma, dt, dev)
        self.prior_w = 1.0 / _sig(cfg.prior_rotation_sigma, cfg.prior_translation_sigma, dt, dev)
        self.dt = dt

    def residuals(self, P):
        n = self.n
        z = torch.zeros((n, 6), dtype=self.dt, device=P.device)
        r0 = _prior(P[0], z[0]) * self.prior_w
        ro = _between(P[:-1], P[1:], self.odom_zinv, z[1:], z[1:]) * self.odom_w
        rl = _between(P[self.lf], P[self.lt], self.loop_zinv, z[:len(self.lf)],
                      z[:len(self.lf)]) * self.loop_w
        return torch.cat([r0[None], ro, rl], 0)

    def cost(self, P) -> float:
        r = self.residuals(P)
        return float(0.5 * (r * r).sum())

    def normal_equations(self, P):
        n, dt, dev = self.n, self.dt, P.device
        z6 = torch.zeros(6, dtype=dt, device=dev)
        jb = torch.func.vmap(torch.func.jacrev(_between, argnums=(3, 4)))
        H = torch.zeros((6 * n, 6 * n), dtype=dt, device=dev)
        g = torch.zeros(6 * n, dtype=dt, device=dev)

        def add(i, j, Ji, Jj, r):
            # rows of a block of factors between poses i and j (index tensors)
            for a, Ja in ((i, Ji), (j, Jj)):
                ga = torch.einsum("kri,kr->ki", Ja, r)
                g.index_put_((6 * a[:, None] + torch.arange(6, device=dev),), ga,
                             accumulate=True)
                for b, Jb in ((i, Ji), (j, Jj)):
                    blk = torch.einsum("kri,krj->kij", Ja, Jb)
                    rows = (6 * a[:, None, None] + torch.arange(6, device=dev)[None, :, None])
                    cols = (6 * b[:, None, None] + torch.arange(6, device=dev)[None, None, :])
                    H.index_put_((rows.expand_as(blk), cols.expand_as(blk)), blk,
                                 accumulate=True)

        J0 = torch.func.jacrev(_prior, argnums=1)(P[0], z6) * self.prior_w[:, None]
        r0 = _prior(P[0], z6) * self.prior_w
        H[:6, :6] += J0.T @ J0
        g[:6] += J0.T @ r0
        zk = torch.zeros((n - 1, 6), dtype=dt, device=dev)
        Ji, Jj = jb(P[:-1], P[1:], self.odom_zinv, zk, zk)
        ro = _between(P[:-1], P[1:], self.odom_zinv, zk, zk) * self.odom_w
        w = self.odom_w[..., None]
        k = torch.arange(1, n, device=dev)
        add(k - 1, k, Ji * w, Jj * w, ro)
        if len(self.lf):
            zl = torch.zeros((len(self.lf), 6), dtype=dt, device=dev)
            Pi, Pj = P[self.lf], P[self.lt]
            Ji, Jj = jb(Pi, Pj, self.loop_zinv, zl, zl)
            rl = _between(Pi, Pj, self.loop_zinv, zl, zl) * self.loop_w
            w = self.loop_w[None, :, None]
            add(self.lf, self.lt, Ji * w, Jj * w, rl)
        return H, g


def optimum(graph: Graph, P0: torch.Tensor, max_iterations: int = 60,
            rel_tol: float = 1e-12) -> torch.Tensor:
    """Poses (n, 4, 4) at the cost's minimum reached from ``P0`` (a step is
    taken while it lowers the cost; a failed solve raises the damping)."""
    P = P0.to(graph.dt)
    cost = graph.cost(P)
    lam = 1e-5
    eye = torch.eye(6 * graph.n, dtype=graph.dt, device=P.device)
    for _ in range(max_iterations):
        H, g = graph.normal_equations(P)
        while lam < 1e10:
            d, info = torch.linalg.solve_ex(H + lam * eye, -g)
            c = math.inf
            if int(info) == 0:
                Pn = se3.orthonormalize(P @ se3.exp(d.reshape(-1, 6)))
                c = graph.cost(Pn)
            if c < cost:
                break
            lam *= 10.0
        else:
            return P
        dec = cost - c
        P, cost, lam = Pn, c, lam / 10.0
        if dec < rel_tol * cost:
            break
    return P
