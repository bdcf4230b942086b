"""Trajectory accuracy: ATE and RPE (jax-free copy of
``lidar_slam_tpu/utils/metrics.py``)."""

from __future__ import annotations

import numpy as np


def umeyama_alignment(src: np.ndarray, dst: np.ndarray):
    """Rigid (no-scale) alignment dst ~= R @ src + t of (n, 3) point sets."""
    mu_s, mu_d = src.mean(axis=0), dst.mean(axis=0)
    cov = (dst - mu_d).T @ (src - mu_s) / len(src)
    U, _, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    t = mu_d - R @ mu_s
    return R, t


def ate_rmse(est: np.ndarray, gt: np.ndarray, align: bool = True) -> float:
    """Absolute trajectory error RMSE (m) of (n, 4, 4) pose arrays."""
    p_est = est[:, :3, 3]
    p_gt = gt[:, :3, 3]
    n = min(len(p_est), len(p_gt))
    p_est, p_gt = p_est[:n], p_gt[:n]
    if align and n >= 3:
        R, t = umeyama_alignment(p_est, p_gt)
        p_est = p_est @ R.T + t
    return float(np.sqrt(np.mean(np.sum((p_est - p_gt) ** 2, axis=1))))


def rpe(est: np.ndarray, gt: np.ndarray, delta: int = 1):
    """Relative pose error over ``delta``-frame intervals.

    Returns (trans_rmse [m], rot_rmse [rad])."""
    n = min(len(est), len(gt))
    dts, drs = [], []
    for i in range(n - delta):
        de = np.linalg.inv(est[i]) @ est[i + delta]
        dg = np.linalg.inv(gt[i]) @ gt[i + delta]
        err = np.linalg.inv(dg) @ de
        dts.append(np.linalg.norm(err[:3, 3]))
        c = np.clip((np.trace(err[:3, :3]) - 1) / 2, -1, 1)
        drs.append(np.arccos(c))
    return float(np.sqrt(np.mean(np.square(dts)))), float(
        np.sqrt(np.mean(np.square(drs)))
    )
