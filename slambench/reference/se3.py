"""Rigid transforms as (..., 4, 4) matrices [R t; 0 1]; tangents [w, v]."""

from __future__ import annotations

import torch

from .prec import FP32, Precision


def from_rt(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    shape = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    top = torch.cat([R.expand(*shape, 3, 3), t.expand(*shape, 3)[..., None]], -1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=R.dtype, device=R.device)
    return torch.cat([top, bottom.expand(*shape, 1, 4)], -2)


def apply(T: torch.Tensor, pts: torch.Tensor, p: Precision = FP32) -> torch.Tensor:
    """Points (..., N, 3) through T: p R^T + t."""
    return p.mm(pts, T[..., :3, :3].transpose(-1, -2)) + T[..., None, :3, 3]


def inverse(T: torch.Tensor) -> torch.Tensor:
    Rt = T[..., :3, :3].transpose(-1, -2)
    return from_rt(Rt, -(Rt @ T[..., :3, 3:])[..., 0])


def hat(w: torch.Tensor) -> torch.Tensor:
    z = torch.zeros_like(w[..., 0])
    return torch.stack([
        torch.stack([z, -w[..., 2], w[..., 1]], -1),
        torch.stack([w[..., 2], z, -w[..., 0]], -1),
        torch.stack([-w[..., 1], w[..., 0], z], -1)], -2)


def _coeffs(th2: torch.Tensor):
    small = th2 < 1e-10
    th2s = torch.where(small, torch.ones_like(th2), th2)
    th = torch.sqrt(th2s)
    A = torch.where(small, 1 - th2 / 6, torch.sin(th) / th)
    B = torch.where(small, 0.5 - th2 / 24, (1 - torch.cos(th)) / th2s)
    C = torch.where(small, 1.0 / 6 - th2 / 120, (th - torch.sin(th)) / (th2s * th))
    return A, B, C


def exp_so3(w: torch.Tensor) -> torch.Tensor:
    A, B, _ = _coeffs((w * w).sum(-1))
    W = hat(w)
    I = torch.eye(3, dtype=w.dtype, device=w.device)
    return I + A[..., None, None] * W + B[..., None, None] * (W @ W)


def exp(xi: torch.Tensor) -> torch.Tensor:
    w, v = xi[..., :3], xi[..., 3:]
    A, B, C = _coeffs((w * w).sum(-1))
    W = hat(w)
    WW = W @ W
    I = torch.eye(3, dtype=xi.dtype, device=xi.device)
    R = I + A[..., None, None] * W + B[..., None, None] * WW
    V = I + B[..., None, None] * W + C[..., None, None] * WW
    return from_rt(R, (V @ v[..., None])[..., 0])


def log(T: torch.Tensor) -> torch.Tensor:
    """SE(3) log for rotations away from pi (loop and odometry residuals)."""
    R, t = T[..., :3, :3], T[..., :3, 3]
    c = torch.clamp((R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2] - 1) / 2, -1.0, 1.0)
    a = torch.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0],
                     R[..., 1, 0] - R[..., 0, 1]], -1)
    s = torch.sqrt(torch.clamp((a * a).sum(-1), min=1e-30)) / 2
    th = torch.atan2(s, c)
    small = th < 1e-5
    scale = torch.where(small, 0.5 + th * th / 12, th / (2 * torch.where(small, torch.ones_like(s), s)))
    w = scale[..., None] * a
    th2 = (w * w).sum(-1)
    A, B, _ = _coeffs(th2)
    W = hat(w)
    sm = th2 < 1e-6
    coef = torch.where(sm, 1.0 / 12 + th2 / 720,
                       (1 - A / (2 * B)) / torch.where(sm, torch.ones_like(th2), th2))
    I = torch.eye(3, dtype=T.dtype, device=T.device)
    Vinv = I - 0.5 * W + coef[..., None, None] * (W @ W)
    return torch.cat([w, (Vinv @ t[..., None])[..., 0]], -1)


def orthonormalize(T: torch.Tensor) -> torch.Tensor:
    R = T[..., :3, :3]
    x = R[..., :, 0] / torch.linalg.norm(R[..., :, 0], dim=-1, keepdim=True)
    y = R[..., :, 1] - (x * R[..., :, 1]).sum(-1, keepdim=True) * x
    y = y / torch.linalg.norm(y, dim=-1, keepdim=True)
    z = torch.linalg.cross(x, y, dim=-1)
    return from_rt(torch.stack([x, y, z], -1), T[..., :3, 3])
