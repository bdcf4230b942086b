"""SE(3) rigid-transform operations on batched tensors.

Port of ``lidar_slam_tpu/ops/se3.py``: transforms are (..., 4, 4) homogeneous
matrices [R t; 0 1], tangent vectors are 6-vectors [omega, v] (rotation
first), every function broadcasts over leading batch dimensions and keeps the
dtype it is given (float32 on the per-scan path, float64 in the pose-graph
finalize).
"""

from __future__ import annotations

import math

import torch

_EPS = 1e-8


def identity(dtype=torch.float32, device=None) -> torch.Tensor:
    return torch.eye(4, dtype=dtype, device=device)


def from_rt(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Assemble [R t; 0 1] (reference types.hpp:84-92)."""
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R = R.expand(*batch, 3, 3)
    t = t.expand(*batch, 3)
    top = torch.cat([R, t[..., :, None]], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=R.dtype, device=R.device)
    bottom = bottom.expand(*batch, 1, 4)
    return torch.cat([top, bottom], dim=-2)


def rot(T: torch.Tensor) -> torch.Tensor:
    return T[..., :3, :3]


def trans(T: torch.Tensor) -> torch.Tensor:
    return T[..., :3, 3]


def apply(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply to (..., N, 3) points row-wise: P R^T + t."""
    return torch.matmul(pts, rot(T).transpose(-1, -2)) + trans(T)[..., None, :]


def compose(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """A * B — A applied after B (reference types.hpp:118-124)."""
    return torch.matmul(A, B)


def inverse(T: torch.Tensor) -> torch.Tensor:
    """Rigid inverse via the R-transpose fast path."""
    Rt = rot(T).transpose(-1, -2)
    t_inv = -torch.einsum("...ij,...j->...i", Rt, trans(T))
    return from_rt(Rt, t_inv)


def hat(w: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix [w]_x of (..., 3)."""
    zeros = torch.zeros_like(w[..., 0])
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    return torch.stack(
        [
            torch.stack([zeros, -wz, wy], dim=-1),
            torch.stack([wz, zeros, -wx], dim=-1),
            torch.stack([-wy, wx, zeros], dim=-1),
        ],
        dim=-2,
    )


def vee(W: torch.Tensor) -> torch.Tensor:
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], dim=-1)


def adjoint(T: torch.Tensor) -> torch.Tensor:
    """SE(3) adjoint (..., 6, 6) for the [omega, v] ordering:
    Ad_T = [[R, 0], [hat(t) R, R]]."""
    R = rot(T)
    tR = torch.matmul(hat(trans(T)), R)
    Z = torch.zeros_like(R)
    top = torch.cat([R, Z], dim=-1)
    bot = torch.cat([tR, R], dim=-1)
    return torch.cat([top, bot], dim=-2)


def _sin_cos_coeffs(theta2: torch.Tensor):
    """(A, B, C) = (sin t / t, (1-cos t)/t^2, (t - sin t)/t^3) with the
    small-angle series of the JAX package (same switch points)."""
    tiny = theta2 < 1e-12
    theta2_safe = torch.where(tiny, torch.ones_like(theta2), theta2)
    theta = torch.sqrt(theta2_safe)
    A = torch.where(tiny, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    half_sinc = torch.where(
        tiny, 1.0 - theta2 / 24.0, torch.sin(theta * 0.5) / (theta * 0.5)
    )
    B = 0.5 * half_sinc * half_sinc
    small_c = theta2 < 0.01
    C = torch.where(
        small_c,
        1.0 / 6.0 - theta2 / 120.0 + theta2 * theta2 / 5040.0,
        (theta - torch.sin(theta)) / (theta2_safe * theta),
    )
    return A, B, C


def _eye3(like: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=like.dtype, device=like.device).expand(like.shape)


def exp_so3(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues' formula (reference icp.hpp:126-141)."""
    theta2 = torch.sum(w * w, dim=-1)
    A, B, _ = _sin_cos_coeffs(theta2)
    W = hat(w)
    return _eye3(W) + A[..., None, None] * W + B[..., None, None] * (W @ W)


def log_so3(R: torch.Tensor) -> torch.Tensor:
    """Inverse of Rodrigues, robust near theta = 0 and theta = pi."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    anti = vee(R - R.transpose(-1, -2))  # 2 sin(theta) * axis
    s2 = torch.sum(anti * anti, dim=-1) * 0.25
    near_pi = cos_t < -1.0 + 1e-4

    small = s2 < 1e-12
    s2_g = torch.where(small, torch.ones_like(s2), s2)
    s_g = torch.sqrt(s2_g)
    theta_g = torch.atan2(s_g, cos_t)
    scale = torch.where(small, 0.5 + s2 / 12.0, theta_g / (2.0 * s_g))
    w_generic = scale[..., None] * anti

    s_pi = torch.sqrt(torch.where(near_pi, s2, torch.zeros_like(s2)) + 1e-20)
    theta_pi = math.pi - torch.asin(torch.clamp(s_pi, max=1.0))
    S = (R + _eye3(R)) * 0.5
    diag = torch.stack([S[..., 0, 0], S[..., 1, 1], S[..., 2, 2]], dim=-1)
    k = torch.argmax(diag, dim=-1)
    col = torch.gather(S, -1, k[..., None, None].expand(*k.shape, 3, 1))[..., 0]
    axis = col / torch.clamp(torch.linalg.norm(col, dim=-1, keepdim=True), min=_EPS)
    sign = torch.where(
        torch.sum(axis * anti, dim=-1) < 0.0,
        -torch.ones_like(s2), torch.ones_like(s2),
    )
    w_pi = (sign * theta_pi)[..., None] * axis
    return torch.where(near_pi[..., None], w_pi, w_generic)


def exp(xi: torch.Tensor) -> torch.Tensor:
    """SE(3) exponential map of (..., 6) tangent [omega, v]."""
    w, v = xi[..., :3], xi[..., 3:]
    theta2 = torch.sum(w * w, dim=-1)
    A, B, C = _sin_cos_coeffs(theta2)
    W = hat(w)
    WW = W @ W
    I = _eye3(W)
    R = I + A[..., None, None] * W + B[..., None, None] * WW
    V = I + B[..., None, None] * W + C[..., None, None] * WW
    t = torch.einsum("...ij,...j->...i", V, v)
    return from_rt(R, t)


def log(T: torch.Tensor) -> torch.Tensor:
    """SE(3) logarithm map to (..., 6) tangent [omega, v]."""
    R, t = rot(T), trans(T)
    w = log_so3(R)
    theta2 = torch.sum(w * w, dim=-1)
    A, B, _ = _sin_cos_coeffs(theta2)
    W = hat(w)
    WW = W @ W
    small = theta2 < 0.01
    theta2_safe = torch.where(small, torch.ones_like(theta2), theta2)
    coef = torch.where(
        small,
        1.0 / 12.0 + theta2 / 720.0 + theta2 * theta2 / 30240.0,
        (1.0 - A / (2.0 * B)) / theta2_safe,
    )
    Vinv = _eye3(W) - 0.5 * W + coef[..., None, None] * WW
    v = torch.einsum("...ij,...j->...i", Vinv, t)
    return torch.cat([w, v], dim=-1)


def orthonormalize(T: torch.Tensor) -> torch.Tensor:
    """Project the rotation block back onto SO(3) (Gram-Schmidt)."""
    R = rot(T)
    x = R[..., :, 0]
    x = x / torch.clamp(torch.linalg.norm(x, dim=-1, keepdim=True), min=_EPS)
    y = R[..., :, 1]
    y = y - torch.sum(x * y, dim=-1, keepdim=True) * x
    y = y / torch.clamp(torch.linalg.norm(y, dim=-1, keepdim=True), min=_EPS)
    z = torch.linalg.cross(x, y, dim=-1)
    Rn = torch.stack([x, y, z], dim=-1)
    return from_rt(Rn, trans(T))
