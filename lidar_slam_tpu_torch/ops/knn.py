"""Exact nearest-neighbour searches, plain PyTorch: 1-NN and k-NN.

``nn1`` computes squared distances in the DIFFERENCE form
``dx*dx + dy*dy + dz*dz`` (exact f32, evaluated left to right), the form of
the TPU kernels (``lidar_slam_tpu/ops/knn_pallas.py:48-51``) and of the port's
CUDA kernels. It is the plain version of K2 (``ops/knn_cuda.nn1``) and what
that wrapper runs on CPU tensors. The JAX package's XLA ``nn1`` uses the
|s|^2+|t|^2-2s.t expansion instead, so its distances differ in the last bits.

``knn`` (the k-NN of the k-NN PCA normals) keeps the JAX package's matrix
form ``|s|^2 + |t|^2 - 2 s.t`` clamped at 0 (``lidar_slam_tpu/ops/knn.py:
knn``), so the k-th and (k+1)-th neighbours rank the same way in both
packages up to the matmul's rounding.

Invalid (masked-out) target points are displaced to a far sentinel so they
are never selected; ties go to the first index.
"""

from __future__ import annotations

import contextlib

import torch

SENTINEL = 1.0e6  # meters; far beyond any LiDAR return


def mask_points(pts: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Displace invalid points to the sentinel so a search never picks them."""
    return torch.where(mask[..., None], pts, torch.full_like(pts, SENTINEL))


def sq_dist(src: torch.Tensor, tgt: torch.Tensor) -> torch.Tensor:
    """(..., S, T) squared distances, difference form, f32-exact order."""
    dx = src[..., :, 0:1] - tgt[..., None, :, 0]
    dy = src[..., :, 1:2] - tgt[..., None, :, 1]
    dz = src[..., :, 2:3] - tgt[..., None, :, 2]
    return dx * dx + dy * dy + dz * dz


def nn1(
    src: torch.Tensor,
    tgt: torch.Tensor,
    tgt_mask: torch.Tensor,
    chunk: int = 2048,
) -> tuple[torch.Tensor, torch.Tensor]:
    """1-NN of each source row in the target cloud.

    ``src`` (..., S, 3), ``tgt`` (..., T, 3), ``tgt_mask`` (..., T) with equal
    leading dims. Returns ``(idx (..., S) int32, dist2 (..., S) f32)``: the
    first index of the minimum, and max(d2, 0)."""
    tgt = mask_points(tgt, tgt_mask)
    T = tgt.shape[-2]
    best_d = best_i = None
    for off in range(0, T, chunk):
        d2 = sq_dist(src, tgt[..., off : off + chunk, :])
        local_d, local_i = torch.min(d2, dim=-1)
        local_i = local_i.to(torch.int32) + off
        if best_d is None:
            best_d, best_i = local_d, local_i
        else:
            better = local_d < best_d  # strict: the earlier chunk keeps ties
            best_d = torch.where(better, local_d, best_d)
            best_i = torch.where(better, local_i, best_i)
    return best_i, torch.clamp(best_d, min=0.0)


def _chunk(n: int, requested: int) -> int:
    """The largest chunk <= ``requested`` that divides ``n``."""
    c = min(n, requested)
    while n % c != 0:
        c -= 1
    return c


def knn_chunk(T: int, k: int, chunk: int = 2048) -> int:
    """The target columns of each chunk that :func:`knn` streams over ``T``
    target rows: the largest divisor of ``T`` up to ``max(chunk, k)``."""
    return _chunk(T, max(chunk, k))


_INF_KEY = 0x7F800000 << 32  # _keys(+inf, 0)


def _keys(d2: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """int64 ``(bits(d2) << 32) | idx`` of non-negative f32 distances: one
    unique key per candidate whose order is (d2, index), so a top-k over it
    is deterministic and keeps the lower index of equal distances, as
    ``lax.top_k`` keeps the earlier position."""
    bits = (d2 + 0.0).view(torch.int32).to(torch.int64)  # -0.0 -> +0.0
    return (bits << 32) | idx.to(torch.int64)


@contextlib.contextmanager
def _full_f32_matmuls():
    """Full-float32 matmuls inside the block, whatever the caller has set
    (TF32 keeps ~3 decimal digits and would reorder the k-th neighbours);
    the caller's setting comes back after it."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


def knn(
    src: torch.Tensor,
    tgt: torch.Tensor,
    tgt_mask: torch.Tensor,
    k: int,
    chunk: int = 2048,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact k-NN: ``src`` (..., S, 3), ``tgt`` (..., T, 3), ``tgt_mask``
    (..., T) with equal leading dims (each lane searches its own target) ->
    ``(idx (..., S, k) int32, dist2 (..., S, k))``, nearest first.

    Streams ``knn_chunk(T, k, chunk)``-column target chunks and merges each
    into a running per-row top-k of ``[best, chunk]`` candidates, as
    ``lidar_slam_tpu.ops.knn.knn(exact=True)``; equal distances keep the
    lower target index (``lax.top_k``'s rule). Its matmuls are full f32
    whatever the caller's TF32 setting."""
    tgt = mask_points(tgt, tgt_mask)
    T = tgt.shape[-2]
    c = knn_chunk(T, k, chunk)
    src_sq = torch.sum(src * src, dim=-1)
    # k candidates at +inf, index 0 (the JAX accumulator's start): a chunk
    # may hold fewer than k columns (a prime T leaves c = 1)
    best = torch.full((*src.shape[:-1], k), _INF_KEY, dtype=torch.int64,
                      device=src.device)
    cols = torch.arange(c, dtype=torch.int64, device=src.device)
    for off in range(0, T, c):
        tgt_c = tgt[..., off : off + c, :]
        with _full_f32_matmuls():
            cross = torch.matmul(src, tgt_c.transpose(-1, -2))
        d2 = src_sq[..., :, None] + torch.sum(tgt_c * tgt_c, dim=-1)[..., None, :] \
            - 2.0 * cross
        key = torch.cat([best, _keys(torch.clamp(d2, min=0.0), cols + off)],
                        dim=-1)
        best = torch.topk(key, k, dim=-1, largest=False, sorted=True).values
    idx = (best & 0xFFFFFFFF).to(torch.int32)
    d2 = (best >> 32).to(torch.int32).view(torch.float32)
    return idx, d2
