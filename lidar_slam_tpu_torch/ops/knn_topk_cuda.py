"""The exact k-NN search of the k-NN PCA normals as one CUDA kernel, with its
glue.

``knn_topk`` (``lidar_slam_tpu_torch/csrc/knn_topk.cu``) replaces no Pallas
kernel: the JAX package leaves its k-NN to XLA (``lidar_slam_tpu/ops/knn.py:
knn``, a matmul and ``lax.top_k`` over target chunks), and ``ops/knn.py:knn``
stays that function's counterpart. The kernel searches each row of a padded
cloud against the rows of its own lane, with the difference-form distance
of K1, K2 and the benchmark's plain reference, in one launch for every lane.

:func:`knn_topk` runs the kernel for CUDA tensors and its plain PyTorch
version, :func:`knn_topk_torch`, for CPU tensors; nothing falls back from
one to the other. The kernel is compiled with ``csrc/knn.cu``'s flags on
first use into ``build/kernels/`` and counts its launches
(``KNN_TOPK.launches``).
"""

from __future__ import annotations

import ctypes

import torch

from . import knn, knn_cuda

KERNEL_SOURCE = knn_cuda._PKG / "csrc" / "knn_topk.cu"
MAX_K = 32      # MAX_K in knn_topk.cu
ROWS = 256      # query rows a block (THREADS in knn_topk.cu)
TILE = 1024     # targets a shared-memory tile (TILE in knn_topk.cu)
PRE = 512       # rows around a block's own that bound its K-th distance

_lib = None
build_log = ""
_occupancy: dict = {}   # (device index, list length) -> blocks an SM
_tickets: dict = {}     # device -> int32 counters the kernel leaves at 0


def library_path():
    return knn_cuda.library_path(KERNEL_SOURCE, "libknn_topk")


def load_library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel's library."""
    global _lib, build_log
    if _lib is None:
        lib, build_log = knn_cuda.build(KERNEL_SOURCE, "libknn_topk")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.lst_knn_topk.argtypes = [p, i, i, i, i, i, i, p, p, p, p, p, p]
        lib.lst_knn_topk.restype = i
        lib.lst_knn_topk_occupancy.argtypes = [i, ctypes.POINTER(i)]
        lib.lst_knn_topk_occupancy.restype = i
        _lib = lib
    return _lib


KNN_TOPK = knn_cuda.CudaKernel(
    "knn_topk", "lst_knn_topk",
    "lidar_slam_tpu/ops/knn.py:knn (XLA matmul + lax.top_k; no Pallas kernel)",
    library=load_library,
)
KERNELS = (KNN_TOPK,)


def list_length(k: int) -> int:
    """The kernel's register list for ``k`` (``list_length`` in the .cu): k
    rounded up to a multiple of 4 up to 20, ``MAX_K`` above (one
    instantiation each)."""
    return MAX_K if k > 20 else -(-k // 4) * 4


def _check(pts: torch.Tensor, mask: torch.Tensor, k: int) -> None:
    if not 1 <= k <= MAX_K:
        raise ValueError(f"knn_topk takes 1 <= k <= {MAX_K} (got {k})")
    if pts.dim() < 2 or pts.shape[-1] != 3 or mask.shape != pts.shape[:-1]:
        raise ValueError("knn_topk takes (..., N, 3) points and an (..., N) "
                         "mask")
    if pts.shape[-2] < 1:
        raise ValueError("knn_topk takes at least one row")
    if pts.dtype != torch.float32 or mask.dtype != torch.bool:
        raise ValueError("knn_topk takes float32 points and a bool mask")


def knn_topk_torch(pts: torch.Tensor, mask: torch.Tensor, k: int,
                   chunk: int = 2048) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`knn_topk`: target chunks of
    ``knn.knn_chunk(N, k, chunk)`` columns, difference-form distances
    (``knn.sq_dist``), the keys ``knn._keys`` and ``torch.topk`` over the
    running k keys (starting at index 0, +inf) and the chunk's."""
    p = knn.mask_points(pts, mask)
    N = p.shape[-2]
    c = knn.knn_chunk(N, k, chunk)
    best = torch.full((*p.shape[:-1], k), knn._INF_KEY, dtype=torch.int64,
                      device=p.device)
    cols = torch.arange(c, dtype=torch.int64, device=p.device)
    for off in range(0, N, c):
        d2 = knn.sq_dist(p, p[..., off:off + c, :])
        key = torch.cat([best, knn._keys(d2, cols + off)], dim=-1)
        best = torch.topk(key, k, dim=-1, largest=False, sorted=True).values
    idx = (best & 0xFFFFFFFF).to(torch.int32)
    d2 = (best >> 32).to(torch.int32).view(torch.float32)
    return idx, d2


def _blocks_per_sm(dev: torch.device, k: int) -> int:
    key = (dev.index, list_length(k))
    if key not in _occupancy:
        n = ctypes.c_int(0)
        with torch.cuda.device(dev):
            rc = load_library().lst_knn_topk_occupancy(k, ctypes.byref(n))
        if rc != 0 or n.value < 1:
            raise RuntimeError(f"knn_topk occupancy query failed: {rc}")
        _occupancy[key] = n.value
    return _occupancy[key]


def plan(lanes: int, N: int, slots: int) -> tuple[int, int]:
    """``(splits, tiles per split)`` of a lane's targets for one launch on a
    card with ``slots`` resident blocks: the split count whose waves of
    blocks, each a pass over the bound's rows and its split's tiles, end
    first (fewer splits on a tie, so fewer lists to merge)."""
    n_tiles = -(-N // TILE)
    blocks = lanes * -(-N // ROWS)
    best = None
    for tiles_per in range(n_tiles, 0, -1):
        splits = -(-n_tiles // tiles_per)
        if (splits - 1) * tiles_per >= n_tiles:
            continue  # an empty last split: a larger tiles_per serves
        waves = -(-blocks * splits // slots)
        # the bound's pass costs a block about two targets of its scan a row
        cost = waves * (2 * min(PRE, N) + tiles_per * TILE)
        if best is None or cost < best[0]:
            best = (cost, splits, tiles_per)
    return best[1], best[2]


def _knn_topk_cuda(pts: torch.Tensor, mask: torch.Tensor, k: int):
    lead, N = pts.shape[:-2], pts.shape[-2]
    p = knn.mask_points(pts, mask).reshape(-1, N, 3).contiguous()
    B, dev = p.shape[0], p.device
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    n_split, tiles_per = plan(B, N, sms * _blocks_per_sm(dev, k))
    idx = torch.empty((B, N, k), dtype=torch.int32, device=dev)
    d2 = torch.empty((B, N, k), dtype=torch.float32, device=dev)
    scratch = ()
    if n_split > 1:
        K = list_length(k)
        n_tickets = B * -(-N // ROWS)
        tickets = _tickets.get(dev)
        if tickets is None or tickets.numel() < n_tickets:
            tickets = _tickets[dev] = torch.zeros(
                (n_tickets,), dtype=torch.int32, device=dev)
        scratch = (torch.empty((B, n_split, K, N), dtype=torch.float32,
                               device=dev),
                   torch.empty((B, n_split, K, N), dtype=torch.int32,
                               device=dev),
                   tickets)
    knn_cuda._check_cuda(p, idx, d2, *scratch)
    ptrs = [t.data_ptr() for t in scratch] or [None] * 3
    with torch.cuda.device(dev):
        KNN_TOPK.launch(p.data_ptr(), B, N, k, n_split, tiles_per, PRE,
                        *ptrs, idx.data_ptr(), d2.data_ptr(),
                        knn_cuda._stream(p))
    return idx.reshape(*lead, N, k), d2.reshape(*lead, N, k)


def knn_topk(pts: torch.Tensor, mask: torch.Tensor, k: int,
             chunk: int = 2048) -> tuple[torch.Tensor, torch.Tensor]:
    """The exact k nearest rows of every row of its own lane: ``pts``
    (..., N, 3) float32, ``mask`` (..., N) bool (masked rows are moved to the
    sentinel first and searched like the rest) -> ``(idx (..., N, k) int32,
    d2 (..., N, k) float32)``, nearest first, the row itself included; d2 in
    the difference form (``knn.sq_dist``), equal d2 in index order. One
    kernel launch for CUDA tensors; the plain version (``chunk`` its target
    columns) for CPU tensors. Raises for ``k`` outside 1-32 and for other
    shapes, dtypes or devices."""
    _check(pts, mask, k)
    if knn_cuda._is_cuda(pts):
        return _knn_topk_cuda(pts, mask, k)
    return knn_topk_torch(pts, mask, k, chunk)
