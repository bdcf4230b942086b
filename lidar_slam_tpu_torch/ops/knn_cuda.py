"""The two correspondence-search kernels of the main path, with their glue.

Port of ``lidar_slam_tpu/ops/knn_pallas.py``, whose two Pallas kernels become
CUDA C++ kernels for Hopper in ``lidar_slam_tpu_torch/csrc/knn.cu``:

- **K1** ``match_slab`` / ``nn1_slab`` / ``SlabBackend`` (replaces
  ``_match_slab_kernel``): slab-window 1-NN over an x-sorted target, with the
  matched point and normal gathered in the kernel. Every odometry ICP
  iteration in fast mode runs it.
- **K2** ``nn1`` (replaces ``_nn1_kernel`` / ``nn1_pallas``): exact
  brute-force 1-NN, batched over lanes. Both loop-verification phases run it.

Each wrapper runs its kernel for CUDA tensors (or raises) and the plain
PyTorch version of the same contract (``nn1_torch``, ``nn1_slab_torch``,
``match_slab_torch``) for CPU tensors; nothing falls back from one to the
other. The kernels are compiled with ``nvcc`` for ``sm_90a`` on first use
into ``build/kernels/`` (keyed on a hash of the source) and loaded with
ctypes. Each kernel counts its launches (``MATCH_SLAB.launches``,
``NN1.launches``).

The window-start glue (``_build_slab_index``, ``_slab_starts_lut``,
``_pack_tgt8``) is plain tensor code shared by both versions; its f32
arithmetic keeps the JAX expression order so bins, and so window starts
(and window misses), match the TPU kernel's.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from dataclasses import dataclass
from pathlib import Path

import torch

from .knn import SENTINEL, mask_points, sq_dist
from .knn import nn1 as nn1_torch

_QUANT = 128      # window starts rounded down to multiples of this
_LUT_BINS = 4096  # quantized x -> target-index lookup resolution

_PKG = Path(__file__).resolve().parents[1]
KERNEL_SOURCE = _PKG / "csrc" / "knn.cu"
BUILD_DIR = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_lib = None
build_log = ""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path() -> Path:
    """Where the shared library for the current kernel source lives."""
    h = hashlib.sha256(KERNEL_SOURCE.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libknn_{h.hexdigest()[:16]}.so"


def load_library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library."""
    global _lib, build_log
    if _lib is not None:
        return _lib
    so = library_path()
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(KERNEL_SOURCE)],
            capture_output=True, text=True,
        )
        build_log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{build_log}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.lst_nn1.argtypes = [p, p, i, i, i, p, p, p]
    lib.lst_nn1.restype = i
    lib.lst_match_slab.argtypes = [p, p, p, i, i, i, p, p, p, p]
    lib.lst_match_slab.restype = i
    _lib = lib
    return lib


class CudaKernel:
    """One kernel of ``csrc/knn.cu``: its C entry point and launch count."""

    def __init__(self, name: str, symbol: str, replaces: str):
        self.name = name
        self.symbol = symbol
        self.replaces = replaces
        self.launches = 0

    def launch(self, *args) -> None:
        fn = getattr(load_library(), self.symbol)
        rc = fn(*args)
        if rc != 0:
            raise RuntimeError(f"{self.name} launch failed: cudaError {rc}")
        self.launches += 1


MATCH_SLAB = CudaKernel(
    "match_slab", "lst_match_slab", "lidar_slam_tpu/ops/knn_pallas.py:228"
)
NN1 = CudaKernel("nn1", "lst_nn1", "lidar_slam_tpu/ops/knn_pallas.py:41")
KERNELS = (MATCH_SLAB, NN1)


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check_cuda(*tensors: torch.Tensor, aligned=()) -> None:
    dev = tensors[0].device
    for t in tensors + tuple(aligned):
        if not t.is_cuda or t.device != dev or not t.is_contiguous():
            raise ValueError("kernel operands must be contiguous, on one GPU")
    for t in aligned:  # read or written as float4
        if t.data_ptr() % 16:
            raise ValueError("packed rows must be 16-byte aligned")


def _is_cuda(t: torch.Tensor) -> bool:
    if t.is_cuda:
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {t.device}")


def _pad_rows(x: torch.Tensor, multiple: int, value: float) -> torch.Tensor:
    rem = (-x.shape[0]) % multiple
    if rem == 0:
        return x
    pad = torch.full((rem,) + tuple(x.shape[1:]), value, dtype=x.dtype,
                     device=x.device)
    return torch.cat([x, pad], dim=0)


# ---------------------------------------------------------------------------
# K2: exact brute-force 1-NN
# ---------------------------------------------------------------------------


def _nn1_cuda(src: torch.Tensor, tgt: torch.Tensor, tgt_mask: torch.Tensor):
    lead = src.shape[:-2]
    S, T = src.shape[-2], tgt.shape[-2]
    if src.dtype != torch.float32 or tgt.dtype != torch.float32:
        raise ValueError("nn1 kernel takes float32 points")
    s = src.reshape(-1, S, 3).contiguous()
    t = mask_points(tgt, tgt_mask).reshape(-1, T, 3).contiguous()
    if s.shape[0] != t.shape[0]:
        raise ValueError("nn1: source and target lanes differ")
    B = s.shape[0]
    idx = torch.empty((B, S), dtype=torch.int32, device=s.device)
    d2 = torch.empty((B, S), dtype=torch.float32, device=s.device)
    _check_cuda(s, t, idx, d2)
    NN1.launch(s.data_ptr(), t.data_ptr(), B, S, T, idx.data_ptr(),
               d2.data_ptr(), _stream(s))
    return idx.reshape(*lead, S), d2.reshape(*lead, S)


def nn1(src: torch.Tensor, tgt: torch.Tensor, tgt_mask: torch.Tensor):
    """Exact 1-NN (K2): ``src`` (..., S, 3), ``tgt`` (..., T, 3), ``tgt_mask``
    (..., T) -> ``(idx (..., S) int32, dist2 (..., S))``. All leading-dim
    lanes go through one kernel launch."""
    if _is_cuda(src):
        return _nn1_cuda(src, tgt, tgt_mask)
    return nn1_torch(src, tgt, tgt_mask)


# ---------------------------------------------------------------------------
# K1: slab-window fused match
# ---------------------------------------------------------------------------


@dataclass
class SlabIndex:
    """Per-target search state, built once per ICP call: the packed target,
    a 4,096-bin LUT from quantized x to the first target index at or after
    it (searchsorted over the running max of the packed x), and the bin
    scale."""

    tgt8: torch.Tensor  # (Tp, 8): xyz | normal xyz | 0 0, pads at SENTINEL
    lut: torch.Tensor   # (_LUT_BINS,) int64
    lo: torch.Tensor    # () f32
    inv_h: torch.Tensor  # () f32
    padded_T: int


def _pack_tgt8(tgt: torch.Tensor, tgt_mask: torch.Tensor,
               tgt_normals: torch.Tensor | None, tt: int) -> torch.Tensor:
    """(Tp, 8) packed rows [x y z | nx ny nz | 0 0] with masked rows' xyz at
    the sentinel, padded with SENTINEL rows to a ``tt`` multiple. (The TPU
    layout is the transpose, (8, Tp); a row per point suits a direct load.)"""
    T = tgt.shape[0]
    tgt_m = mask_points(tgt, tgt_mask)
    zeros = torch.zeros((T, 2 if tgt_normals is not None else 5),
                        dtype=tgt.dtype, device=tgt.device)
    parts = [tgt_m, tgt_normals, zeros] if tgt_normals is not None else [tgt_m, zeros]
    return _pad_rows(torch.cat(parts, dim=1), tt, SENTINEL).contiguous()


def _build_slab_index(tgt: torch.Tensor, tgt_mask: torch.Tensor,
                      tgt_normals: torch.Tensor | None) -> SlabIndex:
    T = tgt.shape[0]
    tgt8 = _pack_tgt8(tgt, tgt_mask, tgt_normals, _QUANT)
    xs = tgt[:, 0]
    inf = torch.full_like(xs, float("inf"))
    lo = torch.min(torch.where(tgt_mask, xs, inf))
    hi = torch.max(torch.where(tgt_mask, xs, -inf))
    h = torch.clamp((hi - lo) / _LUT_BINS, min=1e-6)
    x_mono = torch.cummax(tgt8[:T, 0], dim=0).values
    edges = lo + h * torch.arange(_LUT_BINS, dtype=tgt.dtype, device=tgt.device)
    lut = torch.searchsorted(x_mono, edges, side="left")
    inv_h = torch.ones_like(h) / h
    return SlabIndex(tgt8, lut, lo, inv_h, tgt8.shape[0])


def _slab_starts_lut(src_p: torch.Tensor, index: SlabIndex, ts: int,
                     window: int, margin: float) -> torch.Tensor:
    """Per-source-tile window starts (int32, multiples of _QUANT), clipped so
    start + window stays inside the padded target."""
    tiles_x = src_p[:, 0].reshape(-1, ts)
    tile_min_x = torch.min(tiles_x, dim=1).values - margin
    b = torch.clamp(
        torch.floor((tile_min_x - index.lo) * index.inv_h), 0, _LUT_BINS - 1
    ).to(torch.int64)
    starts = torch.div(index.lut[b], _QUANT, rounding_mode="floor") * _QUANT
    return torch.clamp(starts, 0, max(index.padded_T - window, 0)).to(torch.int32)


def _match_slab_plain(src_p, tgt8, starts, ts: int, window: int):
    """Plain version of the K1 kernel: (qn (Sp, 8), minv (Sp,), argm (Sp,))."""
    n_tiles = src_p.shape[0] // ts
    cols = starts.to(torch.int64)[:, None] + torch.arange(
        window, device=src_p.device
    )
    win = tgt8[cols]                                    # (tiles, W, 8)
    d = sq_dist(src_p.reshape(n_tiles, ts, 3), win[..., :3])  # (tiles, ts, W)
    minv, am = torch.min(d, dim=-1)
    g = (am + starts.to(torch.int64)[:, None]).reshape(-1)
    return tgt8[g], minv.reshape(-1), g.to(torch.int32)


def _match_slab_cuda(src_p, tgt8, starts, ts: int, window: int):
    Sp = src_p.shape[0]
    if src_p.dtype != torch.float32 or tgt8.dtype != torch.float32:
        raise ValueError("match_slab kernel takes float32 points")
    if ts > 1024:
        raise ValueError("match_slab kernel takes tiles of at most 1024 rows")
    src_p = src_p.contiguous()
    starts = starts.to(torch.int32).contiguous()
    qn = torch.empty((Sp, 8), dtype=torch.float32, device=src_p.device)
    minv = torch.empty((Sp,), dtype=torch.float32, device=src_p.device)
    argm = torch.empty((Sp,), dtype=torch.int32, device=src_p.device)
    _check_cuda(src_p, starts, minv, argm, aligned=(tgt8, qn))
    MATCH_SLAB.launch(
        src_p.data_ptr(), tgt8.data_ptr(), starts.data_ptr(), Sp // ts, ts,
        window, qn.data_ptr(), minv.data_ptr(), argm.data_ptr(),
        _stream(src_p),
    )
    return qn, minv, argm


def _match_slab_call(src_p, tgt8, starts, ts: int, window: int):
    if _is_cuda(src_p):
        return _match_slab_cuda(src_p, tgt8, starts, ts, window)
    return _match_slab_plain(src_p, tgt8, starts, ts, window)


def _slab_query(src, index: SlabIndex, ts: int, window: int, margin: float,
                call):
    S = src.shape[0]
    ts = min(ts, max(8, S))
    window = min(window, index.padded_T)
    src_p = _pad_rows(src, ts, SENTINEL)
    starts = _slab_starts_lut(src_p, index, ts, window, margin)
    qn, minv, argm = call(src_p, index.tgt8, starts, ts, window)
    return qn[:S], torch.clamp(minv[:S], min=0.0), argm[:S], starts


def _nn1_slab(src, tgt, tgt_mask, ts, window, margin, call):
    index = _build_slab_index(tgt, tgt_mask, None)
    _, d2, argm, _ = _slab_query(src, index, ts, window, margin, call)
    return torch.clamp(argm, max=tgt.shape[0] - 1), d2


def _match_slab(src, tgt, tgt_mask, tgt_normals, ts, window, margin, call):
    index = _build_slab_index(tgt, tgt_mask, tgt_normals)
    qn, d2, _, _ = _slab_query(src, index, ts, window, margin, call)
    return qn[:, 0:3], qn[:, 3:6], d2


def nn1_slab(src, tgt, tgt_mask, ts: int = 256, window: int = 4096,
             margin: float = 3.0):
    """Slab-windowed 1-NN (K1; contract of ``nn1_slab_pallas``):
    ``(idx (S,) int32 clamped to T-1, dist2 (S,))``."""
    return _nn1_slab(src, tgt, tgt_mask, ts, window, margin, _match_slab_call)


def nn1_slab_torch(src, tgt, tgt_mask, ts: int = 256, window: int = 4096,
                   margin: float = 3.0):
    """Plain version of :func:`nn1_slab`."""
    return _nn1_slab(src, tgt, tgt_mask, ts, window, margin, _match_slab_plain)


def match_slab(src, tgt, tgt_mask, tgt_normals, ts: int = 256,
               window: int = 4096, margin: float = 3.0):
    """Fused slab 1-NN + gather (K1; contract of ``match_slab_pallas``):
    ``(matched (S, 3), normals (S, 3), dist2 (S,))``."""
    return _match_slab(src, tgt, tgt_mask, tgt_normals, ts, window, margin,
                       _match_slab_call)


def match_slab_torch(src, tgt, tgt_mask, tgt_normals, ts: int = 256,
                     window: int = 4096, margin: float = 3.0):
    """Plain version of :func:`match_slab`."""
    return _match_slab(src, tgt, tgt_mask, tgt_normals, ts, window, margin,
                       _match_slab_plain)


class SlabBackend:
    """Injectable ICP backend around K1 (``make_slab_pallas_backend``).

    ``__call__`` is the plain ``nn1_fn`` contract; ``prepare_match`` is
    ops/icp.py's fused protocol: the index is built once per ICP call and
    each iteration pays only the LUT lookup and one kernel launch."""

    def __init__(self, ts: int = 256, window: int = 4096, margin: float = 3.0):
        self.ts, self.window, self.margin = ts, window, margin

    def __call__(self, s, t, m):
        return nn1_slab(s, t, m, self.ts, self.window, self.margin)

    def prepare_match(self, tgt_pts, tgt_mask, tgt_normals):
        index = _build_slab_index(tgt_pts, tgt_mask, tgt_normals)

        def q(cur):
            qn, d2, _, _ = _slab_query(cur, index, self.ts, self.window,
                                       self.margin, _match_slab_call)
            return qn[:, 0:3], qn[:, 3:6], d2

        return q
