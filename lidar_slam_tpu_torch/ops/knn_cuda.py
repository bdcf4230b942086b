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
other (``cuda_lib.use_kernel``). ``cuda_lib`` builds ``knn.cu`` on first use
and loads it (:data:`LIBRARY`); each kernel counts its launches
(``MATCH_SLAB.launches``, ``NN1.launches``).

Both searches split a row's candidates over threads and blocks and merge
the partial minima with a 64-bit key ``(bits(d2) << 32) | index`` under an
unsigned min: the smallest d2 and, among equals, the smallest index, in any
merge order (``tests/test_torch_knn.py`` holds the rule in plain torch).

Per ICP call the target is laid out once (``_build_slab_index`` for K1,
``nn1.prepare`` for K2); per iteration a query on a CUDA tensor is one
kernel launch. K1's kernel computes its own window starts; the plain
version's glue (``_pad_rows``, ``_slab_starts_lut``) is what it must equal,
and its f32 arithmetic keeps the JAX expression order so bins, and so
window starts (and window misses), match the TPU kernel's.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass, field

import torch

from . import cuda_lib
from .knn import SENTINEL, mask_points, sq_dist
from .knn import nn1 as nn1_torch

_QUANT = 128      # window starts rounded down to multiples of this
_LUT_BINS = 4096  # quantized x -> target-index lookup resolution

_p, _i = ctypes.c_void_p, ctypes.c_int
LIBRARY = cuda_lib.Library("knn.cu", "libknn", {
    "lst_nn1": ([_p, _p, _i, _i, _i, _i, _i, _p, _p, _p, _p, _p], _i),
    "lst_match_slab": ([_p, _i, _i, _p, _i, _p, _p, _p, ctypes.c_float, _i,
                        _i, _i, _i, _p, _p, _p, _p, _p, _p, _p], _i),
})
MATCH_SLAB = cuda_lib.CudaKernel(
    "match_slab", "lst_match_slab", "lidar_slam_tpu/ops/knn_pallas.py:228",
    LIBRARY,
)
NN1 = cuda_lib.CudaKernel("nn1", "lst_nn1",
                          "lidar_slam_tpu/ops/knn_pallas.py:41", LIBRARY)
KERNELS = (MATCH_SLAB, NN1)


def _pad_rows(x: torch.Tensor, multiple: int, value: float) -> torch.Tensor:
    """Pad the rows (dim -2) of (..., R, C) to a ``multiple`` of rows."""
    rem = (-x.shape[-2]) % multiple
    if rem == 0:
        return x
    pad = torch.full((*x.shape[:-2], rem, x.shape[-1]), value, dtype=x.dtype,
                     device=x.device)
    return torch.cat([x, pad], dim=-2)


# ---------------------------------------------------------------------------
# K2: exact brute-force 1-NN
# ---------------------------------------------------------------------------


_NN1_TILE = 512         # targets per shared-memory tile (NN1_TILE in knn.cu)
_NN1_BLOCK_ROWS = 512   # source rows per block (NN1_THREADS * ROWS in knn.cu)
_NN1_BLOCKS_PER_SM = 2  # blocks the target is split for, per SM of the card


def _nn1_plan(lanes: int, S: int, Tp: int, sms: int) -> tuple[int, int]:
    """``(splits, tiles per split)`` of the padded target for one K2 launch:
    enough splits that about ``_NN1_BLOCKS_PER_SM`` blocks per SM are in
    flight, every split holding at least one tile."""
    n_tiles = Tp // _NN1_TILE
    blocks = lanes * (-(-S // _NN1_BLOCK_ROWS))
    want = -(-_NN1_BLOCKS_PER_SM * sms // max(blocks, 1))
    tiles_per = -(-n_tiles // max(1, min(n_tiles, want)))
    return -(-n_tiles // tiles_per), tiles_per


def _nn1_prepare_cuda(tgt: torch.Tensor, tgt_mask: torch.Tensor):
    lead, T = tgt.shape[:-2], tgt.shape[-2]
    if tgt.dtype != torch.float32:
        raise ValueError("nn1 kernel takes float32 points")
    if T < 1:
        raise ValueError("nn1 kernel takes at least one target row")
    t = mask_points(tgt, tgt_mask).reshape(-1, T, 3)
    B, dev = t.shape[0], t.device
    # SoA x/y/z planes; the +inf padding to a tile multiple never wins
    Tp = -(-T // _NN1_TILE) * _NN1_TILE
    soa = torch.full((B, 3, Tp), float("inf"), dtype=t.dtype, device=dev)
    soa[:, :, :T] = t.transpose(1, 2)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    scratch = {}  # S -> (part, tickets); the kernel leaves tickets at 0

    def query(src: torch.Tensor):
        S = src.shape[-2]
        if src.dtype != torch.float32 or src.shape[:-2] != lead:
            raise ValueError("nn1: float32 sources with the target's lanes")
        s = src.reshape(-1, S, 3).contiguous()
        n_split, tiles_per = _nn1_plan(B, S, Tp, sms)
        if S not in scratch:
            scratch[S] = (
                torch.empty((B, n_split, S), dtype=torch.int64, device=dev),
                torch.zeros((B * (-(-S // _NN1_BLOCK_ROWS)),),
                            dtype=torch.int32, device=dev),
            )
        part, tickets = scratch[S]
        idx = torch.empty((B, S), dtype=torch.int32, device=dev)
        d2 = torch.empty((B, S), dtype=torch.float32, device=dev)
        cuda_lib.check_operands(s, part, tickets, idx, d2, aligned=(soa,))
        with torch.cuda.device(dev):  # the stream's card (a mesh has several)
            NN1.launch(s.data_ptr(), soa.data_ptr(), B, S, Tp, n_split,
                       tiles_per, part.data_ptr(), tickets.data_ptr(),
                       idx.data_ptr(), d2.data_ptr(), cuda_lib.stream(s))
        return idx.reshape(*lead, S), d2.reshape(*lead, S)

    return query


def _nn1_prepare(tgt: torch.Tensor, tgt_mask: torch.Tensor):
    """Lay the target out once (mask to the sentinel, SoA planes) and return
    ``query(src) -> (idx, dist2)``: on CUDA tensors every query is one K2
    launch; on CPU tensors it is the plain version."""
    if cuda_lib.use_kernel(tgt):
        return _nn1_prepare_cuda(tgt, tgt_mask)
    return lambda src: nn1_torch(src, tgt, tgt_mask)


def nn1(src: torch.Tensor, tgt: torch.Tensor, tgt_mask: torch.Tensor):
    """Exact 1-NN (K2): ``src`` (..., S, 3), ``tgt`` (..., T, 3), ``tgt_mask``
    (..., T) -> ``(idx (..., S) int32, dist2 (..., S))``. All leading-dim
    lanes go through one kernel launch. ``nn1.prepare(tgt, tgt_mask)`` is
    ops/icp.py's protocol for a target that serves several queries."""
    if cuda_lib.use_kernel(src):
        return _nn1_prepare_cuda(tgt, tgt_mask)(src)
    return nn1_torch(src, tgt, tgt_mask)


nn1.prepare = _nn1_prepare


# ---------------------------------------------------------------------------
# K1: slab-window fused match
# ---------------------------------------------------------------------------


@dataclass
class SlabIndex:
    """Per-target search state, built once per ICP call, for B lanes: the
    packed targets, a 4,096-bin LUT per lane from quantized x to the first
    target index at or after it (searchsorted over the running max of the
    packed x), and each lane's bin scale. A one-lane index built from an
    unbatched (T, 3) target has B = 1 and answers unbatched queries."""

    tgt8: torch.Tensor   # (B, Tp, 8): xyz | normal xyz | 0 0, pads at SENTINEL
    lut: torch.Tensor    # (B, _LUT_BINS) int64
    lo: torch.Tensor     # (B,) f32
    inv_h: torch.Tensor  # (B,) f32
    padded_T: int
    # the kernel's merge scratch, by (lanes, tiles, ts, chunks): per-chunk
    # keys and the tiles' ticket counters, which the kernel leaves at 0
    scratch: dict = field(default_factory=dict)


def _pack_tgt8(tgt: torch.Tensor, tgt_mask: torch.Tensor,
               tgt_normals: torch.Tensor | None, tt: int) -> torch.Tensor:
    """(..., Tp, 8) packed rows [x y z | nx ny nz | 0 0] with masked rows'
    xyz at the sentinel, padded with SENTINEL rows to a ``tt`` multiple.
    (The TPU layout is the transpose, (8, Tp); a row per point suits a
    direct load.)"""
    tgt_m = mask_points(tgt, tgt_mask)
    zeros = torch.zeros((*tgt.shape[:-1], 2 if tgt_normals is not None else 5),
                        dtype=tgt.dtype, device=tgt.device)
    parts = [tgt_m, tgt_normals, zeros] if tgt_normals is not None else [tgt_m, zeros]
    return _pad_rows(torch.cat(parts, dim=-1), tt, SENTINEL).contiguous()


def _build_slab_index(tgt: torch.Tensor, tgt_mask: torch.Tensor,
                      tgt_normals: torch.Tensor | None) -> SlabIndex:
    """The index of (T, 3) or (B, T, 3) targets; each lane's arithmetic is
    the one-lane arithmetic on that lane."""
    if tgt.dim() == 2:
        return _build_slab_index(
            tgt[None], tgt_mask[None],
            None if tgt_normals is None else tgt_normals[None])
    T = tgt.shape[1]
    tgt8 = _pack_tgt8(tgt, tgt_mask, tgt_normals, _QUANT)
    xs = tgt[..., 0]
    inf = torch.full_like(xs, float("inf"))
    lo = torch.min(torch.where(tgt_mask, xs, inf), dim=-1).values
    hi = torch.max(torch.where(tgt_mask, xs, -inf), dim=-1).values
    h = torch.clamp((hi - lo) / _LUT_BINS, min=1e-6)
    x_mono = torch.cummax(tgt8[:, :T, 0], dim=-1).values.contiguous()
    edges = lo[:, None] + h[:, None] * torch.arange(
        _LUT_BINS, dtype=tgt.dtype, device=tgt.device)
    lut = torch.searchsorted(x_mono, edges.contiguous(), side="left")
    inv_h = torch.ones_like(h) / h
    return SlabIndex(tgt8, lut, lo, inv_h, tgt8.shape[1])


def _slab_starts_lut(src_p: torch.Tensor, index: SlabIndex, ts: int,
                     window: int, margin: float) -> torch.Tensor:
    """Per-source-tile window starts (int32, multiples of _QUANT), clipped so
    start + window stays inside the padded target: (tiles,) for a (Sp, 3)
    source, (B, tiles) for (B, Sp, 3)."""
    if src_p.dim() == 2:
        return _slab_starts_lut(src_p[None], index, ts, window, margin)[0]
    B = src_p.shape[0]
    tiles_x = src_p[..., 0].reshape(B, -1, ts)
    tile_min_x = torch.min(tiles_x, dim=-1).values - margin
    b = torch.clamp(
        torch.floor((tile_min_x - index.lo[:, None]) * index.inv_h[:, None]),
        0, _LUT_BINS - 1,
    ).to(torch.int64)
    starts = torch.div(torch.gather(index.lut, 1, b), _QUANT,
                       rounding_mode="floor") * _QUANT
    return torch.clamp(starts, 0, max(index.padded_T - window, 0)).to(torch.int32)


def _match_slab_plain(src_p, tgt8, starts, ts: int, window: int):
    """Plain version of the K1 kernel over lanes: src_p (B, Sp, 3), tgt8
    (B, Tp, 8), starts (B, tiles) -> (qn (B, Sp, 8), minv (B, Sp), argm
    (B, Sp))."""
    B, Sp = src_p.shape[:2]
    n_tiles = Sp // ts
    cols = starts.to(torch.int64)[..., None] + torch.arange(
        window, device=src_p.device
    )                                                   # (B, tiles, W)
    win = torch.gather(tgt8, 1, cols.reshape(B, -1, 1).expand(-1, -1, 8))
    win = win.reshape(B, n_tiles, window, 8)
    d = sq_dist(src_p.reshape(B, n_tiles, ts, 3), win[..., :3])  # (B, tiles, ts, W)
    minv, am = torch.min(d, dim=-1)
    g = (am + starts.to(torch.int64)[..., None]).reshape(B, Sp)
    qn = torch.gather(tgt8, 1, g[..., None].expand(-1, -1, 8))
    return qn, minv.reshape(B, Sp), g.to(torch.int32)


def _slab_query_plain(src, index: SlabIndex, ts: int, window: int,
                      margin: float):
    """Plain version of one K1 query over lanes (src (B, S, 3)): pad, LUT
    starts, windowed search."""
    S = src.shape[1]
    src_p = _pad_rows(src, ts, SENTINEL)
    starts = _slab_starts_lut(src_p, index, ts, window, margin)
    qn, minv, argm = _match_slab_plain(src_p, index.tgt8, starts, ts, window)
    return qn[:, :S], torch.clamp(minv[:, :S], min=0.0), argm[:, :S], starts


def _slab_plan(window: int) -> tuple[int, int]:
    """``(chunks, chunk length)`` of one tile's window for the K1 kernel, one
    block a chunk: at most 8 chunks (a power of two) of at least 256 targets,
    the length a multiple of 64 (the kernel pads the last chunk)."""
    n_chunk = 1
    while n_chunk < 8 and window // (2 * n_chunk) >= 256:
        n_chunk *= 2
    return n_chunk, -(-(-(-window // n_chunk)) // 64) * 64


def _slab_query_cuda(src, index: SlabIndex, ts: int, window: int,
                     margin: float):
    """One K1 query on the card for all B lanes (src (B, S, 3)): one kernel
    launch and nothing else (the first query of an index also allocates its
    merge scratch). The kernel pads by masking rows past S, computes each
    lane's window starts from that lane's ``lo``, ``inv_h`` and ``lut`` on
    the device, clamps d2 and writes only the S live rows."""
    B, S, dev = src.shape[0], src.shape[1], src.device
    if src.dtype != torch.float32 or index.tgt8.dtype != torch.float32:
        raise ValueError("match_slab kernel takes float32 points")
    if index.lut.dtype != torch.int64 or index.lo.dtype != torch.float32:
        raise ValueError("match_slab kernel takes an int64 LUT and f32 scale")
    if index.tgt8.shape[0] != B:
        raise ValueError("match_slab: one source per target lane")
    src = src.contiguous()
    qn = torch.empty((B, S, 8), dtype=torch.float32, device=dev)
    d2 = torch.empty((B, S), dtype=torch.float32, device=dev)
    argm = torch.empty((B, S), dtype=torch.int32, device=dev)
    n_tiles = -(-S // ts)
    starts = torch.empty((B, n_tiles), dtype=torch.int32, device=dev)
    n_chunk, chunk = _slab_plan(window)
    plan = (B, n_tiles, ts, n_chunk)
    if plan not in index.scratch:
        index.scratch[plan] = (
            torch.empty(plan, dtype=torch.int64, device=dev),
            torch.zeros((B, n_tiles), dtype=torch.int32, device=dev),
        )
    part, tickets = index.scratch[plan]
    cuda_lib.check_operands(src, index.lut, index.lo, index.inv_h, part,
                            tickets, d2, argm, starts, aligned=(index.tgt8, qn))
    with torch.cuda.device(src.device):
        MATCH_SLAB.launch(
            src.data_ptr(), B, S, index.tgt8.data_ptr(), index.padded_T,
            index.lut.data_ptr(), index.lo.data_ptr(), index.inv_h.data_ptr(),
            margin, ts, window, n_chunk, chunk, part.data_ptr(),
            tickets.data_ptr(), qn.data_ptr(), d2.data_ptr(), argm.data_ptr(),
            starts.data_ptr(), cuda_lib.stream(src),
        )
    return qn, d2, argm, starts


def _slab_query(src, index: SlabIndex, ts: int, window: int, margin: float,
                call=None):
    """``(qn (..., S, 8), d2 (..., S), idx (..., S) int32, starts (...,
    tiles) int32)`` for a (S, 3) source against a one-lane index or a
    (B, S, 3) source against a B-lane index; ``call`` defaults to the kernel
    for CUDA tensors and the plain version for CPU tensors."""
    if src.dim() == 2:
        return tuple(x[0] for x in _slab_query(src[None], index, ts, window,
                                               margin, call))
    ts = min(ts, max(8, src.shape[1]))
    window = min(window, index.padded_T)
    if call is None:
        call = (_slab_query_cuda if cuda_lib.use_kernel(src)
                else _slab_query_plain)
    return call(src, index, ts, window, margin)


def _nn1_slab(src, tgt, tgt_mask, ts, window, margin, call):
    index = _build_slab_index(tgt, tgt_mask, None)
    _, d2, argm, _ = _slab_query(src, index, ts, window, margin, call)
    return torch.clamp(argm, max=tgt.shape[-2] - 1), d2


def _match_slab(src, tgt, tgt_mask, tgt_normals, ts, window, margin, call):
    index = _build_slab_index(tgt, tgt_mask, tgt_normals)
    qn, d2, _, _ = _slab_query(src, index, ts, window, margin, call)
    return qn[..., 0:3], qn[..., 3:6], d2


def nn1_slab(src, tgt, tgt_mask, ts: int = 256, window: int = 4096,
             margin: float = 3.0):
    """Slab-windowed 1-NN (K1; contract of ``nn1_slab_pallas``), one lane
    ((S, 3) against (T, 3)) or B lanes in one launch ((B, S, 3) against
    (B, T, 3)): ``(idx (..., S) int32 clamped to T-1, dist2 (..., S))``."""
    return _nn1_slab(src, tgt, tgt_mask, ts, window, margin, None)


def nn1_slab_torch(src, tgt, tgt_mask, ts: int = 256, window: int = 4096,
                   margin: float = 3.0):
    """Plain version of :func:`nn1_slab`."""
    return _nn1_slab(src, tgt, tgt_mask, ts, window, margin, _slab_query_plain)


def match_slab(src, tgt, tgt_mask, tgt_normals, ts: int = 256,
               window: int = 4096, margin: float = 3.0):
    """Fused slab 1-NN + gather (K1; contract of ``match_slab_pallas``), one
    lane or B lanes in one launch (the JAX kernel under ``vmap``):
    ``(matched (..., S, 3), normals (..., S, 3), dist2 (..., S))``."""
    return _match_slab(src, tgt, tgt_mask, tgt_normals, ts, window, margin,
                       None)


def match_slab_torch(src, tgt, tgt_mask, tgt_normals, ts: int = 256,
                     window: int = 4096, margin: float = 3.0):
    """Plain version of :func:`match_slab`."""
    return _match_slab(src, tgt, tgt_mask, tgt_normals, ts, window, margin,
                       _slab_query_plain)


class SlabBackend:
    """Injectable ICP backend around K1 (``make_slab_pallas_backend``).

    ``__call__`` is the plain ``nn1_fn`` contract; ``prepare_match`` is
    ops/icp.py's fused protocol: the index is built once per ICP call and
    each iteration is one kernel launch (window starts included)."""

    def __init__(self, ts: int = 256, window: int = 4096, margin: float = 3.0):
        self.ts, self.window, self.margin = ts, window, margin

    def __call__(self, s, t, m):
        return nn1_slab(s, t, m, self.ts, self.window, self.margin)

    def prepare_match(self, tgt_pts, tgt_mask, tgt_normals):
        """Targets (T, 3) or (B, T, 3) -> ``q(cur)`` with the same leading
        dims: every query is one launch for all lanes."""
        index = _build_slab_index(tgt_pts, tgt_mask, tgt_normals)

        def q(cur):
            qn, d2, _, _ = _slab_query(cur, index, self.ts, self.window,
                                       self.margin)
            return qn[..., 0:3], qn[..., 3:6], d2

        return q
