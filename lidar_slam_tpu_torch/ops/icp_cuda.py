"""The ICP's Gauss-Newton iteration as one CUDA kernel, with its glue.

``icp_step`` (``lidar_slam_tpu_torch/csrc/icp_step.cu``) replaces no Pallas
kernel: it fuses the body of the JAX package's ICP while-loop
(``lidar_slam_tpu/ops/icp.py:196-219``) after the correspondence search,
which ``ops/icp.py`` otherwise runs as eager ATen operations: the plane
error, the convergence test, the normal equations, the 6 x 6 solve, the
SE(3) update and the loop's bookkeeping, for every lane in one launch. Its
modes (:data:`MODES`) are one launch each:

- ``apply``: ``cur = T src`` for every lane (the query of the next search);
- ``coarse``: one coarse warm-start pass, every lane composes;
- ``step``: one loop iteration, updating :class:`IcpState` in place and
  writing ``flags = [any lane active, any lane needing a final pass]``;
- ``final``: the final error of the lanes that need the final pass (or,
  for a state without a loop, the plane error of every lane).

The matched rows come either row-aligned (K1's packed output, read through
its strides) or as an int32 index into the targets (K2), which the kernel
gathers itself. :func:`launch` checks its operands and launches for CUDA
tensors; the plain version of the same contract is
``ops/icp.py:icp_step_torch``. ``cuda_lib`` builds and loads the kernel's
library on first use (:data:`LIBRARY`); the kernel counts its launches
(``ICP_STEP.launches``).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from . import cuda_lib

MODES = {"apply": 0, "coarse": 1, "step": 2, "final": 3}
BLOCK_ROWS = 1024   # source rows a block (BLOCK_ROWS in icp_step.cu)
PART = 32           # floats of a block's partial sums (PART in icp_step.cu)


class IcpStepArgs(ctypes.Structure):
    """``struct IcpStepArgs`` of ``icp_step.cu``, field for field."""

    _fields_ = [
        ("mode", ctypes.c_int), ("lanes", ctypes.c_int), ("rows", ctypes.c_int),
        ("max_it", ctypes.c_int), ("hist_len", ctypes.c_int),
        ("damping", ctypes.c_float), ("min_error", ctypes.c_float),
        ("tolerance", ctypes.c_float),
        ("src", ctypes.c_void_p), ("src_lane", ctypes.c_longlong),
        ("cur", ctypes.c_void_p),
        ("mask", ctypes.c_void_p), ("mask_lane", ctypes.c_longlong),
        ("pts", ctypes.c_void_p), ("pts_lane", ctypes.c_longlong),
        ("pts_row", ctypes.c_longlong),
        ("nrm", ctypes.c_void_p), ("nrm_lane", ctypes.c_longlong),
        ("nrm_row", ctypes.c_longlong),
        ("idx", ctypes.c_void_p),
        ("T", ctypes.c_void_p), ("it", ctypes.c_void_p),
        ("prev_err", ctypes.c_void_p), ("converged", ctypes.c_void_p),
        ("hist", ctypes.c_void_p), ("err_out", ctypes.c_void_p),
        ("part", ctypes.c_void_p), ("tickets", ctypes.c_void_p),
        ("flags", ctypes.c_void_p),
    ]


LIBRARY = cuda_lib.Library("icp_step.cu", "libicp_step", {
    "lst_icp_step": ([ctypes.POINTER(IcpStepArgs), ctypes.c_void_p],
                     ctypes.c_int),
})
ICP_STEP = cuda_lib.CudaKernel(
    "icp_step", "lst_icp_step",
    "lidar_slam_tpu/ops/icp.py:196 (the while-loop body; no Pallas kernel)",
    LIBRARY,
)
KERNELS = (ICP_STEP,)


@dataclass
class IcpState:
    """One ICP call's state, which every ``icp_step`` launch (or its plain
    version) updates in place: the lanes' transforms and, for the loop,
    iteration counts, last errors, convergence, error history; ``err`` is
    ``final``'s output, ``flags`` ``step``'s. ``ticks`` (B + 3 int32, zero)
    holds the kernel's B + 1 ticket counters, then ``flags``; ``part`` is
    its scratch of partial sums, grown to the largest row count used."""

    T: torch.Tensor                     # (B, 4, 4)
    err: torch.Tensor                   # (B,)
    ticks: torch.Tensor                 # (B + 3,) int32
    damping: float
    it: torch.Tensor | None = None      # (B,) int32
    prev_err: torch.Tensor | None = None
    converged: torch.Tensor | None = None
    hist: torch.Tensor | None = None    # (B, max_it + 1)
    max_it: int = 0
    min_error: float = 0.0
    tolerance: float = 0.0
    part: torch.Tensor | None = None
    args: IcpStepArgs | None = None

    @property
    def flags(self) -> torch.Tensor:
        return self.ticks[-2:]


def new_state(T: torch.Tensor, damping: float, converged=None, max_it=0,
              min_error=0.0, tolerance=0.0) -> IcpState:
    """The state for transforms ``T`` (B, 4, 4), which it owns from now on;
    with ``converged`` (B,) bool also the loop's (``max_it`` iterations at
    most, stopping at ``min_error`` or a change below ``tolerance``)."""
    B, dev = T.shape[0], T.device
    st = IcpState(T, torch.empty((B,), dtype=T.dtype, device=dev),
                  torch.zeros((B + 3,), dtype=torch.int32, device=dev),
                  float(damping))
    if converged is not None:
        st.it = torch.zeros((B,), dtype=torch.int32, device=dev)
        st.prev_err = torch.full((B,), float("inf"), dtype=T.dtype, device=dev)
        st.converged = converged
        st.hist = torch.zeros((B, max_it + 1), dtype=T.dtype, device=dev)
        st.max_it, st.min_error, st.tolerance = max_it, min_error, tolerance
    return st


def _check(dev, *tensors, dtype=torch.float32) -> None:
    for t in tensors:
        if t.device != dev or t.dtype != dtype:
            raise ValueError(f"icp_step takes {dtype} operands on {dev} "
                             f"(got {t.dtype} on {t.device})")


def _bind(st: IcpState) -> IcpStepArgs:
    """The launch's argument block with the state's pointers, built once."""
    dev = st.T.device
    _check(dev, st.T, st.err)
    _check(dev, st.ticks, dtype=torch.int32)
    if st.it is not None:
        _check(dev, st.prev_err, st.hist)
        _check(dev, st.it, dtype=torch.int32)
        _check(dev, st.converged, dtype=torch.bool)
    state = (st.T, st.err, st.ticks, st.it, st.prev_err, st.converged, st.hist)
    if not all(t is None or t.is_contiguous() for t in state):
        raise ValueError("icp_step: the state's tensors must be contiguous")

    def ptr(t):
        return None if t is None else t.data_ptr()

    return IcpStepArgs(
        lanes=st.T.shape[0], max_it=st.max_it,
        hist_len=0 if st.hist is None else st.hist.shape[1],
        damping=st.damping, min_error=st.min_error, tolerance=st.tolerance,
        T=ptr(st.T), it=ptr(st.it), prev_err=ptr(st.prev_err),
        converged=ptr(st.converged), hist=ptr(st.hist), err_out=ptr(st.err),
        tickets=ptr(st.ticks), flags=ptr(st.flags))


def launch(mode: str, st: IcpState, cur: torch.Tensor, src=None, mask=None,
           match=None) -> None:
    """One ``icp_step`` launch in ``mode`` on the card; the contract of
    ``ops/icp.py:icp_step_torch``. ``cur`` (B, N, 3) contiguous; ``apply``
    reads ``src`` (B, N, 3), rows of 3 floats, any lane stride; the other
    modes read ``mask`` (B, N) bool and ``match = (pts, nrm, idx)``: the
    matched points and normals row-aligned with ``cur`` (``idx`` None; any
    lane and row strides) or the targets and their normals gathered at
    ``idx`` (B, N) int32. Everything float32 on ``cur``'s card, or it
    raises."""
    if not cur.is_cuda:
        raise ValueError("icp_step launches on CUDA tensors only")
    if st.args is None:
        st.args = _bind(st)
    a, dev = st.args, cur.device
    B, N = cur.shape[0], cur.shape[1]
    if st.T.device != dev or cur.shape != (B, N, 3) or B != a.lanes \
            or not cur.is_contiguous():
        raise ValueError("icp_step: cur must be (lanes, N, 3), contiguous, "
                         "on the state's card")
    _check(dev, cur)
    a.mode, a.rows, a.cur = MODES[mode], N, cur.data_ptr()
    if mode == "apply":
        _check(dev, src)
        if src.shape != cur.shape or src.stride()[1:] != (3, 1):
            raise ValueError("icp_step: src must be (lanes, N, 3) rows")
        a.src, a.src_lane = src.data_ptr(), src.stride(0)
    else:
        pts, nrm, idx = match
        _check(dev, pts, nrm)
        _check(dev, mask, dtype=torch.bool)
        if mask.shape != (B, N) or mask.stride(1) != 1 or \
                pts.shape[0] != B or nrm.shape[0] != B or \
                pts.shape[-1] != 3 or nrm.shape[-1] != 3 or \
                pts.stride(-1) != 1 or nrm.stride(-1) != 1:
            raise ValueError("icp_step: mask (lanes, N) and matched rows "
                             "(lanes, rows, 3) with unit column strides")
        if idx is None:
            if pts.shape[1] != N or nrm.shape[1] != N:
                raise ValueError("icp_step: row-aligned matches of N rows")
            a.idx = None
        else:
            _check(dev, idx, dtype=torch.int32)
            if idx.shape != (B, N) or not idx.is_contiguous() \
                    or pts.shape[1] != nrm.shape[1]:
                raise ValueError("icp_step: a (lanes, N) contiguous index "
                                 "into targets with their normals")
            a.idx = idx.data_ptr()
        a.mask, a.mask_lane = mask.data_ptr(), mask.stride(0)
        a.pts, a.pts_lane, a.pts_row = pts.data_ptr(), pts.stride(0), pts.stride(1)
        a.nrm, a.nrm_lane, a.nrm_row = nrm.data_ptr(), nrm.stride(0), nrm.stride(1)
        need = B * (-(-N // BLOCK_ROWS)) * PART
        if st.part is None or st.part.numel() < need:
            st.part = torch.empty((need,), dtype=torch.float32, device=dev)
            a.part = st.part.data_ptr()
    with torch.cuda.device(dev):
        ICP_STEP.launch(ctypes.pointer(a), cuda_lib.stream(cur))
