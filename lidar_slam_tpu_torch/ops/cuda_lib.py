"""Building, loading and launching the package's hand-written CUDA kernels.

A kernel module (``knn_cuda``, ``icp_cuda``, ``knn_topk_cuda``) states its
source under ``csrc/`` and its symbols' signatures as a :class:`Library`,
and its kernels as :class:`CudaKernel` objects. On first use a library is
compiled with ``nvcc`` for ``sm_90a`` into ``build/kernels/`` (keyed on a
hash of the source and the flags) and loaded with ctypes. Each kernel
counts its launches and traces each as a ``launch`` span.

The device rule is :func:`use_kernel`: CUDA tensors take the kernel, CPU
tensors its plain PyTorch version, any other device raises; nothing falls
back from one to the other.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from ..utils import tracing

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = CSRC.parents[1] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


class Library:
    """The shared library of one source under ``csrc/``, built and loaded on
    first use, each symbol's ``(argtypes, restype)`` in ``signatures``
    applied once. ``build_log`` is nvcc's output where this process built
    it (empty where it loaded a library built before)."""

    def __init__(self, source: str, stem: str, signatures: dict):
        self.source = CSRC / source
        self.stem = stem
        self.signatures = signatures
        self.build_log = ""
        self._lib = None

    @property
    def path(self) -> Path:
        """Where the library lives: keyed on the source and the flags."""
        h = hashlib.sha256(self.source.read_bytes())
        h.update(" ".join(NVCC_FLAGS).encode())
        return BUILD_DIR / f"{self.stem}_{h.hexdigest()[:16]}.so"

    def load(self) -> ctypes.CDLL:
        """Compile the source with nvcc into ``build/kernels/`` (once per
        source and flags; temp name + ``os.replace``) and load it."""
        if self._lib is not None:
            return self._lib
        so = self.path
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            proc = subprocess.run(
                [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)],
                capture_output=True, text=True,
            )
            self.build_log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}):\n{self.build_log}")
            os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
        for name, (argtypes, restype) in self.signatures.items():
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = argtypes, restype
        self._lib = lib
        return lib


class CudaKernel:
    """One hand-written kernel: its C entry point ``symbol`` in ``library``
    and its launch count."""

    def __init__(self, name: str, symbol: str, replaces: str,
                 library: Library):
        self.name = name
        self.symbol = symbol
        self.replaces = replaces
        self.library = library
        self.launches = 0

    def launch(self, *args) -> None:
        fn = getattr(self.library.load(), self.symbol)
        with tracing.launching(self.name):
            rc = fn(*args)
        if rc != 0:
            raise RuntimeError(f"{self.name} launch failed: cudaError {rc}")
        self.launches += 1


def stream(t: torch.Tensor) -> int:
    """The handle of the current stream on ``t``'s card."""
    return torch.cuda.current_stream(t.device).cuda_stream


def check_operands(*tensors: torch.Tensor, aligned=()) -> None:
    """Raise unless every tensor is contiguous on one card, and those in
    ``aligned`` (read or written as ``float4``) are 16-byte aligned."""
    dev = tensors[0].device
    for t in tensors + tuple(aligned):
        if not t.is_cuda or t.device != dev or not t.is_contiguous():
            raise ValueError("kernel operands must be contiguous, on one GPU")
    for t in aligned:
        if t.data_ptr() % 16:
            raise ValueError("packed rows must be 16-byte aligned")


def use_kernel(t: torch.Tensor) -> bool:
    """The device rule: True for a CUDA tensor (run the kernel), False for a
    CPU tensor (run its plain version); raises for any other device."""
    if t.is_cuda:
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {t.device}")
