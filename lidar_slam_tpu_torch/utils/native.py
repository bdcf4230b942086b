"""ctypes binding of the repository's native host runtime
(``native/ply_io.cpp``), without the JAX package.

- ``voxel_downsample_host`` is the host prep of the main path: centroid per
  0.5 m voxel, emitted in ascending voxel-key (x-major) order — the order
  the slab searches and the slab normals rely on — and strided when over
  capacity.
- ``load_scan_native`` reads one ``.ply``/``.bin`` frame.
- ``FrameLoader`` is the readahead loader the command line runs: worker
  threads read (and, when asked, voxelize and estimate radius normals for)
  the next ``window`` frames while the device works on the current one.
- ``normals_radius_host`` computes radius normals for one cloud.

The library is built on first use from ``native/ply_io.cpp`` with the flags
of ``native/Makefile``, into ``build/native/`` under a name keyed on a hash
of the source and the flags. Several processes may start at once (test
workers, a fresh checkout): the build runs under an exclusive file lock and
links to a temporary name that ``os.replace`` moves into place, so no
process ever loads a library another one is still writing. The in-tree
``native/liblidar_native.so`` that ``make`` links in place is never loaded
here. There is no NumPy fallback: if the build or the load fails, or a frame
cannot be read, this raises.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
from pathlib import Path
from typing import List

import numpy as np

NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
SOURCE = NATIVE_DIR / "ply_io.cpp"
BUILD_DIR = NATIVE_DIR.parent / "build" / "native"
# the compile line of native/Makefile: $(CXX) $(CXXFLAGS) -shared -o $@ $< -lpthread
CXX = "g++"
CXXFLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra")

_lib = None
_FP = ctypes.POINTER(ctypes.c_float)


def library_path(build_dir: Path = BUILD_DIR) -> Path:
    """Where the library for the current source and flags lives."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join((CXX, *CXXFLAGS)).encode())
    return Path(build_dir) / f"liblidar_native_{h.hexdigest()[:16]}.so"


def build_library(build_dir: Path = BUILD_DIR) -> Path:
    """Build the library into ``build_dir`` unless it is there; returns its
    path. Safe to call from many processes at once: one builds under the
    lock, the others wait for it and find the finished file."""
    so = library_path(build_dir)
    if so.exists():
        return so
    so.parent.mkdir(parents=True, exist_ok=True)
    with open(so.parent / ".build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not so.exists():
            tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
            proc = subprocess.run(
                [CXX, *CXXFLAGS, "-shared", "-o", str(tmp), str(SOURCE),
                 "-lpthread"],
                capture_output=True, text=True, timeout=600,
            )
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError("building the native library failed:\n"
                                   f"{proc.stdout}{proc.stderr}")
            os.replace(tmp, so)
    return so


def get_lib() -> ctypes.CDLL:
    """Build (once per source hash, see :func:`build_library`) and load."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build_library()))
    fp, c_long, c_int, c_float = _FP, ctypes.c_long, ctypes.c_int, ctypes.c_float
    lib.lidar_voxel_downsample.restype = c_long
    lib.lidar_voxel_downsample.argtypes = [fp, c_long, c_float, fp, c_long]
    for fn in (lib.lidar_load_ply, lib.lidar_load_bin):
        fn.restype = c_long
        fn.argtypes = [ctypes.c_char_p, fp, c_long]
    lib.lidar_normals_radius.restype = None
    lib.lidar_normals_radius.argtypes = [fp, c_long, c_float, fp]
    lib.lidar_prefetch_create_v3.restype = ctypes.c_void_p
    lib.lidar_prefetch_create_v3.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), c_int, c_long, c_int, c_int, c_float,
        c_long, c_float, c_long, c_long,
    ]
    lib.lidar_prefetch_get.restype = c_long
    lib.lidar_prefetch_get.argtypes = [ctypes.c_void_p, c_long, fp]
    lib.lidar_prefetch_get_full.restype = c_long
    lib.lidar_prefetch_get_full.argtypes = [ctypes.c_void_p, c_long, fp, fp]
    lib.lidar_prefetch_destroy.restype = None
    lib.lidar_prefetch_destroy.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


def voxel_downsample_host(pts: np.ndarray, voxel: float,
                          cap: int = 1 << 18) -> np.ndarray:
    """Voxel-grid centroid downsample of (n, 3) points, at most ``cap``
    voxels, in voxel-key order."""
    lib = get_lib()
    pts = np.ascontiguousarray(pts, np.float32)
    out = np.empty((min(cap, len(pts) or 1), 3), np.float32)
    n = lib.lidar_voxel_downsample(
        pts.ctypes.data_as(_FP), len(pts), ctypes.c_float(voxel),
        out.ctypes.data_as(_FP), len(out),
    )
    if n < 0:
        raise RuntimeError(f"lidar_voxel_downsample failed ({n})")
    return out[:n]


def load_scan_native(path: str, cap: int = 1 << 18) -> np.ndarray:
    """Read a ``.ply``/``.bin`` scan with the native parser: the first
    ``cap`` points as (n, 3) float32."""
    lib = get_lib()
    out = np.empty((cap, 3), np.float32)
    fn = lib.lidar_load_bin if path.endswith(".bin") else lib.lidar_load_ply
    n = fn(path.encode(), out.ctypes.data_as(_FP), cap)
    if n < 0:
        raise RuntimeError(f"reading {path} failed ({n})")
    return out[:n]


def normals_radius_host(pts: np.ndarray, radius: float) -> np.ndarray:
    """Radius-neighbourhood PCA normals of (n, 3) points, on the host."""
    lib = get_lib()
    pts = np.ascontiguousarray(pts, np.float32)
    out = np.empty_like(pts)
    lib.lidar_normals_radius(pts.ctypes.data_as(_FP), len(pts),
                             ctypes.c_float(radius), out.ctypes.data_as(_FP))
    return out


class FrameLoader:
    """Asynchronous readahead frame loader over the native prefetcher.

    Overlaps disk I/O, parsing and (``voxel > 0``) voxelization with device
    compute. ``cap``: most points handed out per frame; ``raw_cap``: most
    raw points read before voxelization (default ``cap``);
    ``normals_radius > 0``: the workers also estimate radius normals, read
    with :meth:`get_with_normals`; ``start``: first frame that will be
    requested (checkpoint resume): the workers begin prefetching there, so
    ``get(start)`` does not wait behind ``window`` frames nobody consumes.
    Frames must be requested in ascending order. A frame that cannot be read
    raises ``RuntimeError`` naming its path.
    """

    def __init__(self, paths: List[str], cap: int = 1 << 18, window: int = 8,
                 threads: int = 2, voxel: float = 0.0, raw_cap: int = 0,
                 normals_radius: float = 0.0, start: int = 0):
        self._handle = None
        self.paths = list(paths)
        self.cap = cap
        self.voxel = voxel
        self.normals_radius = normals_radius
        self._lib = get_lib()
        if self.paths:
            arr = (ctypes.c_char_p * len(self.paths))(
                *[p.encode() for p in self.paths]
            )
            self._handle = self._lib.lidar_prefetch_create_v3(
                arr, len(self.paths), cap, window, threads,
                ctypes.c_float(voxel), raw_cap or cap,
                ctypes.c_float(normals_radius), start, 0,
            )
            if not self._handle:
                raise RuntimeError("lidar_prefetch_create_v3 returned no handle")

    def _check(self, n: int, frame: int) -> None:
        if n < 0:
            raise RuntimeError(
                f"reading frame {frame} ({self.paths[frame]}) failed ({n})"
            )

    def _open(self, frame: int):
        if self._handle is None:
            raise ValueError("the loader is closed or has no frames")
        if not 0 <= frame < len(self.paths):
            raise IndexError(f"frame {frame} of {len(self.paths)}")
        return self._handle

    def get(self, frame: int) -> np.ndarray:
        """Points of ``frame``, (n, 3) float32, n <= ``cap``."""
        handle = self._open(frame)
        out = np.empty((self.cap, 3), np.float32)
        n = self._lib.lidar_prefetch_get(handle, frame, out.ctypes.data_as(_FP))
        self._check(n, frame)
        return out[:n]

    def get_with_normals(self, frame: int):
        """``(points, normals)`` of ``frame``; needs ``normals_radius > 0``."""
        if self.normals_radius <= 0:
            raise ValueError("the loader was created without normals_radius")
        handle = self._open(frame)
        out = np.empty((self.cap, 3), np.float32)
        nrm = np.empty((self.cap, 3), np.float32)
        n = self._lib.lidar_prefetch_get_full(
            handle, frame, out.ctypes.data_as(_FP), nrm.ctypes.data_as(_FP)
        )
        self._check(n, frame)
        return out[:n], nrm[:n]

    def close(self) -> None:
        if self._handle is not None:
            self._lib.lidar_prefetch_destroy(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        self.close()
