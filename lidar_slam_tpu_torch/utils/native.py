"""ctypes binding of the repository's native host voxelizer
(``native/ply_io.cpp``), without the JAX package.

``voxel_downsample_host`` is the host prep of the main path: centroid per
0.5 m voxel, emitted in ascending voxel-key (x-major) order — the order the
slab searches and the slab normals rely on — and strided when over
capacity. The library is built with ``make -C native`` on first use. There
is no NumPy fallback: if the build or the load fails, this raises.
"""

from __future__ import annotations

import ctypes
import subprocess
from pathlib import Path

import numpy as np

NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
LIB_PATH = NATIVE_DIR / "liblidar_native.so"

_lib = None


def get_lib() -> ctypes.CDLL:
    """Build (``make`` is a no-op when the library is fresh) and load."""
    global _lib
    if _lib is not None:
        return _lib
    proc = subprocess.run(["make", "-C", str(NATIVE_DIR)], capture_output=True,
                          text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(
            f"building the native library failed:\n{proc.stdout}{proc.stderr}"
        )
    lib = ctypes.CDLL(str(LIB_PATH))
    fp = ctypes.POINTER(ctypes.c_float)
    lib.lidar_voxel_downsample.restype = ctypes.c_long
    lib.lidar_voxel_downsample.argtypes = [
        fp, ctypes.c_long, ctypes.c_float, fp, ctypes.c_long,
    ]
    _lib = lib
    return lib


def voxel_downsample_host(pts: np.ndarray, voxel: float,
                          cap: int = 1 << 18) -> np.ndarray:
    """Voxel-grid centroid downsample of (n, 3) points, at most ``cap``
    voxels, in voxel-key order."""
    lib = get_lib()
    pts = np.ascontiguousarray(pts, np.float32)
    out = np.empty((min(cap, len(pts) or 1), 3), np.float32)
    fp = ctypes.POINTER(ctypes.c_float)
    n = lib.lidar_voxel_downsample(
        pts.ctypes.data_as(fp), len(pts), ctypes.c_float(voxel),
        out.ctypes.data_as(fp), len(out),
    )
    if n < 0:
        raise RuntimeError(f"lidar_voxel_downsample failed ({n})")
    return out[:n]
