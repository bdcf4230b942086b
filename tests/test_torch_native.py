"""The native host library under concurrency, and the guard that keeps the
JAX side of the comparison tests on it.

The port builds ``native/ply_io.cpp`` into ``build/native/`` under a file
lock and moves the finished file into place, so processes that start at once
never load a half-written library. The JAX package links
``native/liblidar_native.so`` in place with ``make`` and falls back to NumPy
for good when its one load fails; ``jax_native.require_jax_native`` (used by
every test that compares the port with the JAX loader or command line) must
then fail by name."""

import ctypes
import os
import re
import subprocess
import sys
import time

import numpy as np
import pytest

from lidar_slam_tpu.utils import native as jnative
from lidar_slam_tpu_torch.utils import native

from jax_native import FALLBACK, require_jax_native

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_PROCS = 4

# each process waits for the common start time, builds, loads, voxelizes
_CHILD = """
import ctypes, sys, time
import numpy as np
from pathlib import Path
from lidar_slam_tpu_torch.utils import native
t0, build = float(sys.argv[1]), Path(sys.argv[2])
while time.time() < t0:
    pass
so = native.build_library(build)
lib = ctypes.CDLL(str(so))
fp = ctypes.POINTER(ctypes.c_float)
lib.lidar_voxel_downsample.restype = ctypes.c_long
lib.lidar_voxel_downsample.argtypes = [fp, ctypes.c_long, ctypes.c_float, fp,
                                       ctypes.c_long]
pts = np.random.default_rng(0).normal(size=(5000, 3)).astype(np.float32) * 5
out = np.empty((5000, 3), np.float32)
n = lib.lidar_voxel_downsample(pts.ctypes.data_as(fp), 5000, 1.0,
                               out.ctypes.data_as(fp), 5000)
print(so.name, n, float(out[:n].sum()))
"""


def test_concurrent_builds_all_load_a_whole_library(tmp_path):
    """N processes start the build at once from an empty build directory:
    every one loads a complete library and computes the same result, and
    one file is left, with no temporary beside it."""
    build = tmp_path / "build"
    t0 = time.time() + 3.0
    procs = [subprocess.Popen([sys.executable, "-c", _CHILD, str(t0), str(build)],
                              cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(N_PROCS)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
    lines = {out.strip() for out, _ in outs}
    assert len(lines) == 1, lines
    name, n, _ = lines.pop().split()
    assert int(n) > 100
    assert sorted(os.listdir(build)) == [".build.lock", name]
    assert name == native.library_path(build).name


def test_build_flags_are_the_makefile_s():
    with open(os.path.join(REPO, "native", "Makefile")) as f:
        text = f.read()
    flags = re.search(r"^CXXFLAGS \?= (.*)$", text, re.M).group(1).split()
    assert tuple(flags) == native.CXXFLAGS
    assert "-shared -o $@ $< -lpthread" in text


def test_port_library_matches_the_jax_binding(rng, monkeypatch):
    """The port's build and the JAX package's ``make`` build of the same
    source voxelize identically."""
    require_jax_native(monkeypatch)
    pts = rng.normal(size=(4000, 3)).astype(np.float32) * 10
    np.testing.assert_array_equal(native.voxel_downsample_host(pts, 0.7, 4000),
                                  jnative.voxel_downsample_host(pts, 0.7, 4000))
    assert isinstance(native.get_lib(), ctypes.CDLL)


def test_forced_numpy_fallback_fails_by_name(monkeypatch):
    """With the JAX library switched off, the JAX loader quietly takes the
    NumPy path; the guard refuses that with a message that names it."""
    monkeypatch.setenv("LIDAR_SLAM_NO_NATIVE", "1")
    monkeypatch.setattr(jnative, "_tried", False)
    monkeypatch.setattr(jnative, "_lib", None)
    assert jnative.get_lib() is None
    with pytest.raises(pytest.fail.Exception) as e:
        require_jax_native(monkeypatch, timeout=1.0)
    assert "NumPy fallback" in str(e.value) and str(e.value) == FALLBACK
