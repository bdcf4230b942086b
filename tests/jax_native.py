"""Makes a test that holds the port against the JAX package run the JAX
side on its native library.

Without ``native/liblidar_native.so`` the JAX package changes course without
a word: its ``FrameLoader`` reads and voxelizes with NumPy and its command
line drops host normals for the device's radius normals, so a comparison
with the port (which only runs the native library) fails far from the cause,
with trajectories metres apart. The JAX loader tries to load the library
once per process (``lidar_slam_tpu.utils.native._tried``) and keeps a
failure for good; under ``make -C native`` run by several test processes at
once that first try can meet a library that another process is still
linking in place.

``require_jax_native`` waits for the port's own locked build, re-arms the
JAX loader's one-shot latch and loads again until the library is there
(another process's ``make`` may still be linking), and fails with a message
that names the NumPy fallback when it never comes. Test files that compare
with the JAX loader or command line import the ``jax_native`` fixture
(autouse, module scope)."""

import time

import pytest

from lidar_slam_tpu.utils import native as jnative
from lidar_slam_tpu_torch.utils import native

FALLBACK = (
    "the JAX package's native library (native/liblidar_native.so) did not "
    "load, so its FrameLoader would take the NumPy fallback (and its command "
    "line would drop host normals): a comparison with the port would compare "
    "two different paths"
)


def require_jax_native(mp: pytest.MonkeyPatch, timeout: float = 30.0) -> None:
    native.get_lib()
    deadline = time.monotonic() + timeout
    while True:
        mp.setattr(jnative, "_tried", False)
        mp.setattr(jnative, "_lib", None)
        try:
            if jnative.get_lib() is not None:
                return
        except AttributeError:  # a library still being linked lacks symbols
            pass
        if time.monotonic() >= deadline:
            pytest.fail(FALLBACK)
        time.sleep(0.5)


@pytest.fixture(scope="module", autouse=True)
def jax_native():
    with pytest.MonkeyPatch.context() as mp:
        require_jax_native(mp)
        yield
