"""Device meshes (port of ``lidar_slam_tpu/parallel/mesh.py``).

The JAX package is single-controller: one process issues a ``shard_map``
over a ``jax.sharding.Mesh`` and gets replicated results back. The port keeps
that shape without ``torch.distributed``: one process, a mesh that is a grid
of ``torch.device``s, tensors placed on its devices, and every "collective"
done as ``.to(device)`` copies plus a reduction on the caller's device (peer
copies between cards, no-ops within one). A device may appear several
times, so one card, or the CPU, can host every shard of a mesh: the port's
counterpart of the JAX tests' 8 virtual CPU devices.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def _device(d) -> torch.device:
    """A ``torch.device`` as tensors report it: a CUDA device with an
    index."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        idx = torch.cuda.current_device() if torch.cuda.is_available() else 0
        d = torch.device("cuda", idx)
    return d


class Mesh:
    """A named grid of devices: ``devices`` is an object ndarray of
    ``torch.device`` shaped by the axes, ``axis_names`` their names and
    ``shape`` the ordered name -> size mapping (as ``jax.sharding.Mesh``)."""

    def __init__(self, devices: np.ndarray, axis_names):
        self.devices = devices
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"a {self.devices.ndim}-D device grid needs as "
                             f"many axis names, got {self.axis_names}")

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def axis_devices(self, axis: str, near=None) -> list:
        """The devices along ``axis`` of one row of the mesh (every other
        axis fixed): the first row that holds device ``near``, else the
        first row. A lane on its ``seq`` group's device so finds its own
        row of ``pts`` devices."""
        if axis not in self.axis_names:
            raise ValueError(f"mesh axes {self.axis_names} have no {axis!r}")
        k = self.axis_names.index(axis)
        rows = np.moveaxis(self.devices, k, -1).reshape(-1, self.devices.shape[k])
        if near is not None:
            near = _device(near)
            for row in rows:
                if near in list(row):
                    return list(row)
        return list(rows[0])


def make_mesh(axis_sizes: dict | None = None, devices=None) -> Mesh:
    """Build a mesh over ``devices`` (default: every CUDA card).

    Default factorization, as in the JAX package: n devices -> ``("seq",
    "pts")`` with ``pts`` the largest power of two <= sqrt(n) that divides n.
    ``devices`` may repeat a device (``["cpu"] * 8`` on the CPU, ``["cuda:0"]
    * 4`` on one card). Without CUDA and without ``devices`` it raises: the
    mesh never falls back to the CPU."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh builds a mesh over the CUDA cards by default and "
                "CUDA is not available; pass devices= (for example "
                "devices=['cpu'] * 8) to build a mesh on the CPU")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devs = [_device(d) for d in devices]
    n = len(devs)
    if axis_sizes is None:
        pts = 1
        while pts * 2 <= max(math.isqrt(n), 1) and n % (pts * 2) == 0:
            pts *= 2
        axis_sizes = {"seq": n // pts, "pts": pts}
    shape = tuple(axis_sizes.values())
    if math.prod(shape) != n:
        raise ValueError(f"mesh shape {shape} does not hold the {n} devices")
    grid = np.empty(n, dtype=object)
    grid[:] = devs
    return Mesh(grid.reshape(shape), tuple(axis_sizes.keys()))
