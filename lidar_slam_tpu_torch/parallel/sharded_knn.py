"""Sharded nearest-neighbour search (port of
``lidar_slam_tpu/parallel/sharded_knn.py``).

- :func:`nn1_target_sharded`: the target rows split over ``axis``; each
  shard is searched on its own device by K2 (``ops/knn_cuda.nn1``; its
  plain version on CPU tensors), its local indices are offset to global
  ones, and the shards' answers are combined on the source's device: the
  smallest d2 wins and, among equal d2, the smallest global index, which is
  what the JAX package's ``argmin`` over the gathered shards gives.
- :func:`nn1_source_sharded`: the source rows split, the target replicated,
  the answers concatenated on the source's device.
- :func:`make_sharded_nn1`: the target-sharded search as an ``nn1_fn`` for
  ``ops/icp.py``, with its ``prepare`` protocol (each shard's K2 target
  layout is made once per ICP call).

The combine ranks the int64 keys ``(bits(d2) << 32) | index``
(``ops/knn._keys``), so its answer is the unsharded search's bit for bit.
"""

from __future__ import annotations

import torch

from ..ops import knn_cuda
from ..ops.knn import _keys
from .mesh import Mesh


def _split(n: int, nshards: int, what: str) -> int:
    if n % nshards:
        raise ValueError(f"{n} {what} rows do not split over {nshards} shards")
    return n // nshards


def _combine(parts: list, size: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-shard ``(idx, d2)`` -> the global first-index 1-NN on
    ``device``."""
    keys = torch.stack([
        _keys(d2.to(device), idx.to(device).to(torch.int64) + i * size)
        for i, (idx, d2) in enumerate(parts)
    ])
    best = torch.min(keys, dim=0).values
    idx = (best & 0xFFFFFFFF).to(torch.int32)
    d2 = (best >> 32).to(torch.int32).view(torch.float32)
    return idx, d2


def _prepare_target_sharded(tgt: torch.Tensor, tgt_mask: torch.Tensor,
                            mesh: Mesh, axis: str):
    """Lay out each shard's K2 target once, on the ``axis`` devices of the
    mesh row that holds the target's device; ``query(src) -> (idx, d2)``
    searches every shard and combines on the source's device."""
    devices = mesh.axis_devices(axis, near=tgt.device)
    size = _split(tgt.shape[-2], len(devices), "target")
    queries = [
        (dev, knn_cuda.nn1.prepare(tgt[..., i * size:(i + 1) * size, :].to(dev),
                                   tgt_mask[..., i * size:(i + 1) * size].to(dev)))
        for i, dev in enumerate(devices)
    ]

    def query(src: torch.Tensor):
        return _combine([q(src.to(dev)) for dev, q in queries], size, src.device)

    return query


def nn1_target_sharded(src: torch.Tensor, tgt: torch.Tensor,
                       tgt_mask: torch.Tensor, mesh: Mesh, axis: str = "pts"):
    """1-NN with the target rows sharded over ``axis``: the contract of
    ``ops/knn_cuda.nn1`` (leading lane dimensions pass through), the answer
    on the source's device."""
    return _prepare_target_sharded(tgt, tgt_mask, mesh, axis)(src)


def nn1_source_sharded(src: torch.Tensor, tgt: torch.Tensor,
                       tgt_mask: torch.Tensor, mesh: Mesh, axis: str = "pts"):
    """1-NN with the source rows sharded over ``axis`` and the target
    replicated; the answers are concatenated on the source's device."""
    devices = mesh.axis_devices(axis, near=src.device)
    size = _split(src.shape[-2], len(devices), "source")
    idx, d2 = [], []
    for i, dev in enumerate(devices):
        a, b = knn_cuda.nn1(src[..., i * size:(i + 1) * size, :].to(dev),
                            tgt.to(dev), tgt_mask.to(dev))
        idx.append(a.to(src.device))
        d2.append(b.to(src.device))
    return torch.cat(idx, dim=-1), torch.cat(d2, dim=-1)


class ShardedNN1:
    """``nn1_fn`` for ``ops/icp.icp_point_to_plane`` with the target sharded
    over ``axis`` (see :func:`make_sharded_nn1`)."""

    def __init__(self, mesh: Mesh, axis: str = "pts"):
        if axis not in mesh.axis_names:
            raise ValueError(f"mesh axes {mesh.axis_names} have no {axis!r}")
        self.mesh = mesh
        self.axis = axis

    def __call__(self, src, tgt, tgt_mask):
        return nn1_target_sharded(src, tgt, tgt_mask, self.mesh, self.axis)

    def prepare(self, tgt: torch.Tensor, tgt_mask: torch.Tensor):
        """The ICP's protocol: each shard's layout once per ICP call."""
        return _prepare_target_sharded(tgt, tgt_mask, self.mesh, self.axis)


def make_sharded_nn1(mesh: Mesh, axis: str = "pts") -> ShardedNN1:
    """The target-sharded search as an ``nn1_fn`` (with ``prepare``). In a
    mesh of several axes it searches over the ``axis`` devices of the row
    that holds the target's device: a lane on its ``seq`` group's device
    uses its own group's ``pts`` devices, as the JAX package's search does
    inside the outer ``shard_map``."""
    return ShardedNN1(mesh, axis)
