"""SLAM-state checkpointing (port of ``lidar_slam_tpu/utils/checkpoint.py``).

The whole SLAM state is a tree of arrays, so checkpoint and resume are a flat
``.npz`` dump. The file format is the JAX package's: one entry per leaf,
named by its path in the state joined with ``/`` (``pg/poses``,
``db/clouds``, ``prev/points``, ...), plus ``__extra__/<name>`` entries
(the engine stores ``__extra__/frame``), in the JAX leaves' dtypes. The
port's host integers and booleans are written as the 0-d arrays JAX stores,
its int64 index tensors as int32. A checkpoint written by either engine
loads into the other: reading goes through
:func:`lidar_slam_tpu_torch.models.pipeline.state_from_numpy`, the one
mapping from the JAX field names to the port's state. A lane-stacked state (``parallel.BatchedSlamEngine``)
is written as the JAX package writes a batched one: every leaf with a
leading lane axis.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..models.pipeline import SlamState, batched_state_from_numpy, state_from_numpy


def _leaf(value) -> np.ndarray:
    """One state leaf as the array the JAX package stores for it."""
    if isinstance(value, torch.Tensor):
        arr = value.detach().cpu().numpy()
        return arr.astype(np.int32) if arr.dtype == np.int64 else arr
    if isinstance(value, bool):
        return np.asarray(value, np.bool_)
    if isinstance(value, int):
        return np.asarray(value, np.int32)
    if isinstance(value, list):  # a lane-stacked state's host scalars
        return np.asarray([_leaf(v) for v in value])
    raise TypeError(f"unsupported state leaf {type(value).__name__}")


def _leaves(state, prefix: str = ""):
    """``(path, value)`` of every leaf of a state dataclass, in field order."""
    for f in dataclasses.fields(state):
        value = getattr(state, f.name)
        if dataclasses.is_dataclass(value):
            yield from _leaves(value, f"{prefix}{f.name}/")
        else:
            yield prefix + f.name, value


def state_to_numpy(state) -> dict:
    """Flatten a state dataclass to ``{path: array}``."""
    return {key: _leaf(value) for key, value in _leaves(state)}


def save_state(path: str, state: SlamState, extra: dict | None = None) -> None:
    """Write a :class:`SlamState` to ``path`` (.npz)."""
    items = state_to_numpy(state)
    if extra:
        for k, v in extra.items():
            items[f"__extra__/{k}"] = np.asarray(v)
    np.savez_compressed(path, **items)


def load_state(path: str, template: SlamState, device=None):
    """Load a checkpoint into the structure of ``template`` (the shapes must
    match, i.e. the same SlamConfig and lane count), onto ``device`` (by
    default the template's). Returns ``(state, extra_dict)``."""
    tree: dict = {}
    with np.load(path) as data:
        for key, value in _leaves(template):
            if key not in data:
                raise KeyError(f"checkpoint missing leaf {key!r}")
            arr = data[key]
            is_tensor = isinstance(value, torch.Tensor)
            shape = tuple(value.shape) if is_tensor else np.shape(_leaf(value))
            if arr.shape != shape:
                raise ValueError(
                    f"checkpoint leaf {key!r} shape {arr.shape} != template "
                    f"{shape} (different SlamConfig?)"
                )
            # the stored dtype of this leaf, without copying the template
            tmpl = _leaf(torch.empty((0,), dtype=value.dtype) if is_tensor
                         else value)
            node = tree
            *parents, name = key.split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[name] = arr.astype(tmpl.dtype, copy=False)
        extra = {
            k.split("/", 1)[1]: data[k]
            for k in data.files if k.startswith("__extra__/")
        }
    build = (batched_state_from_numpy if isinstance(template.n_poses, list)
             else state_from_numpy)
    return build(tree, template.poses.device if device is None else device), extra
