"""Several sequences at once on one card (port of ``lidar_slam_tpu/parallel``,
the batched engine; the mesh-sharded searches are ROADMAP.md Queue 1, item
1)."""

from ..models.pipeline import batched_state_from_numpy, stack_states
from .batched import BatchedSlamEngine

__all__ = ["BatchedSlamEngine", "batched_state_from_numpy", "stack_states"]
