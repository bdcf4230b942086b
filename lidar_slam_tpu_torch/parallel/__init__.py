"""Several sequences at once, and multi-device sharding (port of
``lidar_slam_tpu/parallel``): device meshes, the target- and source-sharded
1-NN, the DB-sharded Scan Context top-k, the batched engine with its lanes
spread over a mesh, and the multi-device dry run (``dryrun.py``)."""

from ..models.pipeline import batched_state_from_numpy, stack_states
from .batched import BatchedSlamEngine, make_batched_fns
from .mesh import Mesh, make_mesh
from .sharded_detect import sc_topk_sharded
from .sharded_knn import make_sharded_nn1, nn1_source_sharded, nn1_target_sharded

__all__ = [
    "BatchedSlamEngine",
    "Mesh",
    "batched_state_from_numpy",
    "make_batched_fns",
    "make_mesh",
    "make_sharded_nn1",
    "nn1_source_sharded",
    "nn1_target_sharded",
    "sc_topk_sharded",
    "stack_states",
]
