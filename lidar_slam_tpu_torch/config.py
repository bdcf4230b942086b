"""Configuration tree of the PyTorch port.

A jax-free copy of ``lidar_slam_tpu/config.py``: the same dataclasses, field
names and defaults, so a config of the JAX package translates one to one
(``SlamConfig(**dataclasses.asdict(...))`` field by field). The port cannot
import the JAX package's config: importing anything under ``lidar_slam_tpu``
runs its ``__init__``, which imports ``jax``, and the GPU host has no JAX.
``tests/test_torch_imports.py`` holds the two copies equal.

Knob mapping onto the port's kernels (``lidar_slam_tpu_torch/csrc/knn.cu``):

- ``knn_backend="slab_pallas"`` -> K1, the slab-window fused match kernel
  (``ops/knn_cuda.SlabBackend``), used by odometry ICP;
- ``knn_backend="auto"`` / ``"pallas"`` -> K2, the exact brute-force 1-NN
  kernel (``ops/knn_cuda.nn1``); loop verification always uses it.

On CPU tensors both resolve to their plain PyTorch versions.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class ICPConfig:
    """Point-to-plane ICP settings (reference types.hpp:143-148)."""

    max_iterations: int = 50
    tolerance: float = 1e-6        # convergence threshold on |error change|
    min_error: float = 1e-9        # stop if RMS plane error falls below this
    normal_k: int = 20             # kNN size for normal estimation
    solver_damping: float = 1e-9   # Tikhonov term on the 6x6 normal equations
    sample_points: int = 0         # >0: strided source subsample
    target_points: int = 0         # >0: strided target subsample
    coarse_iterations: int = 0     # >0: fixed coarse GN steps first
    coarse_sample: int = 2048
    warm_start: bool = False       # seed with the previous accepted delta


@dataclass(frozen=True)
class ScanContextConfig:
    """Scan Context descriptor geometry (reference scan_context.hpp:27-29)."""

    num_rings: int = 20
    num_sectors: int = 60
    max_range: float = 80.0
    min_range: float = 0.1


@dataclass(frozen=True)
class LoopClosureConfig:
    """Two-stage loop-closure detection (reference loop_closure.hpp:14-19)."""

    frame_gap: int = 50
    sc_distance_threshold: float = 0.2
    icp_fitness_threshold: float = 0.3
    max_candidates: int = 3
    icp_max_iterations: int = 30
    verify_extra_tranches: int = 1
    yaw_seed: bool = False
    ring_key_prefilter: int = 0
    verify_sample: int = 0
    verify_tolerance: float = 1e-6
    verify_coarse_iterations: int = 0
    verify_coarse_sample: int = 512
    verify_coarse_reject: float = 0.0


@dataclass(frozen=True)
class PoseGraphConfig:
    """SE(3) pose-graph LM settings (reference pose_graph.hpp:22-40).

    The port runs the Woodbury LM only; ``solver``, ``dd_solve`` and the CG
    knobs are kept so configs translate one to one."""

    odom_rotation_sigma: float = 0.01
    odom_translation_sigma: float = 0.05
    prior_rotation_sigma: float = 0.001
    prior_translation_sigma: float = 0.001
    loop_rotation_sigma: float = 0.005
    loop_translation_sigma: float = 0.025
    max_iterations: int = 100
    relative_error_tol: float = 1e-5
    absolute_error_tol: float = 1e-5
    relative_param: bool = True
    inline_max_iterations: int = 3
    inline_loop_window: int = 256
    solver: str = "woodbury"
    dd_solve: str = "direct"
    cg_iterations: int = 120
    cg_tolerance: float = 1e-10
    lambda_init: float = 1e-5
    lambda_factor: float = 10.0
    lambda_max: float = 1e7


@dataclass(frozen=True)
class OccupancyGridConfig:
    """Occupancy-grid mapping (reference slam_node.hpp:35-40)."""

    resolution: float = 0.2
    height_min: float = 0.3
    height_max: float = 2.0
    max_range: float = 40.0
    min_range: float = 0.5
    grid_dim: int = 8192
    origin_x: float = 0.0
    origin_y: float = 0.0

    @property
    def patch_dim(self) -> int:
        """Per-scan update patch (cells): the sensor-centred square that
        covers max_range, rounded up to a multiple of 128."""
        need = int(2.0 * self.max_range / self.resolution) + 16
        return min(self.grid_dim, -(-need // 128) * 128)


@dataclass(frozen=True)
class SlamConfig:
    """Top-level pipeline config (reference slam_node.cpp:17-35)."""

    voxel_size: float = 0.5
    min_points: int = 1000
    divergence_error: float = 1.0
    loop_check_every: int = 10
    loop_start_frame: int = 50

    max_raw_points: int = 131072
    max_points: int = 32768
    lc_cloud_points: int = 0
    max_frames: int = 4608
    max_loop_factors: int = 512

    icp: ICPConfig = ICPConfig()
    sc: ScanContextConfig = ScanContextConfig()
    lc: LoopClosureConfig = LoopClosureConfig()
    pg: PoseGraphConfig = PoseGraphConfig()
    grid: OccupancyGridConfig = OccupancyGridConfig()

    optimize_midrun: bool = True
    knn_backend: str = "auto"
    slab_window: int = 4096
    dispatch_block: int = 0
    host_voxelize: bool = False
    host_normals: bool = False
    normal_method: str = "adaptive"
    normal_radius: float = 0.0
    normal_probe_lo: float = 2.0
    normal_probe_hi: float = 8.0
    normal_k_target: int = 20
    normal_r_max: float = 20.0
    normal_stride: int = 1
    normal_probe_stride: int = 1
    normal_window: int = 4096

    @property
    def effective_normal_radius(self) -> float:
        return self.normal_radius if self.normal_radius > 0 else 2.4 * self.voxel_size

    @property
    def lc_points(self) -> int:
        n = self.lc_cloud_points if self.lc_cloud_points > 0 else self.max_points
        return min(n, self.max_points)

    def replace(self, **kw) -> "SlamConfig":
        return dataclasses.replace(self, **kw)


def tiny_config(**kw) -> SlamConfig:
    """A small config for tests (CPU-friendly shapes)."""
    base = dict(
        max_raw_points=2048,
        max_points=512,
        lc_cloud_points=512,
        max_frames=64,
        max_loop_factors=16,
        min_points=8,
        loop_start_frame=4,
        loop_check_every=2,
        icp=ICPConfig(max_iterations=12, normal_k=8, tolerance=1e-3),
        lc=LoopClosureConfig(
            frame_gap=4, icp_max_iterations=10, icp_fitness_threshold=0.65
        ),
        pg=PoseGraphConfig(max_iterations=25, cg_iterations=60),
        grid=OccupancyGridConfig(grid_dim=256),
    )
    base.update(kw)
    return SlamConfig(**base)


def fast_mode(base: SlamConfig) -> SlamConfig:
    """The fast-mode preset of ``lidar_slam_tpu.cli._apply_mode(base, "fast")``.

    ``dispatch_block`` is carried over for config parity; the port runs each
    scan and each cadence tick in turn, which is the same state."""
    return base.replace(
        icp=dataclasses.replace(
            base.icp, max_iterations=20, tolerance=3e-4,
            sample_points=4096, warm_start=True,
        ),
        lc=dataclasses.replace(
            base.lc, verify_sample=4096, verify_tolerance=3e-4,
            verify_coarse_iterations=3, yaw_seed=True,
            verify_coarse_reject=0.6,
        ),
        knn_backend="slab_pallas",
        dispatch_block=50,
        optimize_midrun=False,
        normal_probe_stride=2,
    )


def slice_config() -> SlamConfig:
    """The full-size fast-mode configuration the port's main path runs:
    host-voxelized 32,768-point clouds from 65,536 raw points, a
    4,608-frame keyframe DB at full cloud size and an 8192^2 grid (the
    ``bench.py`` shapes at KITTI-00 DB capacity)."""
    return fast_mode(SlamConfig()).replace(
        host_voxelize=True,
        max_raw_points=65536,
        max_points=32768,
        lc_cloud_points=0,
        max_frames=4608,
        grid=OccupancyGridConfig(grid_dim=8192),
    )
