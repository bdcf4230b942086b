"""Artifact export (jax-free copy of ``lidar_slam_tpu/utils/export.py``):
the replacement for the reference's RViz topics (README.md:193-199: current
scan, global map, trajectory, pose, occupancy grid) and TF broadcasts. Each
topic becomes a savable file, with the same names and formats in both
packages."""

from __future__ import annotations

import json
import os

import numpy as np

from ..config import OccupancyGridConfig
from ..ops.occupancy import grid_to_message
from .dataset import save_poses_kitti as save_trajectory_kitti
from .io import save_ply


def save_trajectory_tum(path: str, poses: np.ndarray) -> None:
    """TUM format: t x y z qx qy qz qw (replaces the PoseStamped/TF publish,
    slam_node.cpp:257-273)."""
    from scipy.spatial.transform import Rotation

    with open(path, "w") as f:
        for i, T in enumerate(poses):
            q = Rotation.from_matrix(T[:3, :3]).as_quat()  # x y z w
            t = T[:3, 3]
            f.write(
                f"{i} {t[0]:.6f} {t[1]:.6f} {t[2]:.6f} "
                f"{q[0]:.6f} {q[1]:.6f} {q[2]:.6f} {q[3]:.6f}\n"
            )


def save_map(path: str, pts: np.ndarray) -> None:
    """Global map as binary PLY (replaces /slam/global_map)."""
    save_ply(path, pts)


def save_occupancy(path: str, grid: np.ndarray, config: OccupancyGridConfig) -> None:
    """Occupancy as .npz (cropped message form) + .pgm preview
    (replaces /slam/occupancy_grid, slam_node.cpp:279-297)."""
    msg = grid_to_message(grid, config)
    np.savez_compressed(
        path,
        data=msg["data"],
        resolution=msg["resolution"],
        origin_x=msg["origin_x"],
        origin_y=msg["origin_y"],
    )
    pgm = path[:-4] if path.endswith(".npz") else path
    data = msg["data"]
    if data.size:
        img = np.where(data > 0, 0, 255).astype(np.uint8)  # occupied = black
        with open(pgm + ".pgm", "wb") as f:
            f.write(f"P5\n{img.shape[1]} {img.shape[0]}\n255\n".encode())
            f.write(img.tobytes())


def save_overview_png(path: str, poses: np.ndarray, map_pts: np.ndarray,
                      gt: np.ndarray | None = None) -> bool:
    """Top-down overview (map points + trajectory) — the RViz replacement
    image (slam_config.rviz displays). Returns False if matplotlib is
    unavailable."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return False
    fig, ax = plt.subplots(figsize=(8, 8))
    if len(map_pts):
        sub = map_pts[:: max(len(map_pts) // 200000, 1)]
        ax.scatter(sub[:, 0], sub[:, 1], s=0.2, c=sub[:, 2], cmap="viridis",
                   alpha=0.5, linewidths=0)
    if gt is not None:
        ax.plot(gt[:, 0, 3], gt[:, 1, 3], "r--", lw=1, label="ground truth")
    ax.plot(poses[:, 0, 3], poses[:, 1, 3], "g-", lw=1.5, label="trajectory")
    ax.plot(poses[-1, 0, 3], poses[-1, 1, 3], "r^", ms=8)
    ax.set_aspect("equal")
    ax.legend(loc="upper right")
    ax.set_title(f"{len(poses)} poses, {len(map_pts)} map points")
    fig.savefig(path, dpi=110, bbox_inches="tight")
    plt.close(fig)
    return True


def save_metrics_jsonl(path: str, metrics: dict, extra: dict | None = None) -> None:
    """Per-frame metrics log (replaces RCLCPP_INFO stats, slam_node.cpp:169-174)."""
    n = len(metrics["icp_error"])
    with open(path, "w") as f:
        for i in range(n):
            rec = {
                "frame": i,
                "icp_error": float(metrics["icp_error"][i]),
                "icp_iters": int(metrics["icp_iters"][i]),
                "icp_converged": bool(metrics["icp_converged"][i]),
                "npts": int(metrics["frame_npts"][i]),
            }
            f.write(json.dumps(rec) + "\n")
        summary = {"summary": True, "loop_count": metrics["loop_count"]}
        if extra:
            summary.update(extra)
        f.write(json.dumps(summary) + "\n")


def export_snapshot(out_dir: str, engine, map_points_per_frame: int = 512) -> None:
    """Crash-durable mid-run artifact snapshot.

    The reference publishes the current scan every frame, the global map
    every 5 frames, and trajectory/pose/grid continuously
    (slam_node.cpp:154-157) — a crash mid-run leaves RViz holding the latest
    state. The file-artifact analog: on an ``--export-every N`` cadence dump
    the trajectory, a subsampled map, the occupancy grid and per-frame
    metrics, overwriting the previous snapshot, so a killed run leaves usable
    artifacts without waiting for finalize().
    """
    os.makedirs(out_dir, exist_ok=True)
    traj = engine.trajectory()
    save_trajectory_kitti(os.path.join(out_dir, "trajectory.txt"), traj)
    save_occupancy(
        os.path.join(out_dir, "occupancy.npz"), engine.occupancy(),
        engine.config.grid,
    )
    gmap = engine.global_map(max_points_per_frame=map_points_per_frame)
    save_map(os.path.join(out_dir, "map.ply"), gmap)
    save_metrics_jsonl(os.path.join(out_dir, "metrics.jsonl"), engine.metrics())


def export_all(out_dir: str, engine, extra: dict | None = None,
               gt: np.ndarray | None = None) -> dict:
    """Dump every artifact the reference publishes, plus metrics."""
    os.makedirs(out_dir, exist_ok=True)
    traj = engine.trajectory()
    save_trajectory_kitti(os.path.join(out_dir, "trajectory.txt"), traj)
    save_trajectory_tum(os.path.join(out_dir, "trajectory_tum.txt"), traj)
    gmap = engine.global_map()
    save_map(os.path.join(out_dir, "map.ply"), gmap)
    save_overview_png(os.path.join(out_dir, "overview.png"), traj, gmap, gt)
    save_occupancy(
        os.path.join(out_dir, "occupancy.npz"), engine.occupancy(), engine.config.grid
    )
    m = engine.metrics()
    save_metrics_jsonl(os.path.join(out_dir, "metrics.jsonl"), m, extra)
    return m
