"""A tiny cell for the CPU tests: the two configurations cut to CPU sizes
(2,048-row clouds of 8,192 raw points, a 512 x 512 grid, short windows),
written as the harness's own files into a directory of the test's."""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

from lidar_slam_tpu_torch import config as C

from slambench.cell import load_cell

BENCH = Path(__file__).resolve().parents[1]

LIMITS = {"cloud_gap_m": 1e-4, "normal_p99_deg": 1.0, "odom_frames_off": 2,
          "odom_frame_gap_m": 1e-3, "odom_frame_scale_gap": 3e-2,
          "loop_mismatch": 0, "loops_off": 1, "loop_frame_gap_m": 1e-3,
          "traj_cost_excess": 0.1, "grid_cells": 20}


def _tiny(cfg):
    return cfg.replace(
        max_raw_points=8192, max_points=2048, max_frames=64, max_loop_factors=16,
        min_points=64, loop_start_frame=10, loop_check_every=5, slab_window=512,
        normal_window=512,
        icp=dataclasses.replace(cfg.icp, sample_points=512 if cfg.icp.sample_points else 0,
                                max_iterations=min(cfg.icp.max_iterations, 20)),
        lc=dataclasses.replace(cfg.lc, frame_gap=10,
                               verify_sample=512 if cfg.lc.verify_sample else 0,
                               verify_coarse_sample=128, icp_max_iterations=15),
        grid=C.OccupancyGridConfig(grid_dim=512))


CONFIGS = {
    "tiny-fast": lambda: _tiny(C.slice_config()),
    "tiny-fidelity": lambda: _tiny(C.fidelity_mode(C.slice_config())
                                   .replace(host_voxelize=False)),
}


def write_cell(root: Path, config: str = "tiny-fast", frames: int = 32,
               name: str | None = None) -> str:
    """Write a tiny cell's files under ``root`` (``workloads/``,
    ``configs/``, ``traffic/``); returns the cell's name."""
    for d in ("workloads", "configs", "traffic"):
        (root / d).mkdir(parents=True, exist_ok=True)
    base = json.loads((BENCH / "configs" / "kitti00-fast.json").read_text())
    base["slam_config"] = dataclasses.asdict(CONFIGS[config]())
    (root / "configs" / f"{config}.json").write_text(json.dumps(base))
    (root / "traffic" / "tiny.json").write_text(json.dumps(dict(
        frames=frames, laps=1, revisit_share=0.25, step_m=1.2, raw_points=8000,
        corridor_m=20.0, max_range_m=30.0, noise_m=0.02, recording_seed=0)))
    name = name or f"{config}.tiny"
    (root / "workloads" / f"{name}.json").write_text(json.dumps(dict(
        config=config, traffic="tiny", chips=1, why="CPU test", limits=LIMITS)))
    return name


def load(root: Path, name: str):
    return load_cell(name, root / "workloads", root / "configs", root / "traffic")
