"""Tests that need an NVIDIA GPU (CUDA kernels have no CPU mode); each
skips with its reason where there is none. On a GPU host:

    python3 -m pytest -p no:cacheprovider slambench/tests -m gpu -q
"""

from __future__ import annotations

import dataclasses
import json
import time
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the port's kernels have no CPU mode")


@pytest.mark.gpu
@pytest.mark.parametrize("cell_name,kernel", [("kitti00-fast.drive", "MATCH_SLAB"),
                                              ("kitti00-fidelity.drive", "NN1")])
def test_slambench_work_count_matches_launch_counters(cell_name, kernel):
    """The roofline readers count an odometry ICP's launches as its
    iterations plus one final pass when it did not converge; the kernels'
    own counters must agree, frame by frame (frames without a tick, where
    the odometry search is the kernel's only caller)."""
    _need_card()
    from lidar_slam_tpu_torch.models.pipeline import SlamEngine
    from lidar_slam_tpu_torch.ops import knn_cuda

    from slambench.cell import load_cell
    from slambench.harness import prepare_scans
    from slambench.traffic.generate import make_drive
    from slambench.window import is_tick

    cell = load_cell(cell_name)
    t = dataclasses.replace(cell.traffic, frames=72)
    t = dataclasses.replace(t, laps=t.frames // t.lap_frames)
    cfg = cell.slam_config()
    raw, _ = make_drive(t, 2**31 + 99, "cuda")
    scans = prepare_scans(cfg, raw)
    engine = SlamEngine(cfg)
    counter = getattr(knn_cuda, kernel)
    launched = []
    for s in scans:
        before = counter.launches
        engine.push_scan(s)
        torch.cuda.synchronize()
        launched.append(counter.launches - before)
    m = engine.metrics()
    for f in range(1, len(scans)):
        if not is_tick(cfg, f):
            want = int(m["icp_iters"][f]) + (0 if m["icp_converged"][f] else 1)
            assert launched[f] == want, (f, launched[f], want)


@pytest.mark.gpu
@pytest.mark.parametrize("cell_name", [w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]])
def test_slambench_cell_output_check_on_card(cell_name):
    """One short run of each cell at its own size: the window's output,
    held to the reference, comes out correct."""
    _need_card()
    from slambench.cell import load_cell
    from slambench.harness import run_cell

    res = run_cell(load_cell(cell_name), 2**31 + 4242, 1.0, False, "cuda",
                   time.time())
    assert res["correct"], res["checks"]
