"""The k-NN normals (``normal_method="knn"``, ``ops/normals.estimate_normals``)
traced on the engine's path, at tiny shapes on the CPU: the search is a
``knn`` span inside every ``normals`` span of a step (frame 0's
``init_frame`` too), ``normals.knn_chunks`` counts the target chunks it
streams, the drive's blocking reads are at the sites of the same drive with
the slab-adaptive normals, and tracing leaves every normal bit for bit."""

import dataclasses

import numpy as np
import pytest
import torch

from lidar_slam_tpu_torch import config
from lidar_slam_tpu_torch.models import pipeline
from lidar_slam_tpu_torch.ops import knn as knn_ops
from lidar_slam_tpu_torch.utils.dataset import (
    generate_trajectory,
    generate_world,
    render_scan,
    route_half_for,
)

torch.set_num_threads(2)

N_FRAMES = 24
# 3,072 rows stream as two 1,536-column chunks (knn's default chunk of
# 2,048 does not divide 3,072)
TINY = dict(max_raw_points=8192, max_points=3072, lc_cloud_points=0,
            max_frames=32, max_loop_factors=16)
# fidelity mode on raw scans through the device voxelizer, as the
# kitti00-upstream deployment runs, with ticks often enough to reach the
# tick's sites in a short drive; the ICPs register 512-row samples, cut to
# CPU time (the normals stay at full density)
KNOBS = dict(normal_window=512, dispatch_block=0, host_voxelize=False,
             loop_check_every=2)


def _config(method: str) -> config.SlamConfig:
    cfg = config.apply_mode(config.tiny_config(**TINY), "fidelity")
    return cfg.replace(
        **KNOBS, normal_method=method,
        icp=dataclasses.replace(cfg.icp, normal_k=20, max_iterations=8,
                                tolerance=1e-4, sample_points=512),
        lc=dataclasses.replace(cfg.lc, icp_max_iterations=8, verify_sample=512))


def _drive(cfg, scans, trace: bool):
    eng = pipeline.SlamEngine(cfg, "cpu", trace=trace)
    eng.reset()
    for s in scans:
        eng.push_scan(s)
    n = eng.n_frames
    out = dict(normals=eng.state.db.normals[:n].clone(),
               masks=eng.state.db.cloud_mask[:n].clone(),
               poses=eng.state.poses[:n].clone())
    eng.finalize(timing={})
    out["metrics"] = eng.metrics()
    return out


@pytest.fixture(scope="module")
def runs():
    half = route_half_for(N_FRAMES)
    world = generate_world(0, route_half=half)
    gt = generate_trajectory(N_FRAMES, half=half)
    rng = np.random.default_rng(0)
    scans = [render_scan(world, gt[i], rng, max_range=15.0, max_points=8000)
             for i in range(N_FRAMES)]
    knn, adaptive = _config("knn"), _config("adaptive")
    return dict(cfg=knn, off=_drive(knn, scans, False), on=_drive(knn, scans, True),
                adaptive=_drive(adaptive, scans, True))


def _sites(metrics):
    return {s["site"] for s in metrics["trace"]["spans"] if s["name"] == "sync"}


def test_knn_span_inside_every_step_normals_span(runs):
    spans = runs["on"]["metrics"]["trace"]["spans"]
    normals = [i for i, s in enumerate(spans) if s["name"] == "normals"
               and spans[s["parent"]]["name"] == "step"]
    assert sorted(spans[i]["frame"] for i in normals) == list(range(N_FRAMES))
    for i in normals:
        kids = [j for j, s in enumerate(spans) if s["parent"] == i]
        assert [spans[j]["name"] for j in kids] == ["knn"], spans[i]["frame"]
        k = spans[kids[0]]
        assert spans[i]["t0_ns"] <= k["t0_ns"] <= k["t1_ns"] <= spans[i]["t1_ns"]
    # the search runs nowhere else, and adds no blocking read of its own
    knn = [i for i, s in enumerate(spans) if s["name"] == "knn"]
    assert len(knn) == N_FRAMES
    assert not any(spans[s["parent"]]["name"] == "knn" for s in spans
                   if s["parent"] >= 0)


def test_knn_chunks_count_frames_times_chunks(runs):
    N = runs["cfg"].max_points
    chunks = N // knn_ops.knn_chunk(N, 20)
    assert chunks == 2
    counters = runs["on"]["metrics"]["trace"]["counters"]
    assert counters["normals.knn_chunks"] == N_FRAMES * chunks
    assert "normals.knn_chunks" not in runs["adaptive"]["metrics"]["trace"]["counters"]


def test_knn_drive_syncs_at_the_adaptive_drives_sites(runs):
    knn, adaptive = runs["on"]["metrics"], runs["adaptive"]["metrics"]
    assert _sites(knn) == _sites(adaptive)
    assert {"upload", "voxel.count", "icp.active", "pg.cost"} <= _sites(knn)
    assert int(np.sum(knn["icp_iters"])) > 0


def test_knn_normals_bit_identical_traced_or_not(runs):
    off, on = runs["off"], runs["on"]
    assert torch.equal(off["masks"], on["masks"])
    assert torch.equal(off["normals"], on["normals"])
    assert torch.equal(off["poses"], on["poses"])
    assert "trace" not in off["metrics"]
    # the k-NN normals differ from the slab-adaptive ones: the drive ran knn
    assert not torch.equal(on["normals"], runs["adaptive"]["normals"])
