"""The output check on the CPU, at a tiny size: the reference holds the
port's CPU path (plain kernels) on a tiny drive, and the check comes out
false for the control (the reference one precision below) and for each
fault planted in the timed path: a step that leaves the state unchanged,
half of each scan left out, an odometry answer altered where it is
produced (on every frame, or on every fourth), an odometry factor's scale
altered, the k-NN normals of a ``normal_method="knn"`` configuration
taken over 8 neighbours where it states 20. On the GPU the same comparison decides ``correct`` at the cells'
own sizes (``calibrate.py`` reads the control there)."""

from __future__ import annotations

import time

import pytest
import torch

from lidar_slam_tpu_torch.models import pipeline

from slambench import check, harness
from slambench.tests import tiny

SEED = 2**31 + 12345


def _run(tmp_path, config="tiny-fast", frames=32):
    cell = tiny.load(tmp_path, tiny.write_cell(tmp_path, config, frames))
    return harness.run_cell(cell, SEED, 0.5, False, "cpu", time.time())


@pytest.mark.parametrize("config,frames", [("tiny-fast", 32), ("tiny-fidelity", 16),
                                           ("tiny-upstream", 16)])
def test_slambench_reference_holds_the_port(tmp_path, config, frames):
    torch.set_num_threads(4)
    res = _run(tmp_path, config, frames)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= frames and res["failed"] == 0
    assert list(res)[-1] == "checks"


def test_slambench_control_is_not_correct(tmp_path):
    torch.set_num_threads(4)
    cell = tiny.load(tmp_path, tiny.write_cell(tmp_path))
    from lidar_slam_tpu_torch.models.pipeline import SlamEngine
    from slambench.traffic.generate import make_drive
    from slambench.window import Window, drive

    raw, _ = make_drive(cell.traffic, SEED, "cpu")
    engine = SlamEngine(cell.slam_config(), device="cpu")
    drive(engine, harness.prepare_scans(engine.config, raw), Window(), 0)
    out = check.ProgramOutputs.from_engine(engine)
    ok, _ = check.judge(cell, raw, out, SEED, "cpu")
    bad, nums = check.judge(cell, raw, out, SEED, "cpu", control=True)
    assert ok and not bad, nums


def _unchanged(state, config, raw_pts, raw_count, frame, nn1_fn, *a, **k):
    return state


def _half_scan(orig):
    def prep(config, raw_pts, raw_count):
        return orig(config, raw_pts, max(raw_count // 2, 1))
    return prep


def _altered(orig, every=1):
    def step(state, config, raw_pts, raw_count, frame, nn1_fn, *a, **k):
        out = orig(state, config, raw_pts, raw_count, frame, nn1_fn, *a, **k)
        if frame % every == 0:
            out.pg.odom_rel[frame, 0, 3] += 0.05
        return out
    return step


def _knn_k8(orig):
    def normals(pts, mask, k=20, chunk=2048):
        return orig(pts, mask, k=8, chunk=chunk)
    return normals


def _rescaled(orig):
    def step(state, config, raw_pts, raw_count, frame, nn1_fn, *a, **k):
        out = orig(state, config, raw_pts, raw_count, frame, nn1_fn, *a, **k)
        out.pg.odom_scale[frame] *= 1.1
        return out
    return step


@pytest.mark.parametrize("fault", ["unchanged", "half_scan", "altered",
                                   "altered_every_4th", "rescaled", "knn_k8"])
def test_slambench_fault_is_not_correct(tmp_path, monkeypatch, fault):
    torch.set_num_threads(4)
    config, frames = "tiny-fast", 32
    if fault == "unchanged":
        monkeypatch.setattr(pipeline, "step", _unchanged)
    elif fault == "knn_k8":
        monkeypatch.setattr(pipeline, "estimate_normals",
                            _knn_k8(pipeline.estimate_normals))
        config, frames = "tiny-upstream", 16
    elif fault == "half_scan":
        monkeypatch.setattr(pipeline, "prep_cloud", _half_scan(pipeline.prep_cloud))
    elif fault == "rescaled":
        monkeypatch.setattr(pipeline, "step", _rescaled(pipeline.step))
    else:
        every = 4 if fault == "altered_every_4th" else 1
        monkeypatch.setattr(pipeline, "step", _altered(pipeline.step, every))
    res = _run(tmp_path, config, frames)
    assert not res["correct"], res["checks"]
