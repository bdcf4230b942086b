"""The two command lines, in process, on one small dataset on the CPU: the
same artifacts, trajectories within 5e-3 m, the same loop count; then the
port's resume from the checkpoint that run left. (The port's other paths
and flags are in ``test_torch_cli_paths.py``.)

``--preset tiny`` alone tracks nothing (512-point clouds: every ICP
diverges to the identity in both packages), so the runs take 2,048-point
clouds and a tighter ICP budget, at which odometry follows the route."""

import json
import os

import numpy as np
import pytest
import torch

from lidar_slam_tpu import cli as jcli
from lidar_slam_tpu_torch import cli
from lidar_slam_tpu_torch.utils import io
from lidar_slam_tpu_torch.utils.dataset import load_gt_poses

from jax_native import jax_native  # noqa: F401  (autouse fixture)

torch.set_num_threads(2)

N_FRAMES = 40
COMMON = ["--preset", "tiny", "--cpu", "--max-points", "2048",
          "--tolerance", "1e-5", "--max-iterations", "30"]
ARTIFACTS = {"trajectory.txt", "trajectory_tum.txt", "map.ply",
             "occupancy.npz", "occupancy.pgm", "metrics.jsonl"}


def _summary(out_dir):
    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    assert rows[-1].get("summary") is True
    return rows[:-1], rows[-1]


def _run(mod, data, out, *flags):
    rc = mod.main(["run", "--data-dir", data, "--out-dir", out, *COMMON, *flags])
    assert rc == 0
    return np.loadtxt(os.path.join(out, "trajectory.txt"))


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("ds"))
    assert cli.main(["make-dataset", "--out", d, "--frames", str(N_FRAMES),
                     "--scan-points", "8000"]) == 0
    return d


@pytest.fixture(scope="module")
def streamed(data, tmp_path_factory):
    """The port's default-mode streaming run with a checkpoint and a
    snapshot on the way."""
    out = str(tmp_path_factory.mktemp("port"))
    traj = _run(cli, data, out, "--checkpoint-every", "20", "--export-every",
                "25", "--verbose")
    return out, traj


def test_both_clis_write_the_same_run(data, streamed, tmp_path):
    out_t, traj_t = streamed
    out_j = str(tmp_path / "jax")
    traj_j = _run(jcli, data, out_j)
    assert traj_t.shape == traj_j.shape == (N_FRAMES, 12)
    assert np.abs(traj_t - traj_j).max() < 5e-3
    names_t = set(os.listdir(out_t)) - {"checkpoint.npz"}
    assert names_t == set(os.listdir(out_j)) and ARTIFACTS <= names_t
    for name in names_t:
        assert os.path.getsize(os.path.join(out_t, name)) > 0, name
    rows_t, sum_t = _summary(out_t)
    rows_j, sum_j = _summary(out_j)
    assert sum_t["loop_count"] == sum_j["loop_count"] >= 1
    assert [r["npts"] for r in rows_t] == [r["npts"] for r in rows_j]
    it_t, it_j = ([r["icp_iters"] for r in rows] for rows in (rows_t, rows_j))
    assert np.mean(np.array(it_t) == np.array(it_j)) >= 0.8, (it_t, it_j)
    for key in ("ate_rmse", "rpe_trans", "rpe_rot"):
        assert sum_t[key] == pytest.approx(sum_j[key], abs=5e-3), key
    # the artifacts read back: one pose per frame, a map, an occupancy crop
    gt = load_gt_poses(os.path.join(data, "poses_gt.txt"))
    assert sum_t["ate_rmse"] < 2.0 and len(gt) == N_FRAMES
    m_t = io.load_ply(os.path.join(out_t, "map.ply"))
    m_j = io.load_ply(os.path.join(out_j, "map.ply"))
    assert m_t.shape == m_j.shape and np.isfinite(m_t).all()
    with np.load(os.path.join(out_t, "occupancy.npz")) as a, \
            np.load(os.path.join(out_j, "occupancy.npz")) as b:
        assert sorted(a.files) == sorted(b.files)
        assert a["data"].size > 0 and float(a["resolution"]) == 0.2


def test_resume_repeats_the_uninterrupted_run(data, streamed, tmp_path):
    """``--resume`` from the checkpoint the streaming run left (written
    after frame 20) with the matching capacities: bit for bit."""
    out, traj = streamed
    ckpt = os.path.join(out, "checkpoint.npz")
    with np.load(ckpt) as c:
        assert int(c["__extra__/frame"]) == 21
        max_frames = c["poses"].shape[0]
    assert max_frames == N_FRAMES + 8
    resumed = _run(cli, data, str(tmp_path / "resumed"), "--resume", ckpt,
                   "--max-frames", str(max_frames))
    np.testing.assert_array_equal(resumed, traj)
    with pytest.raises(ValueError, match="different SlamConfig"):
        cli.main(["run", "--data-dir", data, "--out-dir", str(tmp_path / "x"),
                  *COMMON, "--resume", ckpt, "--max-frames", "64"])
