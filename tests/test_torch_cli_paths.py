"""The port's command line on one small dataset on the CPU, in process: the
resident run, the device voxelizer and warm-up passes against the JAX
package's command line with the same flags and against the port's own
streaming run; a profiler trace, the flags that exist for the other
runtime, the options once refused (now ported), ``convert``. (The modes and host normals over a
route with a revisit are in ``test_torch_cli_modes.py``.)

As in ``test_torch_cli.py`` the runs take 2,048-point clouds and a tighter
ICP budget than ``--preset tiny`` alone, at which odometry follows the
route."""

import json
import os

import numpy as np
import pytest
import torch

from lidar_slam_tpu import cli as jcli
from lidar_slam_tpu_torch import cli
from lidar_slam_tpu_torch.utils import io

from jax_native import jax_native  # noqa: F401  (autouse fixture)

torch.set_num_threads(2)

SHORT = 8  # frames of every run here
COMMON = ["--preset", "tiny", "--cpu", "--max-points", "2048",
          "--tolerance", "1e-5", "--max-iterations", "30"]


def _summary(out_dir):
    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    assert rows[-1].get("summary") is True
    return rows[:-1], rows[-1]


def _run(data, out, *flags, mod=cli):
    rc = mod.main(["run", "--data-dir", data, "--out-dir", out, *COMMON,
                   "--frames", str(SHORT), *flags])
    assert rc == 0
    return np.loadtxt(os.path.join(out, "trajectory.txt"))


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("ds"))
    assert cli.main(["make-dataset", "--out", d, "--frames", str(SHORT),
                     "--scan-points", "8000"]) == 0
    return d


@pytest.fixture(scope="module")
def streamed_short(data, tmp_path_factory):
    return _run(data, str(tmp_path_factory.mktemp("short")))


@pytest.mark.parametrize("flags", [
    ("--resident", "--warmup-run"),
    ("--resident", "--no-host-voxelize"),
    ("--warmup-run", "--dispatch-block", "10", "--debug-nans"),
])
def test_resident_and_streaming_agree(data, streamed_short, tmp_path, capsys,
                                      flags):
    """The resident run (whole dataset preloaded), the device voxelizer on
    the raw frames, and a warm-up pass change no pose of the streaming run
    beyond the voxelizer's rounding (host and device centroids differ in the
    last bits: 5e-3 m); ``--dispatch-block`` says that it has no effect. The
    JAX command line with the same flags writes the same run: poses within
    5e-3 m, the same per-frame point counts. (``--debug-nans`` there sets a
    process-wide JAX option, so it is left out of that run.)"""
    traj = streamed_short
    got = _run(data, str(tmp_path / "o"), *flags)
    if "--no-host-voxelize" in flags:
        assert np.abs(got - traj).max() < 5e-3
    else:
        np.testing.assert_array_equal(got, traj)
    err = capsys.readouterr().err
    assert ("--dispatch-block has no effect" in err) == ("--dispatch-block" in flags)
    _, summary = _summary(str(tmp_path / "o"))
    keys = ("prep_sec", "upload_sec", "device_sec") if "--resident" in flags \
        else ("push_sec", "finalize_sec")
    assert all(summary[k] >= 0 for k in keys)
    ref = _run(data, str(tmp_path / "j"),
               *(f for f in flags if f != "--debug-nans"), mod=jcli)
    assert got.shape == ref.shape == (SHORT, 12)
    assert np.abs(got - ref).max() < 5e-3
    assert np.abs(got[-1, [3, 7]] - got[0, [3, 7]]).max() > 1.0  # it moved
    rows, _ = _summary(str(tmp_path / "o"))
    rows_j, _ = _summary(str(tmp_path / "j"))
    assert [r["npts"] for r in rows] == [r["npts"] for r in rows_j]


def test_modes_host_normals_and_profile(data, tmp_path):
    """``--mode fast`` with radius normals estimated by the loader's workers
    (``host_normals``) follows the route, and ``--profile`` writes a trace;
    ``--mode fidelity`` runs."""
    prof = str(tmp_path / "prof")
    traj = _run(data, str(tmp_path / "fast"), "--mode", "fast",
                "--normal-method", "radius", "--profile", prof)
    assert traj.shape == (SHORT, 12) and np.isfinite(traj).all()
    assert np.abs(traj[-1, [3, 7]] - traj[0, [3, 7]]).max() > 1.0  # it moved
    assert os.path.getsize(os.path.join(prof, "trace.json")) > 0
    traj = _run(data, str(tmp_path / "fid"), "--mode", "fidelity")
    assert traj.shape == (SHORT, 12) and np.isfinite(traj).all()


@pytest.mark.parametrize("flags,text", [
    (("--knn-backend", "slab"), "backend=slab"),
    (("--knn-backend", "grid"), "backend=grid"),
    (("--normal-method", "knn"), "backend=auto"),
    (("--normal-stride", "2"), "backend=auto"),
])
def test_unported_flags_fail_by_name(data, tmp_path, capsys, flags, text):
    """The options that once failed by name (the pruned odometry searches,
    the k-NN normals, the normal stride) are ported: each run exits 0 with
    one finite pose per frame, and nothing says "not ported"."""
    traj = _run(data, str(tmp_path / "o"), *flags)
    assert traj.shape == (SHORT, 12) and np.isfinite(traj).all()
    out = capsys.readouterr()
    assert text in out.out
    assert "not ported" not in out.out + out.err


def test_convert_and_missing_frames(tmp_path, data, capsys):
    src = tmp_path / "bins"
    src.mkdir()
    pts = io.load_scan(os.path.join(data, "000000.ply"))
    np.concatenate([pts, np.zeros((len(pts), 1), np.float32)], 1).tofile(
        str(src / "000000.bin"))
    assert cli.main(["convert", "-d", str(src), str(tmp_path / "plys")]) == 0
    np.testing.assert_array_equal(
        io.load_ply(str(tmp_path / "plys" / "000000.ply")), pts)
    assert cli.main(["convert", str(src / "000000.bin"),
                     str(tmp_path / "one.ply")]) == 0
    assert cli.main(["run", "--data-dir", str(tmp_path / "plys" / ".."),
                     "--cpu", "--out-dir", str(tmp_path / "o")]) == 1
    assert "No frames found" in capsys.readouterr().err
    assert cli.main(["run-batch", "--data-dirs", f"{data},{tmp_path}", "--cpu",
                     "--out-dir", str(tmp_path / "o")]) == 1
    assert "empty sequence directory" in capsys.readouterr().err
