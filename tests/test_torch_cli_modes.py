"""The two command lines, in process, on one 40-frame dataset on the CPU,
in the modes and paths that ``test_torch_cli.py`` (default mode, streaming)
does not take: ``--mode fast`` with radius normals from the loader's workers
(``host_normals``), streaming; and ``--mode fidelity`` with ``--resident``.
Each pair must write the same run: trajectories within 5e-3 m, the same
loops, the same per-frame point counts, maps of the same size.

As there, the runs take 2,048-point clouds and a tighter ICP budget than
``--preset tiny`` alone, at which odometry follows the route. The radius
normals need denser neighbourhoods than the adaptive ones to follow it:
that run takes 1 m voxels (the radius scales with the voxel)."""

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

N_FRAMES = 40
COMMON = ["--preset", "tiny", "--cpu", "--max-points", "2048",
          "--tolerance", "1e-5", "--max-iterations", "30"]
PATHS = {
    "fast-radius-streaming": ("--mode", "fast", "--normal-method", "radius",
                              "--voxel-size", "1.0"),
    "fidelity-resident": ("--mode", "fidelity", "--resident"),
}


def _run(mod, data, out, flags):
    rc = mod.main(["run", "--data-dir", data, "--out-dir", out, *COMMON, *flags])
    assert rc == 0
    with open(os.path.join(out, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    assert rows[-1].get("summary") is True
    return dict(out=out, traj=np.loadtxt(os.path.join(out, "trajectory.txt")),
                rows=rows[:-1], summary=rows[-1])


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("ds"))
    assert cli.main(["make-dataset", "--out", d, "--frames", str(N_FRAMES),
                     "--scan-points", "20000"]) == 0
    return d


@pytest.fixture(scope="module", params=list(PATHS))
def pair(request, data, tmp_path_factory):
    """The same command through the port's CLI and the JAX package's."""
    flags = PATHS[request.param]
    port = _run(cli, data, str(tmp_path_factory.mktemp("port")), flags)
    ref = _run(jcli, data, str(tmp_path_factory.mktemp("jax")), flags)
    return request.param, port, ref


def test_trajectories_match_jax_cli(pair):
    _, port, ref = pair
    assert port["traj"].shape == ref["traj"].shape == (N_FRAMES, 12)
    assert np.abs(port["traj"] - ref["traj"]).max() < 5e-3
    xy = port["traj"][:, [3, 7]]
    assert np.abs(xy - xy[0]).max() > 2.0 and port["summary"]["ate_rmse"] < 2.0
    for key in ("ate_rmse", "rpe_trans", "rpe_rot"):
        assert port["summary"][key] == pytest.approx(ref["summary"][key],
                                                     abs=5e-3), key


def test_same_loops_and_frames_as_jax_cli(pair):
    name, port, ref = pair
    assert port["summary"]["loop_count"] == ref["summary"]["loop_count"] >= 1
    assert [r["npts"] for r in port["rows"]] == [r["npts"] for r in ref["rows"]]
    it_t, it_j = (np.array([r["icp_iters"] for r in run["rows"]])
                  for run in (port, ref))
    assert np.mean(it_t == it_j) >= 0.8, (it_t, it_j)
    timing = ("prep_sec", "upload_sec", "device_sec") if "resident" in name \
        else ("push_sec", "finalize_sec")
    assert all(port["summary"][k] >= 0 for k in timing)
    # the port's summary adds only these stage times to the JAX one's keys
    assert set(port["summary"]) - set(ref["summary"]) == set(timing)
    assert set(ref["summary"]) <= set(port["summary"])


def test_same_artifacts_as_jax_cli(pair):
    _, port, ref = pair
    names = set(os.listdir(port["out"]))
    assert names == set(os.listdir(ref["out"]))
    for name in names:
        assert os.path.getsize(os.path.join(port["out"], name)) > 0, name
    m_t = io.load_ply(os.path.join(port["out"], "map.ply"))
    m_j = io.load_ply(os.path.join(ref["out"], "map.ply"))
    assert m_t.shape == m_j.shape and len(m_t) > 0
    # the same rows in the same order, under poses that differ by <= 5e-3 m
    np.testing.assert_allclose(m_t, m_j, atol=2e-2)
    with np.load(os.path.join(port["out"], "occupancy.npz")) as a, \
            np.load(os.path.join(ref["out"], "occupancy.npz")) as b:
        assert sorted(a.files) == sorted(b.files)
        assert int((a["data"] > 0).sum()) > 0
