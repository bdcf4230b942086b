"""The port's command line with the options this slice ports, on a ring
dataset written by ``make_rings_dataset``: ``run --normal-method knn
--knn-backend grid`` and ``run --knn-backend slab --normal-stride 2``
(``--cpu --preset tiny --mode fast --resident``, 1 m voxels, 1,024-row
clouds, the sizes of ``test_torch_rings_engine.py``) exit 0 and write the
trajectory the port's engine gives on the scans the command line prepared,
with the configuration it built (to the 1e-6 of ``trajectory.txt``)."""

import json
import os

import numpy as np
import pytest
import torch

from lidar_slam_tpu_torch import cli
from lidar_slam_tpu_torch.models import pipeline
from lidar_slam_tpu_torch.utils import dataset

torch.set_num_threads(2)

N_FRAMES = 64
BEAMS, AZIMUTHS = 32, 256
VOXEL = 1.0
CAP = 1024

CLI_FLAGS = {
    "knn-grid": ["--normal-method", "knn", "--knn-backend", "grid"],
    "slab-stride": ["--knn-backend", "slab", "--normal-stride", "2"],
}


@pytest.fixture(scope="module")
def ring_data(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("rings"))
    dataset.make_rings_dataset(d, n_frames=N_FRAMES, seed=1, n_beams=BEAMS,
                               n_azimuth=AZIMUTHS, fmt="bin")
    return d


@pytest.mark.parametrize("name", list(CLI_FLAGS))
def test_cli_ring_options_equal_the_engine(ring_data, tmp_path, name):
    """``run`` accepts the options; its trajectory is the engine's on the
    scans the command line prepared, with the configuration it built."""
    seen = {}
    preload = pipeline.SlamEngine.preload

    def spy(engine, scans, *a, **kw):
        seen.update(cfg=engine.config, scans=[np.array(s) for s in scans])
        return preload(engine, scans, *a, **kw)

    out = str(tmp_path / "out")
    pipeline.SlamEngine.preload = spy
    try:
        rc = cli.main(["run", "--data-dir", ring_data, "--out-dir", out,
                       "--cpu", "--preset", "tiny", "--mode", "fast",
                       "--resident", "--voxel-size", str(VOXEL),
                       "--max-points", str(CAP), *CLI_FLAGS[name]])
    finally:
        pipeline.SlamEngine.preload = preload
    assert rc == 0
    cfg = seen["cfg"]
    if name == "knn-grid":
        assert (cfg.normal_method, cfg.knn_backend) == ("knn", "grid")
    else:
        assert (cfg.knn_backend, cfg.normal_stride) == ("slab", 2)
    eng = pipeline.SlamEngine(cfg, "cpu")
    eng.preload(seen["scans"])
    eng.run_preloaded()
    eng.finalize()
    want = eng.trajectory()[:, :3, :].reshape(N_FRAMES, 12)
    got = np.loadtxt(os.path.join(out, "trajectory.txt"))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    with open(os.path.join(out, "metrics.jsonl")) as f:
        summary = [json.loads(line) for line in f][-1]
    assert summary["loop_count"] == eng.metrics()["loop_count"] >= 1
