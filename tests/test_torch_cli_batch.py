"""``run-batch`` of the two command lines, in process, on two small
datasets on the CPU: the same files, the same ``metrics.json`` keys (the
port adds only its stage times, as with ``run``), the same loops per lane,
trajectories within 5e-3 m; the port's streaming run against its resident
one, and the notices of the flags that do nothing here.

``run-batch`` has no ``--preset``: it starts from ``SlamConfig()``. Here both
packages' ``SlamConfig()`` give the tiny test configuration the other CLI
tests run (2,048-point clouds, a loop tick every 2nd frame from frame 4,
slab and normal windows of 1,024 points), so that a 40-frame route closes
its loop in seconds. The pair of runs passes ``--dispatch-block 0``: fast
mode's 50-frame dispatch blocks take the JAX engine minutes to compile on the
CPU, and the port has none (it says so and runs as always)."""

import json
import os

import numpy as np
import pytest
import torch

from lidar_slam_tpu import cli as jcli
from lidar_slam_tpu import config as jconfig
from lidar_slam_tpu_torch import cli
from lidar_slam_tpu_torch import config

from jax_native import jax_native  # noqa: F401  (autouse fixture)

torch.set_num_threads(2)

N_FRAMES = 40
SHORT = 8
COMMON = ["--cpu", "--mode", "fast", "--max-points", "2048"]
TINY = dict(max_raw_points=16384, max_points=2048, lc_cloud_points=0,
            max_frames=48, max_loop_factors=16, slab_window=1024,
            normal_window=1024)


@pytest.fixture(scope="module", autouse=True)
def tiny_defaults():
    """``SlamConfig()`` of both packages -> the tiny test configuration."""
    tiny_j = jconfig.tiny_config(**TINY)
    tiny_t = config.tiny_config(**TINY)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jconfig, "SlamConfig", lambda: tiny_j)
        mp.setattr(config, "SlamConfig", lambda: tiny_t)
        yield


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    out = []
    for seed, name in ((0, "seq_a"), (1, "seq_b")):
        d = str(tmp_path_factory.mktemp("ds") / name)
        assert cli.main(["make-dataset", "--out", d, "--frames", str(N_FRAMES),
                         "--scan-points", "20000", "--seed", str(seed)]) == 0
        out.append(d)
    return out


def _run(mod, dirs, out, *flags):
    rc = mod.main(["run-batch", "--data-dirs", ",".join(dirs), "--out-dir", out,
                   *COMMON, *flags])
    assert rc == 0
    with open(os.path.join(out, "metrics.json")) as f:
        metrics = json.load(f)
    trajs = {name[len("trajectory_"):-4]: np.loadtxt(os.path.join(out, name))
             for name in os.listdir(out) if name.startswith("trajectory_")}
    return dict(out=out, metrics=metrics, trajs=trajs)


@pytest.fixture(scope="module")
def pair(dirs, tmp_path_factory):
    flags = ("--resident", "--dispatch-block", "0")
    port = _run(cli, dirs, str(tmp_path_factory.mktemp("port")), *flags)
    ref = _run(jcli, dirs, str(tmp_path_factory.mktemp("jax")), *flags)
    return port, ref


def test_same_files_and_metrics_keys(pair):
    port, ref = pair
    assert sorted(os.listdir(port["out"])) == sorted(os.listdir(ref["out"])) == [
        "metrics.json", "trajectory_seq_a.txt", "trajectory_seq_b.txt"]
    assert set(port["metrics"]) == set(ref["metrics"])
    assert set(port["metrics"]["resident"]) == set(ref["metrics"]["resident"])
    assert set(port["metrics"]["ate_rmse"]) == {"seq_a", "seq_b"}
    for key in ("sequences", "frames", "mode"):
        assert port["metrics"][key] == ref["metrics"][key], key
    assert port["metrics"]["frames"] == N_FRAMES


def test_same_loops_per_lane(pair):
    port, ref = pair
    assert port["metrics"]["loops"] == ref["metrics"]["loops"]
    assert all(n >= 1 for n in port["metrics"]["loops"])


def test_trajectories_match_jax_cli(pair):
    port, ref = pair
    for name in ("seq_a", "seq_b"):
        a, b = port["trajs"][name], ref["trajs"][name]
        assert a.shape == b.shape == (N_FRAMES, 12)
        assert np.abs(a - b).max() < 5e-3, name
        assert port["metrics"]["ate_rmse"][name] == pytest.approx(
            ref["metrics"]["ate_rmse"][name], abs=5e-3)
    assert np.abs(port["trajs"]["seq_a"] - port["trajs"]["seq_b"]).max() > 1e-2


def test_streaming_equals_resident_and_notices(dirs, tmp_path, capsys):
    """The streaming run writes the resident run's trajectories and adds
    its push / finalize times; ``--warmup-run`` without ``--resident`` and
    ``--dispatch-block`` say on stderr that they do nothing; a directory
    named twice gets one file per lane."""
    res = _run(cli, dirs, str(tmp_path / "res"), "--resident", "--frames",
               str(SHORT))
    capsys.readouterr()
    stream = _run(cli, dirs, str(tmp_path / "stream"), "--frames", str(SHORT),
                  "--warmup-run", "--dispatch-block", "10")
    err = capsys.readouterr().err
    assert "--warmup-run has no effect without --resident" in err
    assert "--dispatch-block has no effect" in err
    for name, traj in res["trajs"].items():
        np.testing.assert_array_equal(stream["trajs"][name], traj)
    assert set(stream["metrics"]) - set(res["metrics"]) == {"push_sec",
                                                            "finalize_sec"}
    assert "resident" not in stream["metrics"]
    twice = _run(cli, [dirs[0], dirs[0]], str(tmp_path / "twice"), "--frames",
                 "3")
    assert sorted(twice["trajs"]) == ["lane0_seq_a", "lane1_seq_a"]
    np.testing.assert_array_equal(twice["trajs"]["lane0_seq_a"],
                                  twice["trajs"]["lane1_seq_a"])


def test_empty_directory_fails(dirs, tmp_path, capsys):
    empty = tmp_path / "empty"
    empty.mkdir()
    assert cli.main(["run-batch", "--data-dirs", f"{dirs[0]},{empty}",
                     "--out-dir", str(tmp_path / "o"), "--cpu"]) == 1
    assert "empty sequence directory" in capsys.readouterr().err
