"""The port stands without JAX, pins float32 matmuls, and its jax-free copies
of the dataset and metric code equal the JAX package's originals."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from lidar_slam_tpu.utils import dataset as jdataset
from lidar_slam_tpu.utils import metrics as jmetrics
from lidar_slam_tpu_torch.utils import dataset, metrics

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(code: str, cwd: str = REPO) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", code], cwd=cwd,
                          capture_output=True, text=True, timeout=120)


def test_port_never_imports_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import lidar_slam_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "assert len(names) >= 33, names\n"
        "for n in ('cli', '__main__', 'utils.io', 'utils.export', 'utils.checkpoint',"
        " 'utils.native', 'ops.voxel', 'parallel', 'parallel.batched',"
        " 'parallel.mesh', 'parallel.sharded_knn', 'parallel.sharded_detect',"
        " 'parallel.dryrun'):\n"
        "    assert p.__name__ + '.' + n in sys.modules, n\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m.startswith('lidar_slam_tpu.') or m == 'lidar_slam_tpu']\n"
        "assert not bad, bad\n"
        "print('ok', len(names))\n"
    )
    r = _run(code)
    assert r.returncode == 0, r.stderr
    assert r.stdout.startswith("ok")


def test_engine_pins_fp32_matmuls():
    code = (
        "import torch\n"
        "torch.backends.cuda.matmul.allow_tf32 = True\n"
        "torch.backends.cudnn.allow_tf32 = True\n"
        "torch.set_float32_matmul_precision('high')\n"
        "from lidar_slam_tpu_torch.config import fast_mode, tiny_config\n"
        "from lidar_slam_tpu_torch.models.pipeline import SlamEngine\n"
        "SlamEngine(fast_mode(tiny_config()).replace(host_voxelize=True), 'cpu')\n"
        "assert torch.backends.cuda.matmul.allow_tf32 is False\n"
        "assert torch.backends.cudnn.allow_tf32 is False\n"
        "assert torch.get_float32_matmul_precision() == 'highest'\n"
        "print('ok')\n"
    )
    r = _run(code)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"


def test_dataset_copy_renders_identical_scans():
    half = dataset.route_half_for(64)
    assert half == jdataset.route_half_for(64)
    for kw in (dict(route_half=half), dict(route_half=40.0, corridor=20.0)):
        w_t, w_j = dataset.generate_world(3, **kw), jdataset.generate_world(3, **kw)
        np.testing.assert_array_equal(w_t, w_j)
    gt = dataset.generate_trajectory(64, half=half)
    np.testing.assert_array_equal(gt, jdataset.generate_trajectory(64, half=half))
    world = dataset.generate_world(3, route_half=half)
    r_t, r_j = np.random.default_rng(7), np.random.default_rng(7)
    for i in (0, 17, 63):
        np.testing.assert_array_equal(
            dataset.render_scan(world, gt[i], r_t, max_points=3000),
            jdataset.render_scan(world, gt[i], r_j, max_points=3000),
        )
    rt, rj = dataset.ScanRenderer(world), jdataset.ScanRenderer(world)
    for i in (5, 40):
        np.testing.assert_array_equal(
            rt.render(gt[i], np.random.default_rng(i), max_points=2000),
            rj.render(gt[i], np.random.default_rng(i), max_points=2000),
        )


def test_ate_copy_matches(rng):
    gt = jdataset.generate_trajectory(50)
    est = gt.copy()
    est[:, :3, 3] += rng.normal(size=(50, 3)).astype(np.float32) * 0.3
    assert metrics.ate_rmse(est, gt) == jmetrics.ate_rmse(est, gt)
    assert metrics.ate_rmse(est, gt, align=False) == jmetrics.ate_rmse(
        est, gt, align=False)


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """Without CUDA, and alone outside the repository, the smoke script
    fails and prints no result line."""
    import torch

    if not torch.cuda.is_available():
        r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                           capture_output=True, text=True, timeout=120)
        assert r.returncode != 0
        assert '"ok": true' not in r.stdout
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=120,
                       env=dict(os.environ, PYTHONPATH=""))
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


def test_cli_refuses_to_run_without_cuda_unless_cpu_is_asked(tmp_path):
    """``run`` without ``--cpu`` on a machine without CUDA exits non-zero
    with a message, before it reads any data; it never moves to the CPU."""
    import torch

    if torch.cuda.is_available():
        return
    r = subprocess.run(
        [sys.executable, "-m", "lidar_slam_tpu_torch", "run", "--data-dir",
         str(tmp_path), "--out-dir", str(tmp_path / "out")],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert "CUDA is not available" in r.stderr and "--cpu" in r.stderr
    assert not (tmp_path / "out").exists()


def test_engine_default_device_is_the_card():
    """``SlamEngine(cfg)`` (the JAX signature) targets CUDA: without a card
    it raises, it does not run on the CPU."""
    import torch

    from lidar_slam_tpu_torch.config import tiny_config
    from lidar_slam_tpu_torch.models.pipeline import SlamEngine

    cfg = tiny_config(max_frames=8)
    if torch.cuda.is_available():
        assert SlamEngine(cfg).state.poses.is_cuda
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            SlamEngine(cfg)
    assert SlamEngine(cfg, "cpu").state.poses.device.type == "cpu"


def test_run_batch_refuses_to_run_without_cuda_unless_cpu_is_asked(tmp_path):
    """``run-batch`` without ``--cpu`` on a machine without CUDA exits 2
    with a message, before it reads any data."""
    import torch

    if torch.cuda.is_available():
        return
    r = subprocess.run(
        [sys.executable, "-m", "lidar_slam_tpu_torch", "run-batch",
         "--data-dirs", f"{tmp_path},{tmp_path}", "--out-dir",
         str(tmp_path / "out")],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert r.returncode == 2
    assert "CUDA is not available" in r.stderr and "--cpu" in r.stderr
    assert not (tmp_path / "out").exists()


def test_batched_engine_default_device_is_the_card():
    """``BatchedSlamEngine(cfg, batch)`` (the JAX signature) targets CUDA:
    without a card it raises; a mesh must be a port ``Mesh`` with the
    ``seq`` axis the lanes spread over."""
    import torch

    from lidar_slam_tpu_torch.config import tiny_config
    from lidar_slam_tpu_torch.parallel import BatchedSlamEngine, make_mesh

    cfg = tiny_config(max_frames=8)
    if torch.cuda.is_available():
        assert BatchedSlamEngine(cfg, 2).state.poses.is_cuda
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            BatchedSlamEngine(cfg, 2)
    eng = BatchedSlamEngine(cfg, 2, "cpu")
    assert eng.state.poses.shape[:2] == (2, 8)
    assert eng.state.poses.device.type == "cpu"
    with pytest.raises(TypeError, match="Mesh"):
        BatchedSlamEngine(cfg, 2, "cpu", mesh=object())
    with pytest.raises(ValueError, match="'seq'"):
        BatchedSlamEngine(cfg, 2, mesh=make_mesh({"pts": 2}, devices=["cpu"] * 2))
    meshed = BatchedSlamEngine(
        cfg, 2, mesh=make_mesh({"seq": 2, "pts": 1}, devices=["cpu"] * 2))
    assert meshed.state.poses.shape[:2] == (2, 8)


def test_unported_options_fail_by_name():
    """Nothing is left to port: a mesh that is not the port's ``Mesh`` is a
    type error, and every engine option constructs, with the backend and
    the estimator it names."""
    import torch

    from lidar_slam_tpu_torch.config import tiny_config
    from lidar_slam_tpu_torch.models import pipeline
    from lidar_slam_tpu_torch.models.pipeline import SlamEngine
    from lidar_slam_tpu_torch.ops.slab_nn import nn1_slab
    from lidar_slam_tpu_torch.parallel import BatchedSlamEngine

    base = tiny_config(max_frames=8)
    with pytest.raises(TypeError, match="Mesh"):
        BatchedSlamEngine(base, 2, "cpu", mesh=object())
    assert pipeline.resolve_nn1(base.replace(knn_backend="slab")) is nn1_slab
    assert hasattr(pipeline.resolve_nn1(base.replace(knn_backend="grid")),
                   "prepare")
    pts = torch.zeros((16, 3))
    mask = torch.arange(16) < 12
    for kw in (dict(normal_method="knn"), dict(normal_stride=2),
               dict(normal_method="radius", normal_stride=3)):
        n = pipeline.normals_fn(base.replace(**kw))(pts, mask)
        assert n.shape == (16, 3)
    for kw in (dict(knn_backend="slab"), dict(knn_backend="grid"),
               dict(normal_method="knn"), dict(normal_stride=2),
               dict(optimize_midrun=True), dict(host_voxelize=False),
               dict(host_voxelize=True, host_normals=True),
               dict(normal_method="radius"), dict(knn_backend="xla"),
               dict(knn_backend="pallas"), dict(knn_backend="slab_pallas")):
        SlamEngine(base.replace(**kw), "cpu")
        BatchedSlamEngine(base.replace(**kw), 2, "cpu")
