"""The port stands without JAX, pins float32 matmuls, and its jax-free copies
of the dataset and metric code equal the JAX package's originals."""

import os
import shutil
import subprocess
import sys

import numpy as np

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
        "assert len(names) >= 15, names\n"
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
