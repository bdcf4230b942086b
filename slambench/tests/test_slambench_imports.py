"""Nothing the benchmark runs loads JAX or the JAX package, compared by
whole top-level module name (``lidar_slam_tpu_torch``, the port, begins
with ``lidar_slam_tpu`` and passes), and the plain reference loads nothing
of the port."""

from __future__ import annotations

import ast
import json
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "lidar_slam_tpu"}

# a whole tiny run on the CPU, then the calibration tool's imports: the
# modules the process holds at the end
RUN = f"""
import json, sys, tempfile, time
from pathlib import Path
sys.path.insert(0, {str(ROOT)!r})
import torch
torch.set_num_threads(2)
from slambench import harness
import slambench.calibrate
from slambench.tests import tiny
root = Path(tempfile.mkdtemp())
cell = tiny.load(root, tiny.write_cell(root, frames=16))
harness.run_cell(cell, 7, 0.1, True, "cpu", time.time())
print(json.dumps(sorted(sys.modules)))
"""

REFERENCE = f"""
import json, pkgutil, importlib, sys
sys.path.insert(0, {str(ROOT)!r})
import slambench.reference as R
for m in pkgutil.iter_modules(R.__path__):
    importlib.import_module("slambench.reference." + m.name)
print(json.dumps(sorted(sys.modules)))
"""


def _modules(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return {m.split(".")[0] for m in json.loads(out.stdout.strip().splitlines()[-1])}


def test_slambench_run_loads_no_jax():
    tops = _modules(RUN)
    assert "lidar_slam_tpu_torch" in tops and "slambench" in tops
    assert not tops & FORBIDDEN, sorted(tops & FORBIDDEN)


def test_slambench_reference_loads_nothing_of_the_port():
    tops = _modules(REFERENCE)
    assert not tops & (FORBIDDEN | {"lidar_slam_tpu_torch"})


def test_slambench_reference_sources_import_nothing_of_the_port():
    for path in (BENCH / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for n in names:
                assert n.split(".")[0] not in FORBIDDEN | {"lidar_slam_tpu_torch"}, \
                    (path.name, n)
