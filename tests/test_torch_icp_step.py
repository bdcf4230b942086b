"""The fused ICP iteration (``ops/icp_cuda.py``, ``csrc/icp_step.cu``) on the
CPU: CPU tensors take the plain eager loop and launch nothing; the fused
loop, run with the kernel's plain version (``icp_step_torch``) as its
launch, gives the plain loop's results bit for bit and counts each
iteration under ``icp.fused_iters``; the launch wrapper refuses what the
kernel does not take; its argument block mirrors the kernel's struct.
The kernel itself is held to ``icp_step_torch`` on the card
(``tests/test_torch_kernels.py``)."""

import ctypes
import re

import numpy as np
import pytest
import torch

from lidar_slam_tpu_torch.config import ICPConfig
from lidar_slam_tpu_torch.ops import icp, icp_cuda, knn_cuda
from lidar_slam_tpu_torch.types import PointCloud
from lidar_slam_tpu_torch.utils import tracing

torch.set_num_threads(2)

CONFIGS = {
    "converging": ICPConfig(max_iterations=6, tolerance=1e-4),
    "budget": ICPConfig(max_iterations=3, tolerance=1e-9),
    "coarse": ICPConfig(max_iterations=8, tolerance=1e-5, sample_points=300,
                        coarse_iterations=2, coarse_sample=100),
}


def _case(seed=0, lanes=3, n_src=700, n_tgt=900):
    """Targets with normals, and sources: a shifted noisy copy of each
    lane's first rows, some rows masked on both sides."""
    g = np.random.default_rng(seed)
    tgt = (g.normal(size=(lanes, n_tgt, 3)) * [10, 10, 2]).astype(np.float32)
    nrm = g.normal(size=(lanes, n_tgt, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    tmask = g.uniform(size=(lanes, n_tgt)) > 0.05
    src = (tgt[:, :n_src] + g.normal(0, 0.02, (lanes, n_src, 3))
           + [0.05, -0.03, 0.01]).astype(np.float32)
    smask = g.uniform(size=(lanes, n_src)) > 0.1
    t = torch.from_numpy
    return (PointCloud(t(src), t(smask)), PointCloud(t(tgt), t(tmask)), t(nrm))


def _backend(name):
    return knn_cuda.nn1 if name == "k2" else knn_cuda.SlabBackend(ts=64,
                                                                  window=256)


def _fields(res):
    return (res.transformation, res.converged, res.num_iterations,
            res.error_history, res.final_error)


@pytest.mark.parametrize("backend", ["k1", "k2"])
def test_cpu_icp_takes_the_plain_route(backend):
    src, tgt, nrm = _case()
    before = icp_cuda.ICP_STEP.launches
    tr = tracing.Tracer()
    with tr.bind(0):
        res = icp.icp_point_to_plane(src, tgt, nrm, CONFIGS["converging"],
                                     nn1_fn=_backend(backend))
    assert icp_cuda.ICP_STEP.launches == before
    assert "icp.fused_iters" not in tr.counters
    span = next(s for s in tr.records()["spans"] if s["name"] == "icp")
    assert span["launches"] == {"match_slab": 0, "nn1": 0, "icp_step": 0}
    assert int(res.num_iterations.max()) > 0


@pytest.mark.parametrize("inactive", [False, True])
@pytest.mark.parametrize("cfg", sorted(CONFIGS))
@pytest.mark.parametrize("backend", ["k1", "k2"])
def test_fused_loop_with_plain_step_equals_plain_loop(backend, cfg, inactive):
    """The fused loop (the card's control flow: apply, search, step, one
    flag read an iteration; a converged exit's final error from its last
    iteration) with the kernel's plain version as the launch gives the
    plain loop's transforms, flags, counts, histories and final errors bit
    for bit, with the same host reads, and counts every loop pass."""
    src, tgt, nrm = _case()
    config = CONFIGS[cfg]
    skip = torch.tensor([False, True, False]) if inactive else None
    runs = []
    for launch in (None, icp.icp_step_torch):
        tr = tracing.Tracer()
        with tr.bind(0):
            res = icp._icp(src, tgt, nrm, config, None, _backend(backend),
                           skip, launch=launch)
        runs.append((res, tr.counters, tr.records()["spans"]))
    (plain, c_plain, s_plain), (fused, c_fused, s_fused) = runs
    for a, b in zip(_fields(plain), _fields(fused)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    passes = int(plain.num_iterations.max())
    assert c_fused.pop("icp.fused_iters", 0) == passes
    assert c_fused == c_plain
    assert [s["name"] for s in s_fused] == [s["name"] for s in s_plain]
    assert sum(s["name"] == "iter" for s in s_fused) == passes


@pytest.mark.parametrize("iterations", [1, 3])
def test_coarse_icp_with_plain_step_equals_plain(iterations):
    """The coarse warm start of loop verification: fused (apply, coarse per
    pass; apply, final for the error) with the plain step as its launch
    against the eager passes, bit for bit."""
    src, tgt, nrm = _case(seed=1)
    T0 = torch.eye(4).expand(3, 4, 4)
    match = icp._matcher(knn_cuda.nn1, tgt.points, tgt.mask, nrm)
    plain = icp.coarse_icp(T0, src, match, iterations, 1e-9)
    fused = icp.coarse_icp(T0, src, match, iterations, 1e-9,
                           launch=icp.icp_step_torch)
    for a, b in zip(plain, fused):
        assert torch.equal(a, b)
    assert not torch.equal(plain[0], T0)


def _state(dtype=torch.float32):
    T = torch.eye(4, dtype=dtype).repeat(2, 1, 1)
    return icp_cuda.new_state(T, 1e-9, torch.zeros(2, dtype=torch.bool), 4)


@pytest.mark.parametrize("what", ["cpu", "float64", "meta"])
def test_icp_step_launch_refuses(what):
    """The wrapper launches on CUDA float32 tensors only; it raises (and
    launches nothing) for anything else, with no fallback."""
    dtype = torch.float64 if what == "float64" else torch.float32
    dev = "meta" if what == "meta" else "cpu"
    st = _state(dtype)
    cur = torch.zeros((2, 5, 3), dtype=dtype, device=dev)
    before = icp_cuda.ICP_STEP.launches
    with pytest.raises(ValueError):
        icp_cuda.launch("apply", st, cur, src=cur)
    assert icp_cuda.ICP_STEP.launches == before


def test_icp_step_args_mirror_the_kernel_struct():
    """``IcpStepArgs`` lists ``struct IcpStepArgs`` of the source field for
    field, in order and type (the kernel cannot be compiled here)."""
    src = icp_cuda.KERNEL_SOURCE.read_text()
    body = re.search(r"struct IcpStepArgs \{(.*?)\};", src, re.S).group(1)
    ctype = {"int": ctypes.c_int, "float": ctypes.c_float,
             "long long": ctypes.c_longlong}
    want = []
    for decl in re.sub(r"//[^\n]*", "", body).split(";"):
        decl = " ".join(decl.replace("const ", "").replace("*", " * ").split())
        if not decl:
            continue
        base = next(t for t in ("long long", "unsigned char", "unsigned",
                                "float", "int") if decl.startswith(t + " "))
        for name in decl[len(base):].split(","):
            want.append((name.replace("*", "").strip(),
                         ctypes.c_void_p if "*" in decl else ctype[base]))
    assert icp_cuda.IcpStepArgs._fields_ == want


def test_icp_step_modes_mirror_the_kernel():
    src = icp_cuda.KERNEL_SOURCE.read_text()
    assert "enum Mode { APPLY = 0, COARSE = 1, STEP = 2, FINAL = 3 };" in src
    assert icp_cuda.MODES == {"apply": 0, "coarse": 1, "step": 2, "final": 3}
    assert "BLOCK_ROWS = THREADS * RPT;" in src
    assert re.search(r"THREADS = (\d+);", src).group(1) == "256"
    assert re.search(r"RPT = (\d+);", src).group(1) == "4"
    assert icp_cuda.BLOCK_ROWS == 256 * 4
    assert re.search(r"PART = (\d+);", src).group(1) == str(icp_cuda.PART)


def test_icp_kernel_build_is_keyed_on_the_source():
    path = icp_cuda.library_path()
    assert path.parent == knn_cuda.BUILD_DIR
    assert path.name.startswith("libicp_step_") and path.suffix == ".so"
    assert path != knn_cuda.library_path()
    assert icp_cuda.ICP_STEP.library is icp_cuda.load_library
