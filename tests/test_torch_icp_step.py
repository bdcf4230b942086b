"""The ICP's one loop on the CPU and the fused iteration's glue
(``ops/icp_cuda.py``, ``csrc/icp_step.cu``): CPU tensors run the loop with
the kernel's plain version (``icp_step_torch``) as the launch and launch no
kernel; each lane of that loop matches the JAX package's ICP on that lane,
and the coarse warm start matches the JAX package's hoisted coarse phase;
the launch wrapper refuses what the kernel does not take; its argument
block mirrors the kernel's struct. The kernel itself is held to
``icp_step_torch`` on the card (``tests/test_torch_kernels.py``)."""

import ctypes
import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidar_slam_tpu.config import ICPConfig as JICPConfig
from lidar_slam_tpu.ops import icp as jicp
from lidar_slam_tpu.ops import knn_pallas
from lidar_slam_tpu.ops import se3 as jse3
from lidar_slam_tpu.ops.knn import nn1 as jnn1
from lidar_slam_tpu.types import PointCloud as JPointCloud
from lidar_slam_tpu_torch.config import ICPConfig
from lidar_slam_tpu_torch.ops import cuda_lib, icp, icp_cuda, knn_cuda
from lidar_slam_tpu_torch.types import PointCloud
from lidar_slam_tpu_torch.utils import tracing

torch.set_num_threads(2)

CONFIGS = {
    "converging": dict(max_iterations=6, tolerance=1e-4),
    "budget": dict(max_iterations=3, tolerance=1e-9),
    "coarse": dict(max_iterations=8, tolerance=1e-5, sample_points=300,
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


@functools.lru_cache(maxsize=None)
def _jax_icp(backend, cfg):
    """The JAX package's ICP on one lane with the counterpart of the port's
    backend (K1: the slab Pallas kernel in interpret mode; K2: its exact
    1-NN), jitted once per backend and configuration."""
    nn1_fn = None if backend == "k2" else knn_pallas.make_slab_pallas_backend(
        ts=64, window=256, interpret=True)
    config = JICPConfig(**CONFIGS[cfg])

    @jax.jit
    def run(src, smask, tgt, tmask, nrm, inactive):
        return jicp.icp_point_to_plane(
            JPointCloud(src, smask), JPointCloud(tgt, tmask), nrm, config,
            nn1_fn=nn1_fn, inactive=inactive)

    return run


def _close(a_torch, b_jax, **kw):
    np.testing.assert_allclose(a_torch.numpy(), np.asarray(b_jax), **kw)


@pytest.mark.parametrize("backend", ["k1", "k2"])
def test_cpu_icp_launches_no_kernel_and_runs_one_loop(backend):
    """CPU tensors take the one loop with the plain step: no kernel
    launches, one ``iter`` span a pass, one ``icp.active`` read before the
    loop and one a pass, one ``icp.need`` read."""
    src, tgt, nrm = _case()
    before = [k.launches for k in knn_cuda.KERNELS + icp_cuda.KERNELS]
    tr = tracing.Tracer()
    with tr.bind(0):
        res = icp.icp_point_to_plane(src, tgt, nrm,
                                     ICPConfig(**CONFIGS["converging"]),
                                     nn1_fn=_backend(backend))
    assert [k.launches for k in knn_cuda.KERNELS + icp_cuda.KERNELS] == before
    spans = tr.records()["spans"]
    span = next(s for s in spans if s["name"] == "icp")
    assert span["launches"] == {"match_slab": 0, "nn1": 0, "icp_step": 0}
    passes = int(res.num_iterations.max())
    assert passes > 0
    assert sum(s["name"] == "iter" for s in spans) == passes
    assert tr.counters == {"host_syncs.icp.active": passes + 1,
                           "host_syncs.icp.need": 1}


@pytest.mark.parametrize("inactive", [False, True])
@pytest.mark.parametrize("cfg", sorted(CONFIGS))
@pytest.mark.parametrize("backend", ["k1", "k2"])
def test_cpu_icp_lanes_match_jax(backend, cfg, inactive):
    """Each lane of a 3-lane ICP on the CPU (the one loop: apply, search,
    plain step, one flag read an iteration) against the JAX package's
    ``icp_point_to_plane`` on that lane, with the same backend, config and
    ``inactive``: the same iterations and convergence, transforms within
    1e-5 and errors within 1e-4 relative (the 6 x 6 normal equations sum in
    another order); and one ``iter`` span for each pass of the loop."""
    src, tgt, nrm = _case()
    skip = torch.tensor([False, True, False]) if inactive else None
    tr = tracing.Tracer()
    with tr.bind(0):
        res = icp.icp_point_to_plane(src, tgt, nrm, ICPConfig(**CONFIGS[cfg]),
                                     nn1_fn=_backend(backend), inactive=skip)
    run = _jax_icp(backend, cfg)
    for k in range(3):
        want = run(*(x[k].numpy() for x in (src.points, src.mask, tgt.points,
                                             tgt.mask, nrm)),
                   skip is not None and bool(skip[k]))
        assert int(res.num_iterations[k]) == int(want.num_iterations)
        assert bool(res.converged[k]) == bool(want.converged)
        _close(res.transformation[k], want.transformation, atol=1e-5)
        _close(res.final_error[k], want.final_error, rtol=1e-4)
        _close(res.error_history[k], want.error_history, rtol=1e-4)
    if inactive:
        assert int(res.num_iterations[1]) == 0 and bool(res.converged[1])
    spans = tr.records()["spans"]
    assert sum(s["name"] == "iter" for s in spans) == int(
        res.num_iterations.max())


@functools.partial(jax.jit, static_argnums=5)
def _jax_coarse_phase(pts, mask, cloud, cmask, normals, iterations):
    """The JAX package's hoisted coarse phase of loop verification
    (``lidar_slam_tpu/models/loop_closure.py:310-330``) on one lane,
    written out: its exact 1-NN, ``iterations`` Gauss-Newton steps composed
    every pass, then the plane RMS error at the result."""

    def match_query(cur):
        idx, _ = jnn1(cur, cloud, cmask)
        return cloud[idx], normals[idx]

    T = jnp.eye(4, dtype=jnp.float32)
    for _ in range(iterations):
        cur = jse3.apply(T, pts)
        matched, nrm = match_query(cur)
        delta = jicp.solve_point_to_plane(cur, matched, nrm, mask, 1e-9)
        T = jse3.compose(delta, T)
    cur = jse3.apply(T, pts)
    matched, nrm = match_query(cur)
    w = mask.astype(jnp.float32)
    return T, jicp._plane_error(cur, matched, nrm, w,
                                jnp.maximum(jnp.sum(w), 1.0))


@pytest.mark.parametrize("iterations", [1, 3])
def test_coarse_icp_matches_jax_coarse_phase(iterations):
    """The coarse warm start of loop verification on the CPU (apply, coarse
    per pass; apply, final for the error; the plain step) against the JAX
    package's coarse phase on each lane: transforms within 1e-5, errors
    within 1e-4 relative."""
    src, tgt, nrm = _case(seed=1)
    T0 = torch.eye(4).expand(3, 4, 4)
    match = icp._matcher(knn_cuda.nn1, tgt.points, tgt.mask, nrm)
    T, err = icp.coarse_icp(T0, src, match, iterations, 1e-9)
    assert not torch.equal(T, T0)
    for k in range(3):
        T_j, err_j = _jax_coarse_phase(
            *(x[k].numpy() for x in (src.points, src.mask, tgt.points,
                                     tgt.mask, nrm)), iterations)
        _close(T[k], T_j, atol=1e-5)
        _close(err[k], err_j, rtol=1e-4)


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
    src = icp_cuda.LIBRARY.source.read_text()
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
    src = icp_cuda.LIBRARY.source.read_text()
    assert "enum Mode { APPLY = 0, COARSE = 1, STEP = 2, FINAL = 3 };" in src
    assert icp_cuda.MODES == {"apply": 0, "coarse": 1, "step": 2, "final": 3}
    assert "BLOCK_ROWS = THREADS * RPT;" in src
    assert re.search(r"THREADS = (\d+);", src).group(1) == "256"
    assert re.search(r"RPT = (\d+);", src).group(1) == "4"
    assert icp_cuda.BLOCK_ROWS == 256 * 4
    assert re.search(r"PART = (\d+);", src).group(1) == str(icp_cuda.PART)


def test_icp_kernel_build_is_keyed_on_the_source():
    path = icp_cuda.LIBRARY.path
    assert path.parent == cuda_lib.BUILD_DIR
    assert path.name.startswith("libicp_step_") and path.suffix == ".so"
    assert path != knn_cuda.LIBRARY.path
    assert icp_cuda.ICP_STEP.library is icp_cuda.LIBRARY
