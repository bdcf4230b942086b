"""The k-NN normals' search (``ops/knn_topk_cuda.knn_topk``): the kernel
against its plain version on the card, bit for bit, and the plain version
on the CPU against the benchmark's plain reference
(``slambench/reference/normals_knn.knn_rows``) and the port's ``knn.knn``.

This file imports neither JAX nor the repository's conftest, so it runs on a
GPU host without JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_knn_topk.py

Without a card the kernel tests skip (a CUDA kernel has no CPU mode); the
CPU tests run everywhere. Indices and squared distances must be EXACTLY
equal: both sides rank (bits(d2) << 32) | index with d2 = (dx*dx + dy*dy) +
dz*dz in round-to-nearest f32 without fused multiply-adds."""

import re
import subprocess

import numpy as np
import pytest
import torch

from lidar_slam_tpu_torch.ops import knn, knn_cuda, knn_topk_cuda, normals
from lidar_slam_tpu_torch.ops.knn_topk_cuda import knn_topk, knn_topk_torch
from lidar_slam_tpu_torch.utils import tracing
from lidar_slam_tpu_torch.utils.dataset import (
    generate_trajectory,
    generate_world,
    render_scan,
    route_half_for,
)
from lidar_slam_tpu_torch.utils.native import voxel_downsample_host
from slambench.reference.normals_knn import knn_rows

torch.set_num_threads(2)

N = 1000


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _frame(frame: int, max_range: float, raw: int, rows: int, pad: int):
    """A rendered scan voxelized (0.5 m, x-major voxel order) to at most
    ``rows`` rows, padded to ``pad`` with a masked tail."""
    half = route_half_for(60)
    world = generate_world(0, route_half=half, corridor=60.0)
    gt = generate_trajectory(60, half=half)
    rng = np.random.default_rng(frame)
    s = render_scan(world, gt[frame], rng, max_range=max_range, max_points=raw)
    v = voxel_downsample_host(s, 0.5, rows)
    pts = np.zeros((pad, 3), np.float32)
    pts[: len(v)] = v
    return torch.from_numpy(pts), torch.from_numpy(np.arange(pad) < len(v))


@pytest.fixture(scope="module")
def scans():
    """Two voxelized scans of consecutive frames, padded to 1,000 rows with
    a masked tail of 60 (the scans of ``test_torch_knn_normals.py``)."""
    half = route_half_for(60)
    world = generate_world(0, route_half=half)
    gt = generate_trajectory(60, half=half)
    rng = np.random.default_rng(5)
    out = []
    for f in (11, 12):
        s = render_scan(world, gt[f], rng, max_range=12.0, max_points=6000)
        v = voxel_downsample_host(s, 0.5, N - 60)
        pts = np.zeros((N, 3), np.float32)
        pts[: len(v)] = v
        out.append((torch.from_numpy(pts), torch.from_numpy(np.arange(N) < len(v))))
    return out


def _sets(idx: torch.Tensor) -> np.ndarray:
    return np.sort(idx.cpu().numpy(), axis=-1)


def _dup4(pts, mask):
    """Every valid point four times over (ties at every rank), then the
    masked tail."""
    n = int(mask.sum()) // 4
    dup = torch.zeros_like(pts)
    dup[: 4 * n] = pts[:n].repeat(4, 1)
    return dup, torch.arange(len(pts)) < 4 * n, n


# --- the plain version, on the CPU ------------------------------------------


@pytest.mark.parametrize("k", [5, 8, 20])
def test_plain_equals_the_reference_sets_on_valid_rows(scans, k):
    """On the valid rows, the neighbour sets of the benchmark's plain
    reference (valid rows alone, difference form, ties to the lower row)."""
    pts, mask = scans[0]
    valid = mask.nonzero()[:, 0]
    idx, d2 = knn_topk_torch(pts, mask, k)
    want = valid[knn_rows(pts[valid], k)]
    np.testing.assert_array_equal(_sets(idx[valid]), _sets(want))
    assert bool((d2[:, 1:] >= d2[:, :-1]).all())  # nearest first
    assert torch.equal(idx[valid, 0], valid.to(torch.int32))  # self first


@pytest.mark.parametrize("k", [8, 12, 20])
def test_plain_equals_knn_on_valid_rows(scans, k):
    """The same sets as the matrix-form ``knn.knn`` on every valid row of
    both scans (on these scans no k-th and (k+1)-th neighbour lie within the
    matrix form's rounding); the masked rows, queried at the sentinel here
    and at their own coordinates there, take other rows."""
    for pts, mask in scans:
        got, _ = knn_topk_torch(pts, mask, k)
        want, _ = knn.knn(pts, pts, mask, k=k)
        np.testing.assert_array_equal(_sets(got[mask]), _sets(want[mask]))
        assert int(got[mask].max()) < int(mask.sum())  # never a masked row


def test_plain_ties_keep_the_lower_index(scans):
    pts, mask, n = _dup4(*scans[0])
    idx, d2 = knn_topk_torch(pts, mask, 6, chunk=128)
    row = np.arange(4 * n)
    want = np.sort(np.stack([row % n + c * n for c in range(4)], 1), axis=1)
    np.testing.assert_array_equal(idx[: 4 * n, :4].numpy(), want)
    assert bool((d2[: 4 * n, :4] == 0).all())


def test_plain_with_fewer_valid_rows_than_k(scans):
    """Three valid rows, k = 8: each valid row takes the three, nearest
    first, then the lowest masked rows (all at the sentinel, equal d2)."""
    pts, _ = scans[0]
    mask = torch.zeros(N, dtype=torch.bool)
    mask[[4, 100, 700]] = True
    idx, d2 = knn_topk_torch(pts, mask, 8)
    for r in (4, 100, 700):
        assert sorted(idx[r, :3].tolist()) == [4, 100, 700]
        assert idx[r, 0] == r
        assert idx[r, 3:].tolist() == [0, 1, 2, 3, 5]
        assert len(set(d2[r, 3:].tolist())) == 1


def test_plain_lanes_equal_each_lane(scans):
    pts = torch.stack([s[0] for s in scans])
    mask = torch.stack([s[1] for s in scans])
    i_b, d_b = knn_topk_torch(pts, mask, 10, chunk=256)
    for b in range(2):
        i_1, d_1 = knn_topk_torch(pts[b], mask[b], 10, chunk=256)
        assert torch.equal(i_b[b], i_1) and torch.equal(d_b[b], d_1)


def test_knn_topk_runs_the_plain_version_on_the_cpu(scans):
    pts, mask = scans[0]
    before = knn_topk_cuda.KNN_TOPK.launches
    got = knn_topk(pts, mask, 8)
    want = knn_topk_torch(pts, mask, 8)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert knn_topk_cuda.KNN_TOPK.launches == before


@pytest.mark.parametrize("bad", ["k0", "k33", "float64", "mask_shape",
                                 "no_rows", "meta"])
def test_knn_topk_refuses_what_the_kernel_does_not_take(bad):
    pts, mask, k = torch.zeros((16, 3)), torch.ones(16, dtype=torch.bool), 4
    if bad == "k0":
        k = 0
    elif bad == "k33":
        k = 33
    elif bad == "float64":
        pts = pts.double()
    elif bad == "mask_shape":
        mask = mask[:8]
    elif bad == "no_rows":
        pts, mask = pts[:0], mask[:0]
    else:
        pts, mask = pts.to("meta"), mask.to("meta")
    with pytest.raises(ValueError):
        knn_topk(pts, mask, k)


def test_normals_count_chunks_and_no_kernel_on_the_cpu(scans):
    pts, mask = scans[0]
    tr = tracing.Tracer()
    with tr.bind(0):
        normals.estimate_normals(pts, mask, k=20)
    counters = tr.records()["counters"]
    assert counters["normals.knn_chunks"] == N // knn.knn_chunk(N, 20)
    assert "normals.knn_kernel" not in counters


def test_plan_splits_fill_the_card():
    """One 32,768-row lane on 132 SMs of 4 blocks: 128 row blocks x 4
    splits, one wave; every split holds at least one tile; a small cloud is
    one split."""
    assert knn_topk_cuda.plan(1, 32768, 132 * 4) == (4, 8)
    assert knn_topk_cuda.plan(2, 16384, 132 * 4) == (4, 4)
    assert knn_topk_cuda.plan(1, 997, 132 * 4) == (1, 1)
    for lanes, n in ((1, 32768), (3, 5000), (1, 4097), (2, 16384)):
        splits, per = knn_topk_cuda.plan(lanes, n, 132 * 3)
        tiles = -(-n // knn_topk_cuda.TILE)
        assert (splits - 1) * per < tiles <= splits * per


def test_kernel_build_is_keyed_on_the_source():
    path = knn_topk_cuda.library_path()
    assert path.parent == knn_cuda.BUILD_DIR
    assert path.name.startswith("libknn_topk_") and path.suffix == ".so"
    assert knn_topk_cuda.KERNEL_SOURCE.exists()


# --- the kernel, on the card -------------------------------------------------


def _kernel_equals_plain(pts, mask, k, dev):
    p, m = pts.to(dev), mask.to(dev)
    before = knn_topk_cuda.KNN_TOPK.launches
    got = knn_topk(p, m, k)
    assert knn_topk_cuda.KNN_TOPK.launches == before + 1  # every lane, one launch
    want = knn_topk_torch(p, m, k)
    assert got[0].shape == want[0].shape == (*pts.shape[:-1], k)
    assert got[0].dtype == torch.int32 and got[1].dtype == torch.float32
    assert torch.equal(got[0], want[0]), "indices differ"
    assert torch.equal(got[1], want[1]), "distances differ"
    return got


@pytest.mark.gpu
def test_kernel_equals_plain_on_a_rendered_32768_row_frame(cuda):
    pts, mask = _frame(20, 50.0, 65536, 32768, 32768)
    assert int(mask.sum()) > 30000
    _kernel_equals_plain(pts, mask, 20, cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1000, 997])
@pytest.mark.parametrize("k", [5, 8, 20, 25])
def test_kernel_equals_plain(cuda, scans, n, k):
    pts, mask = scans[0]
    _kernel_equals_plain(pts[:n], mask[:n], k, cuda)


@pytest.mark.gpu
def test_kernel_equals_plain_over_lanes(cuda, scans):
    pts = torch.stack([s[0] for s in scans])
    mask = torch.stack([s[1] for s in scans])
    got = _kernel_equals_plain(pts, mask, 12, cuda)
    for b in range(2):
        one = knn_topk(pts[b].to(cuda), mask[b].to(cuda), 12)
        assert torch.equal(got[0][b], one[0]) and torch.equal(got[1][b], one[1])


@pytest.mark.gpu
def test_kernel_equals_plain_over_two_16384_row_lanes(cuda):
    """Two lanes of a size the plan splits: each lane's splits merge into
    that lane's rows alone."""
    a = _frame(30, 50.0, 40000, 16384, 16384)
    b = _frame(31, 50.0, 30000, 16384, 16384)
    _kernel_equals_plain(torch.stack([a[0], b[0]]), torch.stack([a[1], b[1]]),
                         20, cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("k", [6, 20])
def test_kernel_ties_keep_the_lower_index(cuda, k):
    """Every point four times over in a split frame: ties at every rank,
    inside a split and across the splits' merge."""
    pts, mask = _frame(20, 50.0, 65536, 32768, 32768)
    pts, mask, n = _dup4(pts, mask)
    idx, _ = _kernel_equals_plain(pts, mask, k, cuda)
    row = torch.arange(4 * n)
    want = torch.sort(torch.stack([row % n + c * n for c in range(4)], 1),
                      dim=1).values
    assert torch.equal(idx[: 4 * n, :4].cpu().long(), want)


@pytest.mark.gpu
@pytest.mark.parametrize("valid", [3, 19])
def test_kernel_with_fewer_valid_rows_than_k(cuda, scans, valid):
    pts, _ = scans[0]
    mask = torch.zeros(N, dtype=torch.bool)
    mask[torch.randperm(N, generator=torch.Generator().manual_seed(valid))
         [:valid]] = True
    _kernel_equals_plain(pts, mask, 20, cuda)


@pytest.mark.gpu
def test_kernel_with_fewer_rows_than_k(cuda, scans):
    pts, mask = scans[0]
    _kernel_equals_plain(pts[:7], mask[:7], 12, cuda)


@pytest.mark.gpu
def test_normals_on_the_card_run_the_kernel_alone(cuda, scans, monkeypatch):
    """On CUDA tensors ``estimate_normals`` searches with one kernel launch
    and no ``torch.topk`` or ``torch.matmul`` call, counts
    ``normals.knn_kernel`` once and no chunks, and gives the CPU's normals
    up to the PCA's rounding on the card (99% of components within 1e-5)."""
    pts, mask = scans[0]
    want = normals.estimate_normals(pts, mask, k=20)

    def refuse(*a, **kw):
        raise AssertionError("a topk or matmul on the card's search path")

    monkeypatch.setattr(torch, "topk", refuse)
    monkeypatch.setattr(torch, "matmul", refuse)
    tr = tracing.Tracer()
    before = knn_topk_cuda.KNN_TOPK.launches
    with tr.bind(0):
        got = normals.estimate_normals(pts.to(cuda), mask.to(cuda), k=20)
    assert knn_topk_cuda.KNN_TOPK.launches == before + 1
    rec = tr.records()
    assert rec["counters"] == {"normals.knn_kernel": 1}
    assert [s.get("kernel") for s in rec["spans"] if s["name"] == "launch"] \
        == ["knn_topk"]
    gap = (got.cpu() - want).abs()
    assert float(torch.quantile(gap.flatten(), 0.99)) <= 1e-5
    assert torch.equal(got[~mask.to(cuda)].cpu(), want[~mask])


@pytest.mark.gpu
def test_kernel_builds_without_spills(cuda, tmp_path):
    """ptxas reports 0 bytes of spill for every instantiation (the list
    lengths 4, 8, 12, 16, 20 and 32)."""
    r = subprocess.run(
        [knn_cuda._nvcc(), *knn_cuda.NVCC_FLAGS, "-o", str(tmp_path / "t.so"),
         str(knn_topk_cuda.KERNEL_SOURCE)],
        capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr
    log = r.stdout + r.stderr
    spills = re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill loads", log)
    entries = re.findall(r"Compiling entry function '(\w*knn_topk_kernel\w*)'", log)
    lengths = {knn_topk_cuda.list_length(k) for k in range(1, 33)}
    assert lengths == {4, 8, 12, 16, 20, 32}
    assert len(entries) == len(lengths), log
    assert spills and all(s == ("0", "0") for s in spills), log
