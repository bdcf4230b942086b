"""The reference's normal stages on the CPU: the upstream's k-NN normals
(``reference/normals_knn.py``) held to a float64 NumPy brute force, the
one-radius stage to a plane's own normal and to the adaptive stage's
moment pass, and the output check's choice of stage by the
configuration's ``normal_method``, which judges a drive of each method
to a verdict."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from slambench import check, harness
from slambench.reference import normals as rn
from slambench.reference import normals_knn as rk
from slambench.reference.config import namespace
from slambench.reference.prec import FP32
from slambench.tests import tiny
from slambench.traffic.generate import make_drive

K = 20


def _brute(pts: np.ndarray, mask: np.ndarray, k: int):
    """Each valid row's k nearest valid rows (ties to the lower index) and
    its normal, in float64, one row at a time."""
    valid = np.flatnonzero(mask)
    v = pts[valid].astype(np.float64)
    sets, normals = {}, np.tile([0.0, 0.0, 1.0], (len(pts), 1))
    k = min(k, len(valid))
    for i, row in zip(valid, v):
        d2 = ((v - row) ** 2).sum(1)
        near = np.lexsort((np.arange(len(v)), d2))[:k]
        sets[i] = set(valid[near].tolist())
        if k < 3:
            continue
        nb = v[near] - v[near].mean(0)
        n = np.linalg.eigh(nb.T @ nb / k)[1][:, 0]
        normals[i] = -n if n[2] < 0 else n
    return sets, normals


def _cfg(**kw):
    base = dict(normal_method="knn", icp=dict(normal_k=K), normal_stride=1,
                normal_radius=0.0, voxel_size=0.5, normal_window=0)
    base.update(kw)
    return namespace(base)


def _lattice(seed: int, n: int = 400):
    """A bumpy 3-D lattice at quarter-metre steps (exact squared distances,
    so many rows tie at the k-th place), a share of it masked out, the
    masked rows moved onto valid ones."""
    g = np.random.default_rng(seed)
    ij = g.choice(24 * 24, size=n, replace=False)
    x, y = (ij // 24) * 0.25, (ij % 24) * 0.25
    z = 0.25 * np.round(np.sin(x) + 0.5 * np.cos(1.3 * y))
    pts = np.stack([x, y, z], 1).astype(np.float32)
    mask = g.random(n) > 0.2
    pts[~mask] = pts[mask][: (~mask).sum()]
    return pts, mask


def _angles(a, b):
    return rn.angle_deg(torch.as_tensor(a), torch.as_tensor(b)).numpy()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_slambench_knn_normals_hold_a_float64_brute_force(seed):
    pts, mask = _lattice(seed)
    sets, want = _brute(pts, mask, K)
    valid = np.flatnonzero(mask)
    rows = rk.knn_rows(torch.from_numpy(pts[valid]), K).numpy()
    got_sets = {int(valid[r]): set(valid[rows[r]].tolist()) for r in range(len(valid))}
    assert got_sets == sets
    d2 = ((pts[valid, None] - pts[None, valid]) ** 2).sum(-1)
    kth = np.sort(d2, 1)[:, K - 1]
    assert ((d2 <= kth[:, None]).sum(1) > K).sum() > 20     # ties across the k-th
    got = rk.knn_normals(torch.from_numpy(pts), torch.from_numpy(mask), _cfg()).numpy()
    assert np.array_equal(got[~mask], np.tile([0.0, 0.0, 1.0], ((~mask).sum(), 1)))
    assert _angles(got[mask], want[mask]).max() < 1e-3
    assert (got[mask, 2] >= 0).all()


def test_slambench_knn_normals_of_under_three_neighbours():
    g = np.random.default_rng(3)
    pts = g.normal(size=(12, 3)).astype(np.float32)
    for n_valid in (0, 1, 2):
        mask = np.zeros(12, bool)
        mask[[4, 9][:n_valid]] = True
        got = rk.knn_normals(torch.from_numpy(pts), torch.from_numpy(mask), _cfg())
        assert torch.equal(got, torch.tensor([0.0, 0.0, 1.0]).expand(12, 3))
    mask = np.zeros(12, bool)
    mask[[1, 4, 9]] = True          # three rows: each has all three
    sets, want = _brute(pts, mask, K)
    got = rk.knn_normals(torch.from_numpy(pts), torch.from_numpy(mask), _cfg()).numpy()
    assert _angles(got[mask], want[mask]).max() < 1e-3


def _plane(seed: int, n: int = 3000):
    """Noisy rows of the plane z = 0.3 x - 0.2 y + 1, x-sorted, with padded
    rows at the end; and its unit normal turned up."""
    g = np.random.default_rng(seed)
    xy = g.uniform(-12.0, 12.0, size=(n, 2))
    z = 0.3 * xy[:, 0] - 0.2 * xy[:, 1] + 1.0 + g.normal(0, 0.01, n)
    pts = np.concatenate([np.stack([xy[:, 0], xy[:, 1], z], 1)[np.argsort(xy[:, 0])],
                          np.zeros((96, 3))]).astype(np.float32)
    mask = np.arange(len(pts)) < n
    nrm = np.array([-0.3, 0.2, 1.0]) / np.linalg.norm([-0.3, 0.2, 1.0])
    return torch.from_numpy(pts), torch.from_numpy(mask), nrm


@pytest.mark.parametrize("stride,window", [(1, 0), (1, 512), (2, 512)])
def test_slambench_radius_normals_of_a_noisy_plane(stride, window):
    pts, mask, nrm = _plane(stride + window)
    cfg = _cfg(normal_method="radius", normal_radius=1.5, normal_stride=stride,
               normal_window=window)
    got = rn.radius_normals(pts, mask, cfg)
    a = _angles(got[mask].numpy(), np.tile(nrm, (int(mask.sum()), 1)))
    assert np.quantile(a, 0.99) < 2.0 and a.max() < 10.0
    assert (got[mask, 2] > 0).all()
    assert torch.equal(got[~mask], torch.tensor([0.0, 0.0, 1.0]).expand(96, 3))
    if stride == 1:
        pts_m = torch.where(mask[:, None], pts, torch.full_like(pts, rn.SENTINEL))
        r = torch.full((len(pts),), 1.5)
        same = rn._radius_normals(pts_m, mask, r, window or len(pts), FP32)
        assert torch.equal(got, same)
    else:
        one = rn.radius_normals(pts[::stride], mask[::stride],
                                _cfg(normal_radius=1.5, normal_window=window))
        assert torch.equal(got[mask], torch.repeat_interleave(one, stride, 0)[mask])


def test_slambench_radius_stage_defaults_to_the_voxel_radius():
    cfg = _cfg(normal_method="radius", normal_radius=0.0, voxel_size=0.5)
    assert rn.normal_radius(cfg) == 1.2


@pytest.fixture(scope="module")
def drive(tmp_path_factory):
    torch.set_num_threads(4)
    root = tmp_path_factory.mktemp("tiny")
    cell = tiny.load(root, tiny.write_cell(root, "tiny-fidelity", 4))
    raw, _ = make_drive(cell.traffic, 2**31 + 77, "cpu")
    return cell, raw


@pytest.mark.parametrize("method,stage", [("adaptive", rn.adaptive_normals),
                                          ("radius", rn.radius_normals),
                                          ("knn", rk.knn_normals)])
def test_slambench_check_takes_the_configured_normal_stage(drive, method, stage):
    cell, raw = drive
    cfg = namespace(dict(cell.config["slam_config"], normal_method=method))
    ref = check.Reference(cfg, raw, "cpu")
    pts, mask = ref.clouds
    for f in (0, 3):
        assert torch.equal(ref.normals(f), stage(pts[f], mask[f], cfg))


@pytest.mark.parametrize("change,named", [(dict(host_normals=True), "host_normals"),
                                          (dict(normal_method="pca"), "'pca'")])
def test_slambench_check_names_a_missing_normal_stage(drive, change, named):
    cell, raw = drive
    cell = dataclasses.replace(cell, config=dict(
        cell.config, slam_config=dict(cell.config["slam_config"], **change)))
    with pytest.raises(NotImplementedError, match=named):
        check.judge(cell, raw, None, 1, "cpu")


@pytest.mark.parametrize("method", ["radius", "knn"])
def test_slambench_judge_reaches_a_verdict_under_each_normal_method(tmp_path, method):
    from lidar_slam_tpu_torch.models.pipeline import SlamEngine
    from slambench.window import Window, drive as run_drive

    torch.set_num_threads(4)
    cell = tiny.load(tmp_path, tiny.write_cell(tmp_path, "tiny-fidelity", 8))
    cell.config["slam_config"]["normal_method"] = method
    raw, _ = make_drive(cell.traffic, 2**31 + 78, "cpu")
    engine = SlamEngine(cell.slam_config(), device="cpu")
    assert engine.config.normal_method == method
    run_drive(engine, harness.prepare_scans(engine.config, raw), Window(), 0)
    ok, numbers = check.judge(cell, raw, check.ProgramOutputs.from_engine(engine),
                              2**31 + 78, "cpu")
    assert isinstance(ok, bool) and [n for n, _, _ in numbers] == list(check.NUMBERS)
    assert all(np.isfinite(v) for _, v, _ in numbers)
