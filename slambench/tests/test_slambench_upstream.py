"""The upstream deployment (``configs/kitti00-upstream.json``) and the
readers of its k-NN normals, on the CPU: the configuration is
``kitti00-fidelity``'s but for ``normal_method``; the port's k-NN normals
(``ops/normals.estimate_normals``) agree with the plain reference's
(``reference/normals_knn.py``) on seeded clouds; and
``knn_normals_roofline`` and ``knn_search_device_ms`` read hand-made spans
and device operations as counted by hand."""

from __future__ import annotations

import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from lidar_slam_tpu_torch.ops.normals import estimate_normals

from slambench.cell import CONFIG_DIR, load_cell
from slambench.harness import load_readers
from slambench.reference import normals as rn
from slambench.reference.config import namespace
from slambench.reference.normals_knn import knn_normals
from slambench.roofline import PEAK_FP32_FLOPS, PEAK_HBM_BYTES

K = 20
OFFSET = 1_000_000     # profiler ns = perf_counter ns + OFFSET


def _config(name: str) -> dict:
    return json.loads((CONFIG_DIR / f"{name}.json").read_text())


def test_slambench_upstream_is_fidelity_but_for_its_normals():
    up, fid = _config("kitti00-upstream"), _config("kitti00-fidelity")
    a, b = up["slam_config"], fid["slam_config"]
    assert a.keys() == b.keys()
    assert {k for k in a if a[k] != b[k]} == {"normal_method"}
    assert (a["normal_method"], b["normal_method"]) == ("knn", "adaptive")
    assert a["icp"]["normal_k"] == K and a["normal_stride"] == 1
    for key in ("reduced", "source_values", "assumed", "raw_points_per_scan"):
        assert up[key] == fid[key], key
    assert len(up["source"]) <= 200 and "icp.hpp:23-67" in up["source"]
    cell = load_cell("kitti00-upstream.drive")
    fcell = load_cell("kitti00-fidelity.drive")
    assert cell.traffic == fcell.traffic and cell.chips == 1
    assert cell.slam_config().normal_method == "knn"


def _cloud(seed: int, n: int = 1800, pad: int = 248):
    """Rows of a street scene at LiDAR-like noise (a ground plane, a wall,
    a pole), in random order with padded rows among them, masked out."""
    g = np.random.default_rng(seed)
    m = n // 3
    ground = np.c_[g.uniform(-10, 10, (m, 2)), g.normal(0, 0.02, m)]
    wall = np.c_[g.uniform(-10, 10, m), 6 + g.normal(0, 0.02, m), g.uniform(0, 4, m)]
    t = g.uniform(0, 2 * np.pi, n - 2 * m)
    pole = np.c_[2 + 0.15 * np.cos(t), 1 + 0.15 * np.sin(t), g.uniform(0, 5, n - 2 * m)]
    pts = np.concatenate([ground, wall, pole, np.zeros((pad, 3))]).astype(np.float32)
    order = g.permutation(len(pts))
    mask = np.arange(len(pts)) < n
    return torch.from_numpy(pts[order]), torch.from_numpy(mask[order])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_slambench_port_knn_normals_hold_the_reference(seed):
    """The port's search ranks distances in the matrix form |s|^2 + |t|^2 -
    2 s.t and the reference in the difference form, so a row whose k-th and
    (k+1)-th neighbours lie within a rounding of each other may take the
    other one, and its normal moves by up to tens of degrees (on the H100,
    16-24 such rows in a 32,768-row frame; here 0 or 1 in 1,800). Hence a
    share of rows off, at most 1%, each off by more than 0.01 degree; the
    other rows differ only by the covariance's float32 rounding, hence the
    99th percentile under 1e-3 degree (2e-5 to 3e-5 here)."""
    pts, mask = _cloud(seed)
    cfg = namespace(dict(normal_method="knn", icp=dict(normal_k=K)))
    ref = knn_normals(pts, mask, cfg)
    got = estimate_normals(pts, mask, k=K)
    up = torch.tensor([0.0, 0.0, 1.0])
    assert torch.equal(got[~mask], up.expand(int((~mask).sum()), 3))
    assert torch.equal(ref[~mask], got[~mask])
    a = rn.angle_deg(got[mask], ref[mask])
    assert float(torch.quantile(a, 0.99)) < 1e-3
    assert float((a > 1e-2).double().mean()) <= 0.01
    assert (got[mask, 2] >= 0).all()


def _span(name, parent, frame, t0, t1, **extra):
    return dict(name=name, parent=parent, frame=frame, t0_ns=t0, t1_ns=t1,
                **extra)


def _spans(knn_spans: bool = True, k1_counted: int = 1):
    """Two frames on a host clock in ns: frame 0 (``init_frame``) with its
    normals, frame 1 with an ICP of one K1 launch, then its normals; each
    normals span holds a ``knn`` span unless ``knn_spans`` is false (the
    program before the span existed)."""
    s = [
        _span("push_scan", -1, 0, 0, 100),                               # 0
        _span("step", 0, 0, 10, 100),                                    # 1
        _span("normals", 1, 0, 20, 60),                                  # 2
        _span("push_scan", -1, 1, 200, 500),                             # 3
        _span("step", 3, 1, 210, 400),                                   # 4
        _span("icp", 4, 1, 220, 300,
              launches={"match_slab": k1_counted, "nn1": 0}),            # 5
        _span("launch", 5, 1, 227, 229, kernel="match_slab"),            # 6
        _span("normals", 4, 1, 310, 360),                                # 7
    ]
    if knn_spans:
        s += [_span("knn", 2, 0, 22, 40), _span("knn", 7, 1, 312, 330)]
    return s


# (name, device start, device end, host launch) on the host's clock: in
# frame 0 a search operation (20 ns) and a PCA operation (6 ns); in frame
# 1 two overlapping search operations (a union of 25 ns) and a PCA one (6)
OPS = [("knn_op", 30, 50, 25), ("pca_op", 52, 58, 45),
       ("match_slab_kernel", 230, 248, 228), ("knn_op", 320, 340, 315),
       ("knn_op", 330, 345, 320), ("pca_op", 346, 352, 335)]
NPTS = [10, 2000]      # frame 0's rows bound by bytes, frame 1's by work
N = 4096


def _run(method="knn", knn_spans=True, k1_counted=1):
    trace = SimpleNamespace(
        ops=[(n, a + OFFSET, b + OFFSET) for n, a, b, _ in OPS],
        launch_ns=[t + OFFSET for *_, t in OPS], offset_ns=OFFSET,
        t0=0.0, t1=1e-6)
    counters = {"trace": {"spans": _spans(knn_spans, k1_counted), "counters": {}},
                "frame_npts": np.array(NPTS, dtype=np.int32)}
    return SimpleNamespace(config=SimpleNamespace(normal_method=method, max_points=N),
                           window=SimpleNamespace(profiled_counters=counters),
                           trace=trace)


def test_slambench_knn_readers_on_hand_made_spans():
    readers = load_readers()
    roof, search = readers["knn_normals_roofline"], readers["knn_search_device_ms"]
    # the search: 20 ns in frame 0, the union 320-345 in frame 1
    assert search.read(_run()) == (20 + 25) / 1e6 / 2
    # frame 0: 10^2 distances take less than its 4,096 x 24 bytes at peak;
    # frame 1: 2,000^2 distances of 8 operations; over the normals spans'
    # busy time, 26 + 31 ns
    least = N * 24 / PEAK_HBM_BYTES + 8 * 2000**2 / PEAK_FP32_FLOPS
    assert roof.read(_run()) == pytest.approx(100 * least / 57e-9, rel=1e-12)
    # the stage is the whole normals span, with or without a knn span in it
    assert roof.read(_run(knn_spans=False)) == roof.read(_run())
    assert readers["normals_device_ms"].read(_run()) == 57 / 1e6 / 2


def test_slambench_knn_readers_give_nothing_where_they_cannot_read():
    readers = load_readers()
    roof, search = readers["knn_normals_roofline"], readers["knn_search_device_ms"]
    for r in (roof, search):
        assert r.read(_run(method="adaptive")) is None
        assert r.read(_run(k1_counted=2)) is None      # the placement check
    # a program without the knn span: the search reads nothing, the stage
    # still reads
    assert search.read(_run(knn_spans=False)) is None
    assert roof.read(_run(knn_spans=False)) is not None
    bare = _run()
    bare.trace = None
    assert roof.read(bare) is None and search.read(bare) is None
