"""The readers of the port's own spans (``metrics/_program_spans.py`` and
the five metrics that use it): on hand-made spans and device operations,
placement in the innermost span open at an operation's launch (its runtime
call) or, without one, at its start with the device clock's error taken
out by the kernels' launch spans, the K1/K2 check that returns nothing
where placement and launch counters disagree, and nothing without program
spans; on the card, a short fast drive under ``DeviceTrace`` whose K1
operations land in the ``icp`` spans that counted them."""

from __future__ import annotations

import dataclasses
from types import SimpleNamespace

import pytest
import torch

from slambench.harness import load_readers
from slambench.metrics import _program_spans as P

NEW = ("host_syncs_per_scan", "icp_launches_per_scan", "icp_device_ms",
       "normals_launches_per_scan", "normals_device_ms")
OFFSET = 1_000_000     # profiler ns = perf_counter ns + OFFSET


def _span(name, parent, frame, t0, t1, **extra):
    return dict(name=name, parent=parent, frame=frame, t0_ns=t0, t1_ns=t1,
                **extra)


def _spans(k1_frame1: int = 2, k1_launch_spans: int = 2):
    """Two frames on a host clock in ns: frame 0 without odometry, frame 1
    with an ICP of two iterations that counted ``k1_frame1`` K1 launches
    (``k1_launch_spans`` launch calls recorded), a loop tick whose verify
    ICP made one K2 launch, then finalize."""
    return [
        _span("push_scan", -1, 0, 0, 100),                       # 0
        _span("upload", 0, 0, 0, 10),                            # 1
        _span("sync", 1, 0, 2, 8, site="upload"),                # 2
        _span("step", 0, 0, 10, 100),                            # 3
        _span("normals", 3, 0, 20, 60),                          # 4
        _span("push_scan", -1, 1, 200, 500),                     # 5
        _span("upload", 5, 1, 200, 210),                         # 6
        _span("sync", 6, 1, 202, 208, site="upload"),            # 7
        _span("step", 5, 1, 210, 400),                           # 8
        _span("icp", 8, 1, 220, 300,
              launches={"match_slab": k1_frame1, "nn1": 0}),     # 9
        _span("iter", 9, 1, 225, 260),                           # 10
        _span("sync", 10, 1, 250, 260, site="icp.active"),       # 11
        _span("iter", 9, 1, 260, 290),                           # 12
        _span("sync", 12, 1, 280, 290, site="icp.active"),       # 13
        _span("normals", 8, 1, 310, 350),                        # 14
        _span("tick", 5, 1, 400, 500),                           # 15
        _span("icp", 15, 1, 410, 490, launches={"match_slab": 0, "nn1": 1}),
        _span("finalize", -1, -1, 600, 700),                     # 17
        _span("sync", 17, -1, 650, 660, site="pg.cost"),         # 18
        _span("launch", 16, 1, 415, 418, kernel="nn1"),          # 19
    ] + [_span("launch", p, 1, t, t + 2, kernel="match_slab")
         for p, t in ((10, 227), (12, 261))[:k1_launch_spans]]


def _ops():
    """Device operations on the profiler's clock, sorted by start."""
    at = [("normals_op", 30, 50), ("Memcpy HtoD", 205, 207),
          ("aten_mul", 222, 240), ("match_slab_kernel", 230, 248),
          ("match_slab_kernel", 262, 280), ("aten_add", 300, 301),
          ("normals_op", 320, 330), ("normals_op", 325, 345),
          ("nn1_kernel", 420, 470), ("finalize_op", 610, 640)]
    return [(n, a + OFFSET, b + OFFSET) for n, a, b in at]


def _launches():
    """The host's runtime call of each of :func:`_ops`, on the profiler's
    clock: before the operation's start, each K1 and K2 inside its launch
    span."""
    at = [25, 203, 221, 228, 262, 299, 315, 316, 416, 605]
    return [t + OFFSET for t in at]


def _shift(ops, ns):
    return [(n, a + ns, b + ns) for n, a, b in ops]


def _run(spans, ops, trace_entry=True, launch_ns=None):
    counters = {"trace": {"spans": spans, "counters": {}}} if trace_entry else {}
    window = SimpleNamespace(profiled_counters=counters)
    trace = SimpleNamespace(ops=ops, offset_ns=OFFSET, t0=0.0, t1=1e-6,
                            launch_ns=launch_ns or [])
    return SimpleNamespace(window=window, trace=trace)


def test_place_finds_the_innermost_open_span():
    starts = [a - OFFSET for _, a, _ in _ops()]
    assert P.place(starts, _spans()) == [4, 7, 9, 10, 21, 9, 14, 14, 16, 17]
    # the launch spans bound the clock's error by 3, 1 and 5 ns: every
    # operation moves 1 ns earlier, and the two K1 that start while their
    # launch calls are open land in those calls' spans
    p = P.placement(_run(_spans(), _ops()))
    assert p.bounds == [1, 1, 1]
    assert p.where == [4, 7, 9, 20, 21, 9, 14, 14, 16, 17]


def test_device_clock_error_is_taken_out():
    """A device clock 50 ns late (or 40 ns early) moves the K1 operations
    out of their iterations on the raw offset; the launch anchors put every
    operation back, and the readers read what they read without it."""
    readers = load_readers()
    want = {k: readers[k].read(_run(_spans(), _ops())) for k in NEW}
    for ns in (50, -40):
        run = _run(_spans(), _shift(_ops(), ns))
        raw = P.place([a - OFFSET for _, a, _ in run.trace.ops], _spans())
        assert raw[3:5] != [20, 21]
        assert P.placement(run).where == [4, 7, 9, 20, 21, 9, 14, 14, 16, 17]
        assert {k: readers[k].read(run) for k in NEW} == want


@pytest.mark.parametrize("step", [(0, 0), (50, 50), (-2_000, 1_000)])
def test_launches_place_operations_on_any_device_clock(step):
    """With each operation's runtime call known, an operation lands in the
    span open at its launch, whatever the device clock does: late, or
    stepping ahead halfway through the drive by more than a span lasts,
    which the launch anchors cannot take out; the readers read what they
    read on the device's true clock."""
    readers = load_readers()
    want = {k: readers[k].read(_run(_spans(), _ops())) for k in NEW}
    early, late = step
    ops = _shift(_ops()[:5], early) + _shift(_ops()[5:], late)
    run = _run(_spans(), ops, launch_ns=_launches())
    p = P.placement(run)
    # K1 and K2 land in their launch calls' spans
    assert p.where == [4, 7, 9, 20, 21, 9, 14, 14, 19, 17]
    assert P.icp_kernel_counts(p)[2] == 0
    assert {k: readers[k].read(run) for k in NEW} == want
    # an idle gap is the host's where it launched the operation that ended it
    assert p.gap_host(ops[3][1], OFFSET) == 228


def test_launches_place_operations_without_launch_spans():
    """Where every operation has its runtime call, a K1 launch call that
    the program did not record (no anchor to pair) takes nothing away."""
    readers = load_readers()
    want = {k: readers[k].read(_run(_spans(), _ops())) for k in NEW}
    run = _run(_spans(k1_launch_spans=1), _ops(), launch_ns=_launches())
    assert P.placement(run).anchors == []
    assert {k: readers[k].read(run) for k in NEW} == want
    # one operation without its call: the anchors are needed, and fail
    part = _launches()[:-1] + [None]
    assert P.placement(_run(_spans(k1_launch_spans=1), _ops(),
                            launch_ns=part)) is None


def test_device_trace_pairs_operations_with_runtime_calls():
    """``device_ops`` on the host profiler (no card): operations sorted by
    start, and a launch beside each, None where none is known."""
    from slambench.trace import DeviceTrace

    with DeviceTrace(activities=("cpu",)) as tr:
        torch.ones(64).add(1).sum()
    assert tr.ops and [a for _, a, _ in tr.ops] == sorted(a for _, a, _ in tr.ops)
    assert tr.launch_ns == [None] * len(tr.ops)


def test_readers_on_hand_made_spans():
    readers = load_readers()
    run = _run(_spans(), _ops())
    got = {k: readers[k].read(run) for k in NEW}
    # syncs in the two scans: 2 uploads, 2 icp.active (finalize's left out)
    assert got["host_syncs_per_scan"] == 2.0
    # the odometry ICP of frame 1 alone (the tick's ICP is not under step):
    # mul, two K1 and the add right at its end
    assert got["icp_launches_per_scan"] == 4.0
    assert got["icp_device_ms"] == ((248 - 222) + (280 - 262) + 1) / 1e6
    # normals in both frames: union 20 ns + 25 ns over two frames
    assert got["normals_launches_per_scan"] == 1.5
    assert got["normals_device_ms"] == (20 + 25) / 1e6 / 2


def test_placement_check_refuses_when_launch_counters_disagree():
    readers = load_readers()
    # the icp span counted three K1 launches; two ran
    run = _run(_spans(k1_frame1=3), _ops())
    assert P.icp_kernel_counts(P.placement(run)) == (
        {"match_slab": 2, "nn1": 1}, {"match_slab": 3, "nn1": 1}, 1)
    for k in NEW[1:]:
        assert readers[k].read(run) is None, k
    # a launch call went unrecorded: operations cannot be paired
    run = _run(_spans(k1_launch_spans=1), _ops())
    assert P.placement(run) is None
    for k in NEW[1:]:
        assert readers[k].read(run) is None, k


def test_readers_give_nothing_without_program_spans():
    readers = load_readers()
    for run in (_run(_spans(), _ops(), trace_entry=False), _run([], _ops())):
        assert all(readers[k].read(run) is None for k in NEW)
    bare = _run(_spans(), _ops())
    bare.trace = None
    assert all(readers[k].read(bare) is None for k in NEW)


@pytest.mark.gpu
def test_k1_placement_on_card():
    """A short fast drive under ``DeviceTrace``: every K1 launch an ``icp``
    span counted is a ``match_slab`` operation placed in that span."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the port's kernels have no CPU mode")
    from lidar_slam_tpu_torch.models.pipeline import SlamEngine

    from slambench.cell import load_cell
    from slambench.harness import prepare_scans
    from slambench.trace import DeviceTrace
    from slambench.traffic.generate import make_drive

    cell = load_cell("kitti00-fast.drive")
    t = dataclasses.replace(cell.traffic, frames=72)
    t = dataclasses.replace(t, laps=t.frames // t.lap_frames)
    cfg = cell.slam_config()
    raw, _ = make_drive(t, 2**31 + 77, "cuda")
    scans = prepare_scans(cfg, raw)
    engine = SlamEngine(cfg)
    for s in scans[:3]:          # build the kernels before the trace
        engine.push_scan(s)
    with DeviceTrace() as tr:
        engine.reset()
        for f, s in enumerate(scans):
            engine.push_scan(s)
            engine.state.poses[f].cpu()
    spans = engine.metrics()["trace"]["spans"]
    run = SimpleNamespace(window=SimpleNamespace(
        profiled_counters={"trace": {"spans": spans}}), trace=tr)
    placed, launched, bad = P.icp_kernel_counts(P.placement(run))
    assert launched["match_slab"] >= len(scans) - 1
    assert placed["match_slab"] == launched["match_slab"] and bad == 0
