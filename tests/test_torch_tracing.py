"""The port's tracer (``utils/tracing.py``) in ``SlamEngine``, at tiny shapes
on the CPU: with tracing off the engine's outputs are those of a traced
run and nothing is recorded; traced, every frame has its spans, nested on
one clock, the odometry ICP's iterations and host syncs agree with the
engine's own counters, an active ``torch.profiler`` session turns tracing
on, and ``finalize(timing=)`` keeps its keys."""

import numpy as np
import pytest
import torch

from lidar_slam_tpu_torch import config
from lidar_slam_tpu_torch.models import pipeline
from lidar_slam_tpu_torch.utils import tracing
from lidar_slam_tpu_torch.utils.dataset import (
    generate_trajectory,
    generate_world,
    render_scan,
    route_half_for,
)

torch.set_num_threads(2)

N_FRAMES = 40
TINY = dict(max_raw_points=8192, max_points=1024, lc_cloud_points=0,
            max_frames=48, max_loop_factors=16)
# Fast mode's odometry (K1's plain version here) on raw scans through the
# device voxelizer, with optimize-on-find, so that one run reaches every
# site: the route's last frames close two loops (36 -> 1, 38 -> 3), and
# three frames run out of ICP budget (the final correspondence pass).
KNOBS = dict(slab_window=512, normal_window=512, dispatch_block=0,
             host_voxelize=False, optimize_midrun=True, loop_check_every=2)
STEP_CHILDREN = {"prep", "icp", "factor", "occupancy", "normals", "db_write"}


def _config() -> config.SlamConfig:
    return config.apply_mode(config.tiny_config(**TINY), "fast").replace(**KNOBS)


def _drive(cfg, scans, trace: bool):
    eng = pipeline.SlamEngine(cfg, "cpu", trace=trace)
    eng.reset()
    for s in scans:
        eng.push_scan(s)
    timing = {}
    eng.finalize(timing=timing)
    return dict(engine=eng, poses=eng.trajectory(), metrics=eng.metrics(),
                pairs=eng.loop_pairs(), timing=timing)


@pytest.fixture(scope="module")
def runs():
    half = route_half_for(N_FRAMES)
    world = generate_world(0, route_half=half)
    gt = generate_trajectory(N_FRAMES, half=half)
    rng = np.random.default_rng(0)
    scans = [render_scan(world, gt[i], rng, max_range=15.0, max_points=8000)
             for i in range(N_FRAMES)]
    cfg = _config()
    return dict(cfg=cfg, scans=scans, off=_drive(cfg, scans, False),
                on=_drive(cfg, scans, True))


def _children(spans, i):
    return [j for j, s in enumerate(spans) if s["parent"] == i]


def _names(spans, idx):
    return {spans[j]["name"] for j in idx}


def _descendants(spans, i):
    out, todo = [], [i]
    while todo:
        kids = _children(spans, todo.pop())
        out += kids
        todo += kids
    return out


def test_tracing_off_is_bit_identical_and_keeps_nothing(runs):
    off, on = runs["off"], runs["on"]
    assert np.array_equal(off["poses"], on["poses"])
    assert off["pairs"] == on["pairs"]
    assert len(off["pairs"]) == 2, "the route closes its loop"
    assert not off["metrics"]["icp_converged"][1:].all()
    assert "trace" not in off["metrics"] and "trace" in on["metrics"]
    assert set(off["metrics"]) == set(on["metrics"]) - {"trace"}
    for k, v in off["metrics"].items():
        assert np.array_equal(np.asarray(v), np.asarray(on["metrics"][k])), k
    assert set(off["timing"]) == set(on["timing"])
    tr = off["engine"].tracer
    assert tr.spans == [] and tr.counters == {} and not tr.armed
    assert tracing.span("icp") is tracing.NULL


def test_traced_spans_nest_per_frame(runs):
    cfg, spans = runs["cfg"], runs["on"]["metrics"]["trace"]["spans"]
    roots = [i for i, s in enumerate(spans) if s["parent"] == -1]
    assert [spans[i]["name"] for i in roots] == (
        ["reset"] + ["push_scan"] * N_FRAMES + ["finalize"])
    assert [spans[i]["frame"] for i in roots] == [-1, *range(N_FRAMES), -1]
    for i, s in enumerate(spans):
        assert s["t0_ns"] <= s["t1_ns"], s
        p = s["parent"]
        if p >= 0:
            assert p < i
            assert spans[p]["t0_ns"] <= s["t0_ns"] <= s["t1_ns"] <= spans[p]["t1_ns"]
            assert s["frame"] == spans[p]["frame"]
    ticks = 0
    for f, r in enumerate(roots[1:-1]):
        kids = _children(spans, r)
        # the engine's cadence (SlamEngine._process)
        is_tick = f > 0 and f % cfg.loop_check_every == 0 and f > cfg.loop_start_frame
        assert [spans[j]["name"] for j in kids] == (
            ["upload", "step"] + (["tick"] if is_tick else []))
        upload, step = kids[0], kids[1]
        assert [spans[j]["site"] for j in _children(spans, upload)] == ["upload"]
        want = STEP_CHILDREN if f else {"prep", "normals", "db_write"}
        assert _names(spans, _children(spans, step)) == want
        if is_tick:
            ticks += 1
            got = _names(spans, _children(spans, kids[2]))
            assert {"retrieve", "verify", "record"} <= got <= {
                "retrieve", "verify", "record", "optimize"}
            verify = next(j for j in _children(spans, kids[2])
                          if spans[j]["name"] == "verify")
            assert "tranche" in _names(spans, _children(spans, verify))
    assert ticks > 0
    fin = _children(spans, roots[-1])
    assert [spans[j]["name"] for j in fin] == ["flush", "optimize", "rebuild"]


def test_icp_iterations_and_host_syncs(runs):
    m = runs["on"]["metrics"]
    spans, counters = m["trace"]["spans"], m["trace"]["counters"]
    for i, s in enumerate(spans):
        if s["name"] != "icp" or spans[s["parent"]]["name"] != "step":
            continue
        f = s["frame"]
        kids = _children(spans, i)
        assert _names(spans, kids) <= {"iter", "final", "sync", "coarse"}
        assert sum(spans[j]["name"] == "iter" for j in kids) == m["icp_iters"][f]
        sites = [spans[j]["site"] for j in _descendants(spans, i)
                 if spans[j]["name"] == "sync"]
        assert sites.count("icp.active") == m["icp_iters"][f] + 1, f
        assert sites.count("icp.need") == 1
        assert set(s["launches"]) == {"match_slab", "nn1", "icp_step"}
    # every sync span is counted under its site, and only those
    sites = [s["site"] for s in spans if s["name"] == "sync"]
    assert counters == {f"host_syncs.{k}": sites.count(k) for k in set(sites)}
    assert counters["host_syncs.upload"] == N_FRAMES
    assert counters["host_syncs.voxel.count"] == N_FRAMES - 1
    assert counters["host_syncs.pg.cost"] > 0
    assert any(s["name"] == "optimize" and spans[s["parent"]]["name"] == "tick"
               for s in spans if s["parent"] >= 0)


def test_finalize_timing_keys_and_spans(runs):
    on, off = runs["on"], runs["off"]
    assert set(on["timing"]) == {"flush", "optimize", "rebuild", "f64_s", "f64_it"}
    spans = on["metrics"]["trace"]["spans"]
    for name in ("flush", "optimize", "rebuild"):
        s = next(s for s in spans if s["name"] == name and s["frame"] == -1)
        assert on["timing"][name] == (s["t1_ns"] - s["t0_ns"]) / 1e9
    assert off["timing"]["f64_it"] == on["timing"]["f64_it"]
    assert all(v >= 0 for v in off["timing"].values())


def test_profiler_session_turns_tracing_on_and_off(runs):
    cfg, scans = runs["cfg"], runs["scans"]
    eng = pipeline.SlamEngine(cfg, "cpu")
    eng.reset()
    eng.push_scan(scans[0])
    assert eng.tracer.spans == [] and "trace" not in eng.metrics()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        assert tracing.profiler_active()
        eng.push_scan(scans[1])
    assert not tracing.profiler_active()
    n = len(eng.tracer.spans)
    assert n and {s[2] for s in eng.tracer.spans} == {1}
    eng.push_scan(scans[2])
    assert len(eng.tracer.spans) == n
    assert "trace" in eng.metrics()
    eng.reset()
    assert eng.tracer.spans == [] and "trace" not in eng.metrics()
