"""The benchmark's harness: set-up, the window, the per-layer readers, the
check and the result line of one run (``run.py`` is its command).

Set-up renders the cell's drive from the seed, prepares it as the
configuration's deployment does (host voxelizer or raw scans), builds or
loads the port's kernels from the caches inside the checkout, constructs
``SlamEngine`` and warms every path of the cell up (``window.warm_up``).
The window then replays the drive, whole drive after whole drive, for
``--seconds`` (``window.run_window``); ``--trace 1`` then replays one more
drive under ``torch.profiler`` and reports the per-layer metrics of
``metrics/`` instead of the end-to-end ones. Once the window has closed,
``check.judge`` holds what the window produced to the plain reference in
``reference/``.
The last line of standard output is the result, one JSON object; the
numbers compared, each beside its limit, are the last lines of standard
error and the result's last key.

Exit codes: 0 a result was printed; 2 no CUDA device, or fewer than the
cell's chips; 3 the process loaded JAX or the JAX package."""

import argparse
import importlib.util
import json
import math
import os
import statistics
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
METRICS_DIR = BENCH_DIR / "metrics"
FORBIDDEN = ("jax", "jaxlib", "flax", "lidar_slam_tpu")
HOST_THREADS = 8


def forbidden_modules() -> list:
    """Loaded modules whose whole top-level name is JAX's or the JAX
    package's (``lidar_slam_tpu_torch`` is neither)."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def cache_env(root: Path = ROOT) -> None:
    """Build and kernel caches at fixed paths inside the checkout. The port
    builds its kernels into ``build/kernels`` and its host library into
    ``build/native`` itself."""
    base = root / "build" / "slambench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(base / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(base / "triton")
    os.environ.setdefault("USE_FLAX", "0")


@dataclass
class RunRecord:
    """What the per-layer readers of ``metrics/`` read."""

    cell: object
    config: object
    window: object
    trace: object
    counters: dict
    peak_window_bytes: int


def load_readers(directory: Path | None = None) -> dict:
    """Every ``<metric>.py`` in ``directory`` (default ``metrics/``): name ->
    module with ``UNIT`` and ``read(run)``."""
    out = {}
    for path in sorted(Path(directory or METRICS_DIR).glob("*.py")):
        if path.name.startswith("_"):
            continue
        spec = importlib.util.spec_from_file_location(
            f"slambench_metric_{path.stem}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        out[path.stem] = mod
    return out


def prepare_scans(cfg, raw: list) -> list:
    """The scans as the deployment pushes them: through the port's host
    voxelizer (``utils/native.voxel_downsample_host``, the prep of ``run
    --mode fast``) on a pool of threads (the call releases the interpreter
    lock), or raw for the device voxelizer."""
    if not cfg.host_voxelize:
        return raw
    from lidar_slam_tpu_torch.utils.native import get_lib, voxel_downsample_host

    get_lib()  # build or load once, before the threads
    with ThreadPoolExecutor(HOST_THREADS) as ex:
        return list(ex.map(
            lambda s: voxel_downsample_host(s, cfg.voxel_size, cfg.max_points),
            raw))


def p95(values: list) -> float:
    return statistics.quantiles(values, n=100, method="inclusive")[94]


def breakdown(trace, win) -> dict:
    from .trace import idle_gaps, op_seconds_by_name, span_of

    ops = sorted(op_seconds_by_name(trace.ops).items(), key=lambda x: -x[1])[:10]
    spans = sorted((s for s in win.spans if s.drive == win.profiled_drive),
                   key=lambda s: s.t0)
    t0 = int(trace.t0 * 1e9) + trace.offset_ns
    t1 = int(trace.t1 * 1e9) + trace.offset_ns
    gaps = sorted(idle_gaps(trace.ops, t0, t1), key=lambda g: g[0] - g[1])[:10]
    named = []
    for a, b in gaps:
        s = span_of(spans, trace.offset_ns, a)
        where = "between-spans" if s is None else (
            s.name if s.frame < 0 else f"{s.name}@{s.frame}")
        named.append([where, (b - a) / 1e9])
    return {"device_ops": [[n, v] for n, v in ops], "idle_gaps": named}


def run_cell(cell, seed: int, seconds: float, trace: bool, device: str,
             t_start: float) -> dict:
    """One run of ``cell``; returns the result object (printed by
    :func:`main`)."""
    import torch

    from lidar_slam_tpu_torch.models.pipeline import SlamEngine

    from . import check
    from .trace import DeviceTrace, busy_ns
    from .traffic.generate import make_drive
    from .window import run_window, warm_up

    cuda = torch.device(device).type == "cuda"
    cfg = cell.slam_config()
    stages = [("imports", time.time())]
    raw, _ = make_drive(cell.traffic, seed, device)
    stages.append(("render", time.time()))
    scans = prepare_scans(cfg, raw)
    stages.append(("prepare", time.time()))
    engine = SlamEngine(cfg, device=device)
    stages.append(("engine", time.time()))
    warm_up(engine, scans)
    stages.append(("warm-up", time.time()))
    print("set-up stages: " + ", ".join(
        f"{name} {t1 - t0:.3f} s" for (name, t1), t0 in
        zip(stages, [t_start] + [t for _, t in stages[:-1]])), file=sys.stderr)
    peak_setup = torch.cuda.max_memory_allocated() if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.time() - t_start

    tracer = (DeviceTrace() if cuda else DeviceTrace(activities=("cpu",))) \
        if trace else None
    win = run_window(engine, scans, seconds, profiler=tracer)
    peak_window = torch.cuda.max_memory_allocated() if cuda else None
    counters = engine.metrics()
    lat = win.scan_latencies()

    if trace:
        run = RunRecord(cell, cfg, win, tracer, counters, peak_window)
        metrics = {}
        for name, mod in load_readers().items():
            v = mod.read(run)
            if v is not None:
                metrics[name] = {"value": float(v), "unit": mod.UNIT}
    else:
        metrics = {
            "scans_per_s": {"value": win.scans / (win.t1 - win.t0),
                            "unit": "scans/s"},
            "scan_latency_p95_ms": {"value": 1e3 * p95(lat), "unit": "ms"},
            "setup_s": {"value": setup_s, "unit": "s"},
        }
    print(f"window: {win.drives} drives, {win.scans} scans in "
          f"{win.t1 - win.t0:.3f} s; scan latency samples {len(lat)}, "
          f"{len(lat) - math.ceil(0.95 * len(lat))} beyond the p95; last drive: "
          f"{counters['loop_count']} loops, {counters['verify_fired']} verifying "
          f"ticks, {float(counters['icp_iters'].mean()):.3f} ICP iterations a "
          f"scan, {int((~counters['icp_converged'][1:]).sum())} unconverged; "
          "drive walls (s): " + " ".join(f"{w:.3f}" for w in win.drive_walls()),
          file=sys.stderr)

    outputs = check.ProgramOutputs.from_engine(engine)
    failed = outputs.nonfinite_poses()
    del engine
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.time()
    correct, numbers = check.judge(cell, raw, outputs, seed, device)
    print(f"set-up {setup_s:.3f} s; output check {time.time() - t_check:.3f} s",
          file=sys.stderr)

    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": cell.chips,
           "memory_peak_bytes": int(max(peak_setup, peak_window or 0))}
    result = {"correct": bool(correct), "attempted": win.scans, "failed": failed,
              "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = busy_ns(tracer.ops) / 1e9
        dev["window_s"] = tracer.window_s
        result["breakdown"] = breakdown(tracer, win)
    result["checks"] = {}
    for name, value, limit in numbers:
        items = {k: cell.limits[k] for k in check.PER_ITEM.get(name, ())}
        each = "; per item: " + ", ".join(f"{k} {v!r}" for k, v in items.items()) \
            if items else ""
        print(f"check {name} = {value!r} (limit {limit!r}{each})", file=sys.stderr)
        result["checks"][name] = {"value": value, "limit": limit, **items}
    return result


def main(argv=None, t_start: float | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    t_start = time.time() if t_start is None else t_start
    cache_env()
    import torch

    from .cell import load_cell

    cell = load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                      t_start)
    bad = forbidden_modules()
    if bad:
        print(f"the run loaded {bad}: the benchmark may load neither JAX nor "
              "the JAX package", file=sys.stderr)
        return 3
    sys.stdout.flush()
    print(json.dumps(result))
    return 0
