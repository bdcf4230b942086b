"""Set-up and the measured window of one cell: a closed loop with one
client, as in offline playback. Scan i + 1 is pushed once scan i's pose is
on the host; a drive is ``reset()``, every scan through
``SlamEngine.push_scan`` with its pose read back, then ``finalize()`` and the
finalized trajectory read back. Drives repeat until the first one that ends
after the window's length.

The spans are the benchmark's own, around its calls into the port:
``reset``, ``push_scan.step`` (a frame without a loop tick),
``push_scan.tick`` (a frame whose push runs a loop tick) and ``finalize``.
Each ends after a device sync, so a span is the host wall of its work."""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import torch


@dataclass
class Span:
    name: str
    drive: int
    frame: int
    t0: float            # perf_counter seconds
    t1: float

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0


@dataclass
class Window:
    spans: list = field(default_factory=list)
    drives: int = 0
    scans: int = 0
    t0: float = 0.0
    t1: float = 0.0
    finalize_timing: list = field(default_factory=list)   # a dict a drive
    profiled_drive: int = -1

    profiled_counters: dict = field(default_factory=dict)

    def scan_latencies(self) -> list:
        """Every scan's latency in the window (the profiled drive left out)."""
        return [s.seconds for s in self.spans if s.name.startswith("push_scan")
                and s.drive != self.profiled_drive]

    def drive_walls(self, profiled: bool = True) -> list:
        """Each drive's wall, reset to finalized trajectory, in order; the
        profiled drive's too unless ``profiled`` is false."""
        walls = {}
        for s in self.spans:
            if profiled or s.drive != self.profiled_drive:
                a, b = walls.get(s.drive, (s.t0, s.t1))
                walls[s.drive] = (min(a, s.t0), max(b, s.t1))
        return [b - a for _, (a, b) in sorted(walls.items())]

    def spans_named(self, name: str, profiled: bool = False) -> list:
        """Spans called ``name`` of the profiled drive (``profiled``), or of
        the drives that ran without the profiler where there are any."""
        if profiled:
            pool = [s for s in self.spans if s.drive == self.profiled_drive]
        else:
            pool = [s for s in self.spans if s.drive != self.profiled_drive] \
                or self.spans
        return [s for s in pool if s.name == name]


def is_tick(config, frame: int) -> bool:
    """Whether ``push_scan`` of ``frame`` runs a loop tick (the engine's
    cadence, ``SlamEngine._process``)."""
    return (frame > 0 and frame % config.loop_check_every == 0
            and frame > config.loop_start_frame)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def drive(engine, scans, win: Window, index: int) -> None:
    """One whole drive through the engine, its spans appended to ``win``."""
    clock = time.perf_counter
    cfg = engine.config
    t0 = clock()
    engine.reset()
    _sync(engine.device)
    win.spans.append(Span("reset", index, -1, t0, clock()))
    for f, scan in enumerate(scans):
        t0 = clock()
        engine.push_scan(scan)
        engine.state.poses[f].cpu()      # the frame's pose on the host
        t1 = clock()
        name = "push_scan.tick" if is_tick(cfg, f) else "push_scan.step"
        win.spans.append(Span(name, index, f, t0, t1))
    t0 = clock()
    timing: dict = {}
    engine.finalize(timing=timing)
    engine.trajectory()                  # the finalized trajectory on the host
    win.spans.append(Span("finalize", index, -1, t0, clock()))
    win.finalize_timing.append(timing)
    win.scans += len(scans)
    win.drives += 1


def run_window(engine, scans, seconds: float, profiler=None) -> Window:
    """Drives until the first one that ends ``seconds`` after the window's
    start. With ``profiler`` (a ``trace.DeviceTrace``), one more drive runs
    under it once the window has closed: the profiler slows every launch
    several times over, so the host spans of the window are read from the
    drives without it."""
    win = Window()
    win.t0 = time.perf_counter()
    while True:
        drive(engine, scans, win, win.drives)
        if time.perf_counter() - win.t0 >= seconds:
            break
    win.t1 = time.perf_counter()
    if profiler is not None:
        with profiler:
            drive(engine, scans, win, win.drives)
        win.profiled_drive = win.drives - 1
        win.profiled_counters = engine.metrics()
        win.drives -= 1               # the window's own drives and scans
        win.scans -= len(scans)
    return win


def warm_up(engine, scans) -> None:
    """Every path of the cell once, before the window: the first 56 scans
    (odometry, normals, idle ticks), then scans 0-5 again, so that the tick
    at frame 60 queries a scan the DB already holds and fires (verify,
    loop factors and, where the configuration runs it, optimize-on-find),
    then finalize with a loop in the graph."""
    cfg = engine.config
    head = max(cfg.loop_start_frame + 6, 0)
    first_tick = next(f for f in range(head + 1, head + 1 + 2 * cfg.loop_check_every)
                      if is_tick(cfg, f))
    seq = list(scans[:head]) + list(scans[: first_tick - head + 2])
    engine.reset()
    for s in seq:
        engine.push_scan(s)
    engine.finalize(timing={})
    engine.trajectory()
    engine.reset()
    _sync(engine.device)
