"""The device trace of a traced run: ``torch.profiler`` with CUDA activity
over one drive, reduced to the device's operations (kernels, copies, sets)
as ``(name, start_ns, end_ns)`` on the profiler's clock, and the offset that
maps the benchmark's ``perf_counter`` spans onto that clock."""

from __future__ import annotations

import time
from collections import defaultdict
from dataclasses import dataclass, field

import torch


@dataclass
class DeviceTrace:
    activities: tuple = ("cuda",)
    ops: list = field(default_factory=list)     # (name, start_ns, end_ns)
    t0: float = 0.0                             # perf_counter at start / stop
    t1: float = 0.0
    offset_ns: int = 0          # profiler clock ns = perf_counter ns + offset
    _prof: object = None

    def __enter__(self):
        acts = [getattr(torch.profiler.ProfilerActivity, a.upper())
                for a in self.activities]
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.__enter__()
        self.offset_ns = time.time_ns() - time.perf_counter_ns()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self._prof.__exit__(*exc)
        device = "cpu" in self.activities and "cuda" not in self.activities
        self.ops = device_ops(self._prof, cpu=device)
        self._prof = None
        return False

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0


def device_ops(prof, cpu: bool = False) -> list:
    """``(name, start_ns, end_ns)`` of every operation that ran on the
    device (CPU operations instead where ``cpu``, which is how the tests
    exercise this on a host without a card)."""
    want = "CPU" if cpu else "CUDA"
    out = []
    for e in prof.profiler.kineto_results.events():
        if str(e.device_type()).split(".")[-1] != want:
            continue
        if cpu and e.name().startswith("cuda"):
            continue
        out.append((e.name(), int(e.start_ns()), int(e.end_ns())))
    out.sort(key=lambda x: x[1])
    return out


def busy_ns(ops: list) -> int:
    """Length of the union of the operations' intervals."""
    total, cur0, cur1 = 0, None, None
    for _, a, b in ops:
        if cur1 is None or a > cur1:
            if cur1 is not None:
                total += cur1 - cur0
            cur0, cur1 = a, b
        else:
            cur1 = max(cur1, b)
    if cur1 is not None:
        total += cur1 - cur0
    return total


def idle_gaps(ops: list, t0_ns: int, t1_ns: int) -> list:
    """``(start_ns, end_ns)`` of every stretch of ``[t0_ns, t1_ns]`` in
    which no operation ran."""
    gaps, cur = [], t0_ns
    for _, a, b in ops:
        if a > cur:
            gaps.append((cur, a))
        cur = max(cur, b)
    if t1_ns > cur:
        gaps.append((cur, t1_ns))
    return gaps


def op_seconds_by_name(ops: list) -> dict:
    tot = defaultdict(int)
    for name, a, b in ops:
        tot[name] += b - a
    return {k: v / 1e9 for k, v in tot.items()}


def span_of(spans: list, offset_ns: int, t_ns: int):
    """The benchmark span whose host interval holds profiler time ``t_ns``
    (None between spans)."""
    lo, hi = 0, len(spans)
    t = (t_ns - offset_ns) / 1e9
    while lo < hi:
        mid = (lo + hi) // 2
        if spans[mid].t1 < t:
            lo = mid + 1
        else:
            hi = mid
    if lo < len(spans) and spans[lo].t0 <= t <= spans[lo].t1:
        return spans[lo]
    return None
