"""The port's own spans of the traced drive, and the device operations of
the trace placed in them (shared by the readers of ``metrics/``; the
loader skips this file).

The engine records its spans while a ``torch.profiler`` session is active
(``lidar_slam_tpu_torch/utils/tracing.py``), and ``window.run_window``
copies ``SlamEngine.metrics()``, whose ``"trace"`` entry holds them, into
``Window.profiled_counters`` after the traced drive. Span times are
``perf_counter_ns``; ``DeviceTrace.offset_ns`` maps them onto the
profiler's clock. A device operation is placed in the innermost span open
when the host launched it: the start of its CUDA runtime call
(``DeviceTrace.launch_ns``), which the profiler times on the host's own
clock.

The device's timestamps cannot place it: they drift against the host's
clock, on the H100 by up to 22 ms within one drive, with steps of 0.3 to
3 ms at a resynchronisation. An operation with no runtime call (hand-made
traces) is placed by its device start instead, corrected by the kernels'
launches: the program wraps each K1 and K2 launch call in a ``launch``
span, the i-th K1 (K2) operation on the device belongs to the i-th K1 (K2)
launch, and it cannot start before that launch did. Each such pair bounds
the clock's error from above; an operation takes the least bound among the
five anchors nearest to it on either side. Where such operations are
left and the counts of launches and operations differ, nothing is placed.

The placement is then checked: in every ``icp`` span, the K1
(``match_slab``) and K2 (``nn1_kernel``) operations placed there (or in
its children) must equal the launches the span counted (the kernels' own
counters). Readers that place operations give nothing where it fails."""

from __future__ import annotations

import sys
from bisect import bisect_left, bisect_right
from collections import Counter, defaultdict
from dataclasses import dataclass

from slambench.trace import busy_ns, idle_gaps

# a span's "launches" key and a launch span's "kernel" -> the fragment of
# the kernel's device name
KERNEL_OPS = {"match_slab": "match_slab", "nn1": "nn1_kernel"}
WINDOW = 2          # anchors on each side whose least bound is taken


def program_spans(run) -> list | None:
    """The traced drive's span records, or None where the program recorded
    none (tracing absent or off)."""
    trace = (run.window.profiled_counters or {}).get("trace")
    if run.trace is None or not trace or not trace.get("spans"):
        return None
    return trace["spans"]


def is_launch(name: str) -> bool:
    """A kernel, as ``launches_per_scan`` counts them (copies and sets
    left out)."""
    return not name.startswith(("Memcpy", "Memset"))


def place(times: list, spans: list) -> list:
    """The index of the innermost span open at each host time (-1 outside
    every span). The spans nest (one host thread), so a stack sweep over
    the sorted times does."""
    order = sorted(range(len(spans)), key=lambda i: (spans[i]["t0_ns"], i))
    out, stack, j = [0] * len(times), [], 0
    for i in sorted(range(len(times)), key=times.__getitem__):
        t = times[i]
        while j < len(order) and spans[order[j]]["t0_ns"] <= t:
            s = order[j]
            while stack and spans[stack[-1]]["t1_ns"] < spans[s]["t0_ns"]:
                stack.pop()
            stack.append(s)
            j += 1
        while stack and spans[stack[-1]]["t1_ns"] < t:
            stack.pop()
        out[i] = stack[-1] if stack else -1
    return out


def enclosing(spans: list, name: str, parent: str | None = None) -> list:
    """For each span, the index of the nearest span named ``name`` (itself
    or an ancestor; with ``parent``, one whose own parent is so named), or
    -1."""
    out = []
    for i, s in enumerate(spans):
        if s["name"] == name and (parent is None or (
                s["parent"] >= 0 and spans[s["parent"]]["name"] == parent)):
            out.append(i)
        else:
            out.append(out[s["parent"]] if s["parent"] >= 0 else -1)
    return out


def launch_anchors(spans: list, ops: list, offset_ns: int) -> list | None:
    """``(device start ns, error bound ns)`` of every K1 and K2 operation,
    sorted: its start on the host clock by ``offset_ns`` minus the start of
    its launch span (the clock's error is at most that). None where a
    kernel's operations and launch spans differ in number."""
    out = []
    for key, frag in KERNEL_OPS.items():
        launches = [s["t0_ns"] for s in spans
                    if s["name"] == "launch" and s.get("kernel") == key]
        starts = [a for name, a, _ in ops if frag in name]
        if len(launches) != len(starts):
            return None
        out += [(a, a - offset_ns - t) for a, t in zip(starts, launches)]
    return sorted(out)


@dataclass
class Placement:
    spans: list
    ops: list
    where: list            # innermost span open at each operation's launch
    anchors: list          # launch_anchors()
    bounds: list           # each anchor's least bound in its window
    launch_ns: list        # each operation's launch (profiler clock) or None

    def to_host(self, t_dev: int, offset_ns: int) -> int:
        """A device timestamp on the host's clock."""
        if not self.anchors:
            return t_dev - offset_ns
        k = bisect_right(self.anchors, (t_dev, float("inf")))
        near = [self.bounds[j] for j in (k - 1, k) if 0 <= j < len(self.bounds)]
        return t_dev - offset_ns - min(near)

    def op_host(self, i: int, offset_ns: int) -> int:
        """Operation ``i``'s launch on the host's clock (its corrected
        device start where it has no runtime call)."""
        t = self.launch_ns[i]
        return t - offset_ns if t is not None else \
            self.to_host(self.ops[i][1], offset_ns)

    def gap_host(self, end_ns: int, offset_ns: int) -> int:
        """An idle gap that ends at device time ``end_ns``, on the host's
        clock: the launch of the operation that ends it, which the host
        made as the device waited (the corrected device time where there
        is none)."""
        k = bisect_left(self.ops, end_ns, key=lambda op: op[1])
        if k < len(self.ops) and self.ops[k][1] == end_ns:
            return self.op_host(k, offset_ns)
        return self.to_host(end_ns, offset_ns)


def placement(run) -> Placement | None:
    """The operations of the traced drive placed in the program's spans;
    None without program spans or device operations, or where operations
    without a runtime call are left and the launches cannot be paired with
    the K1/K2 operations."""
    spans = program_spans(run)
    ops = run.trace.ops if run.trace is not None else None
    if spans is None or not ops:
        return None
    off = run.trace.offset_ns
    launched = list(getattr(run.trace, "launch_ns", None) or ())
    if len(launched) != len(ops):
        launched = [None] * len(ops)
    anchors = launch_anchors(spans, ops, off)
    if anchors is None:
        if None in launched:
            return None
        anchors = []
    u = [b for _, b in anchors]
    bounds = [min(u[max(0, k - WINDOW):k + WINDOW + 1]) for k in range(len(u))]
    p = Placement(spans, ops, [], anchors, bounds, launched)
    p.where = place([p.op_host(i, off) for i in range(len(ops))], spans)
    return p


def icp_kernel_counts(p: Placement) -> tuple:
    """``(placed, launched, differing)``: K1 and K2 operations placed in
    ``icp`` spans (or their children) and the launches those spans
    counted, by kernel, and the number of ``icp`` spans where the two
    differ."""
    spans = p.spans
    icp = enclosing(spans, "icp")
    found = defaultdict(Counter)
    for (name, _, _), w in zip(p.ops, p.where):
        if w >= 0 and icp[w] >= 0:
            for key, frag in KERNEL_OPS.items():
                if frag in name:
                    found[icp[w]][key] += 1
    counted, placed, bad = Counter(), Counter(), 0
    for i, s in enumerate(spans):
        if s["name"] != "icp":
            continue
        want = s.get("launches", {})
        for key in KERNEL_OPS:
            counted[key] += want.get(key, 0)
            placed[key] += found[i][key]
        bad += any(found[i][k] != want.get(k, 0) for k in KERNEL_OPS)
    return dict(placed), dict(counted), bad


def checked_placement(run) -> Placement | None:
    """:func:`placement`, or None where the K1/K2 check fails."""
    p = placement(run)
    if p is None or icp_kernel_counts(p)[2]:
        return None
    return p


def placed_in(run, name: str, parent: str) -> tuple | None:
    """``(ops, frames)``: the device operations placed in spans ``name``
    whose parent is ``parent`` (their children included), and the number of
    frames that have such a span; None where :func:`checked_placement`
    gives nothing or no span is so named."""
    p = checked_placement(run)
    if p is None:
        return None
    region = enclosing(p.spans, name, parent)
    frames = {s["frame"] for i, s in enumerate(p.spans) if region[i] == i}
    if not frames:
        return None
    mine = [op for op, w in zip(p.ops, p.where) if w >= 0 and region[w] >= 0]
    return mine, len(frames)


def launches_per_frame(run, name: str, parent: str):
    got = placed_in(run, name, parent)
    if got is None:
        return None
    ops, frames = got
    return sum(1 for n, _, _ in ops if is_launch(n)) / frames


def device_ms_per_frame(run, name: str, parent: str):
    got = placed_in(run, name, parent)
    if got is None:
        return None
    ops, frames = got
    return busy_ns(ops) / 1e6 / frames


def stage_report(run) -> None:
    """To stderr: the launch anchors' error bounds and the K1/K2 check;
    then each stage's device busy ms a scan (the union of the operations
    placed in it) and the idle ms a scan that the host ended in it (by the
    launch that ended the gap, :meth:`Placement.gap_host`), a stage being a
    span's path below its frame's root (``step/icp``, ``tick/verify``; the
    root's own name for finalize and reset)."""
    p = placement(run)
    if p is None:
        return
    spans, off = p.spans, run.trace.offset_ns
    if p.bounds:
        print(f"device clock against the host's, by {len(p.anchors)} launch "
              f"anchors: error bound {min(p.bounds) / 1e3:.1f} to "
              f"{max(p.bounds) / 1e3:.1f} us", file=sys.stderr)
    placed, launched, bad = icp_kernel_counts(p)
    print("program spans: K1/K2 operations placed in icp spans "
          + ", ".join(f"{k} {placed.get(k, 0)} (launched {launched.get(k, 0)})"
                      for k in KERNEL_OPS)
          + f"; icp spans that differ: {bad}", file=sys.stderr)

    def stage(i):
        path = []
        while i >= 0:
            path.append(spans[i]["name"])
            i = spans[i]["parent"]
        path.reverse()
        return "/".join(path[1:3]) if path[0] == "push_scan" and len(path) > 1 \
            else path[0]

    names = [stage(i) for i in range(len(spans))]
    scans = sum(1 for s in spans if s["name"] == "push_scan") or 1
    by = defaultdict(list)
    for op, w in zip(p.ops, p.where):
        by[names[w] if w >= 0 else "outside"].append(op)
    busy = {k: busy_ns(v) / 1e6 / scans for k, v in by.items()}
    t0 = int(run.trace.t0 * 1e9) + off
    t1 = int(run.trace.t1 * 1e9) + off
    gaps = idle_gaps(p.ops, t0, t1)
    at = place([p.gap_host(b, off) for _, b in gaps], spans)
    idle = defaultdict(float)
    for (a, b), w in zip(gaps, at):
        idle[names[w] if w >= 0 else "outside"] += (b - a) / 1e6 / scans
    keys = sorted(set(busy) | set(idle), key=lambda k: -busy.get(k, 0) - idle[k])
    print("program stages, device busy / idle ms a scan: " + "; ".join(
        f"{k} {busy.get(k, 0.0):.3f} / {idle[k]:.3f}" for k in keys),
        file=sys.stderr)
