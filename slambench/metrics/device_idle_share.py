"""Device (H100): the share of a drive's host wall in which no operation ran
on the device: 1 - the traced drive's busy seconds (the union of its
operations' intervals, ``torch.profiler``) over the median wall of the
window's drives, which ran the same work without the profiler. The traced
drive's own wall is not the divisor: the profiler stretches it, the more
the more launches a drive makes."""

import statistics

from slambench.trace import busy_ns

UNIT = "%"


def read(run):
    tr, win = run.trace, run.window
    walls = win.drive_walls(profiled=False)
    if tr is None or not tr.ops or not walls:
        return None
    return 100.0 * (1.0 - busy_ns(tr.ops) / 1e9 / statistics.median(walls))
