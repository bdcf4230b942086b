"""Odometry ICP (``ops/icp.py``): the device's busy time (the union of the
intervals of the operations placed in an ``icp`` span under ``step``), a
mean over the odometry frames of the traced drive; device-measured, so the
profiler's host overhead does not stretch it. Also writes each program
stage's busy and idle ms a scan to standard error. Nothing without program
spans, or where the K1/K2 placement check fails."""

from slambench.metrics._program_spans import device_ms_per_frame, stage_report

UNIT = "ms"


def read(run):
    stage_report(run)
    return device_ms_per_frame(run, "icp", "step")
