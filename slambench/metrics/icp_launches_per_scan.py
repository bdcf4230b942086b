"""Odometry ICP (``ops/icp.py``): kernels the device ran (copies and sets
left out, as ``launches_per_scan``) that the host launched inside an
``icp`` span under ``step``, over the odometry frames of the traced
drive. Nothing without program spans, or where the K1/K2 placement check
fails (``_program_spans.checked_placement``)."""

from slambench.metrics._program_spans import launches_per_frame

UNIT = "launches/scan"


def read(run):
    return launches_per_frame(run, "icp", "step")
