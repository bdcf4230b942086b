"""Normals (``ops/normals.py``, through ``pipeline._scan_normals``): kernels
the device ran (copies and sets left out) that the host launched inside a
``normals`` span under ``step``, over the traced drive's frames. Nothing
without program spans, or where the K1/K2 placement check fails."""

from slambench.metrics._program_spans import launches_per_frame

UNIT = "launches/scan"


def read(run):
    return launches_per_frame(run, "normals", "step")
