"""Normals (``ops/normals.py``): the device's busy time (the union of the
intervals of the operations placed in a ``normals`` span under ``step``), a
mean over the traced drive's frames. Nothing without program spans, or
where the K1/K2 placement check fails."""

from slambench.metrics._program_spans import device_ms_per_frame

UNIT = "ms"


def read(run):
    return device_ms_per_frame(run, "normals", "step")
