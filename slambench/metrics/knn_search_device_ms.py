"""Normals (``ops/normals.py``, ``normal_method="knn"``): the device's busy
time of the k-NN search (the union of the intervals of the operations
placed in a ``knn`` span under ``normals``), a mean over the traced drive's
frames; ``normals_device_ms`` less this is the gather, the covariance and
the eigenvector. Nothing unless the configuration's ``normal_method`` is
``"knn"``, nor where the program records no ``knn`` span, nor where the
K1/K2 placement check fails."""

from slambench.metrics._program_spans import device_ms_per_frame

UNIT = "ms"


def read(run):
    if run.config.normal_method != "knn":
        return None
    return device_ms_per_frame(run, "knn", "normals")
