"""Normals (``ops/normals.py``, ``normal_method="knn"``): the k-NN normals
stage's share of its roofline, counted from the algorithm's shapes and not
from the program's, so that a kernel that fuses the search with the PCA
reads against the same work. Work: in each frame of the traced drive with
a ``normals`` span under ``step``, every valid row against every valid row
(``frame_npts``); bytes: the padded cloud read once and its normals written
once. Time: the device's busy time (the union of the intervals) of the
operations placed in those spans, search and PCA alike. Nothing unless the
configuration's ``normal_method`` is ``"knn"``, nor without program spans,
nor where the K1/K2 placement check fails."""

from slambench.metrics._program_spans import placed_in, program_spans
from slambench.roofline import F32, FLOPS_PER_DISTANCE, bound_s
from slambench.trace import busy_ns

UNIT = "%"


def knn_normals_frame(valid_rows: int, rows: int):
    """``(flops, bytes)`` of one frame's k-NN normals: ``valid_rows``^2
    distances; the ``rows``-row padded cloud (xyz) read once and its
    normals (xyz) written once."""
    flops = FLOPS_PER_DISTANCE * valid_rows * valid_rows
    nbytes = rows * (3 + 3) * F32
    return flops, nbytes


def read(run):
    cfg = run.config
    if cfg.normal_method != "knn":
        return None
    got = placed_in(run, "normals", "step")
    if got is None:
        return None
    ops, _ = got
    spans = program_spans(run)
    frames = {s["frame"] for s in spans if s["name"] == "normals"
              and s["parent"] >= 0 and spans[s["parent"]]["name"] == "step"}
    npts = run.window.profiled_counters["frame_npts"]
    least = sum(bound_s(*knn_normals_frame(int(npts[f]), cfg.max_points))
                for f in frames)
    busy = busy_ns(ops)
    if busy <= 0:
        return None
    return 100.0 * least / (busy / 1e9)
