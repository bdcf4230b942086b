"""Odometry ICP (``ops/icp.py``): Gauss-Newton iterations a scan,
``metrics()["icp_iters"]`` over the frames of the last drive (frame 0
runs no ICP)."""

UNIT = "iters/scan"


def read(run):
    it = run.counters.get("icp_iters")
    if it is None or len(it) < 2:
        return None
    return float(it[1:].sum()) / (len(it) - 1)
