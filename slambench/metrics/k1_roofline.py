"""Correspondence kernels (``csrc/knn.cu`` ``match_slab_kernel`` via
``ops/knn_cuda.py``): K1's share of its roofline over the traced drive.
Work: every odometry ICP's K1 launches (its iterations, plus the final
correspondence pass when it did not converge), each ``sample_points``
sources against a ``slab_window`` of target rows, from the engine's
counters; time: K1's device time in the trace. Nothing where the
configuration does not run K1."""

from slambench.roofline import bound_s, k1_launch

UNIT = "%"


def read(run):
    cfg, tr, c = run.config, run.trace, run.window.profiled_counters
    if cfg.knn_backend != "slab_pallas" or tr is None or not c:
        return None
    dev_s = sum(b - a for name, a, b in tr.ops if "match_slab" in name) / 1e9
    if dev_s <= 0:
        return None
    it, conv, npts = c["icp_iters"], c["icp_converged"], c["frame_npts"]
    least = 0.0
    for f in range(1, len(it)):
        launches = int(it[f]) + (0 if conv[f] else 1)
        src = min(cfg.icp.sample_points or cfg.max_points, int(npts[f]))
        win = min(cfg.slab_window, cfg.max_points)
        least += launches * bound_s(*k1_launch(1, src, win, cfg.max_points))
    return 100.0 * least / dev_s
