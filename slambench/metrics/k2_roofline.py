"""Correspondence kernels (``csrc/knn.cu`` ``nn1_kernel`` via
``ops/knn_cuda.py``): K2's share of its roofline in exact odometry, over
the traced drive's frames without a loop tick (where K2 runs for odometry
alone; a tick frame's verify launches are not counted by the engine).
Work: each such frame's ICP launches (iterations, plus the final pass when
it did not converge) x valid sources x valid targets (``frame_npts``);
time: K2's device time inside those frames' spans. Nothing where odometry
does not run K2, or where the launches found in those spans are not the
launches the counters give (the trace could not be placed on the spans)."""

from slambench.roofline import bound_s, k2_launch
from slambench.trace import span_of

UNIT = "%"


def read(run):
    cfg, tr, c = run.config, run.trace, run.window.profiled_counters
    if cfg.knn_backend not in ("auto", "pallas", "xla") or tr is None or not c:
        return None
    if cfg.icp.sample_points or cfg.icp.target_points or cfg.icp.coarse_iterations:
        return None
    spans = sorted(run.window.spans_named("push_scan.step", profiled=True) +
                   run.window.spans_named("push_scan.tick", profiled=True),
                   key=lambda s: s.t0)
    found, dev_ns = 0, 0
    for name, a, b in tr.ops:
        if "nn1_kernel" not in name:
            continue
        s = span_of(spans, tr.offset_ns, (a + b) // 2)
        if s is not None and s.name == "push_scan.step" and s.frame > 0:
            dev_ns += b - a
            found += 1
    it, conv, npts = c["icp_iters"], c["icp_converged"], c["frame_npts"]
    N = cfg.max_points
    least, launched = 0.0, 0
    for s in spans:
        if s.name != "push_scan.step" or s.frame < 1:
            continue
        f = s.frame
        launches = int(it[f]) + (0 if conv[f] else 1)
        launched += launches
        least += launches * bound_s(*k2_launch(1, int(npts[f]), int(npts[f - 1]),
                                               N, N))
    if dev_ns <= 0 or found != launched:
        return None
    return 100.0 * least / (dev_ns / 1e9)
