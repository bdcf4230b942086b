"""Engine host dispatch: kernels the device ran in the traced drive
(``torch.profiler`` CUDA events, copies and sets left out) over its scans."""

UNIT = "launches/scan"


def read(run):
    tr = run.trace
    if tr is None or not tr.ops:
        return None
    n = sum(1 for name, _, _ in tr.ops
            if not name.startswith(("Memcpy", "Memset")))
    scans = len(run.window.spans_named("push_scan.step", profiled=True)) + \
        len(run.window.spans_named("push_scan.tick", profiled=True))
    return n / scans if scans else None
