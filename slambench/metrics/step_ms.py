"""Engine (``models/pipeline.py`` ``SlamEngine.push_scan``): the mean synced
host wall of a frame without a loop tick, pose read back included."""

UNIT = "ms"


def read(run):
    spans = run.window.spans_named("push_scan.step")
    if not spans:
        return None
    return 1e3 * sum(s.seconds for s in spans) / len(spans)
