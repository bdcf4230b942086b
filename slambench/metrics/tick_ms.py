"""Loop tick (``models/loop_closure.py``: retrieval, verify, and
optimize-on-find where the configuration runs it): the mean synced host
wall of a frame whose push runs a tick, its odometry step included."""

UNIT = "ms"


def read(run):
    spans = run.window.spans_named("push_scan.tick")
    if not spans:
        return None
    return 1e3 * sum(s.seconds for s in spans) / len(spans)
