"""Pose graph (``models/pose_graph.py``): the synced wall of finalize's
``optimize`` stage (``SlamEngine.finalize(timing=)``), a mean over the
drives that ran without the profiler (all drives where none did)."""

UNIT = "s"


def read(run):
    win = run.window
    t = [d["optimize"] for i, d in enumerate(win.finalize_timing)
         if i != win.profiled_drive and "optimize" in d]
    if not t:
        t = [d["optimize"] for d in win.finalize_timing if "optimize" in d]
    return sum(t) / len(t) if t else None
