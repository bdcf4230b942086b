"""Engine (``models/pipeline.py`` ``SlamEngine.push_scan``): the host's
blocking reads of device values (``tracing.host_read``) and the upload's
stream syncs, counted by the program in the traced drive's scans (reset
and finalize left out) over its scans. The count of each site goes to
standard error. Nothing where the program recorded no spans."""

import sys
from collections import Counter

from slambench.metrics._program_spans import program_spans

UNIT = "syncs/scan"


def read(run):
    spans = program_spans(run)
    if spans is None:
        return None
    scans = sum(1 for s in spans if s["name"] == "push_scan")
    sites = Counter(s["site"] for s in spans
                    if s["name"] == "sync" and s["frame"] >= 0)
    if not scans:
        return None
    print(f"host syncs over {scans} scans: " + ", ".join(
        f"{k} {v}" for k, v in sites.most_common()), file=sys.stderr)
    return sum(sites.values()) / scans
