"""Device: ``torch.cuda.max_memory_allocated()`` over the window, the peak
statistics reset at the end of set-up."""

UNIT = "GiB"


def read(run):
    if run.peak_window_bytes is None:
        return None
    return run.peak_window_bytes / 2**30
