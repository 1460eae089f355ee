"""Share of the traced window in which nothing ran on the card (the
profiler's kernels, copies and fills, merged)."""


def read(r):
    w = r.trace.get("window_s", 0.0)
    if w <= 0.0:
        return None
    return 100.0 * (1.0 - r.trace["busy_s"] / w)
