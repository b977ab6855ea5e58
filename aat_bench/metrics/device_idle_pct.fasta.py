"""The device's idle share of the window: 1 - (the union of the
profiler's kernel, copy and memset intervals in the window) / the
window."""


def read(run):
    if not run.device or run.device["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - run.device["busy_s"] / run.device["window_s"])
