"""Share of the profiled window in which nothing ran on the device:
1 - (union of the trace's device records) / (the window's wall time)."""


def read(rec: dict):
    t = rec["trace"]
    if t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
