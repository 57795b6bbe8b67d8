"""Device-busy milliseconds per training step: the union of the trace's
device records over the window's steps."""


def read(rec: dict):
    steps = rec["window"].get("steps")
    if not steps or rec["trace"]["busy_s"] <= 0:
        return None
    return 1e3 * rec["trace"]["busy_s"] / steps
