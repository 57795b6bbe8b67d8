"""Device-busy milliseconds per engine tick (one forward over the slot
batch): the union of the trace's device records over the window's
ticks."""


def read(rec: dict):
    ticks = rec["window"].get("ticks")
    if not ticks or rec["trace"]["busy_s"] <= 0:
        return None
    return 1e3 * rec["trace"]["busy_s"] / ticks
