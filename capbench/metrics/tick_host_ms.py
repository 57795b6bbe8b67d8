"""The host's serial work a tick (ms): the median, over the program's
``engine.step`` spans that hold an ``engine.readback``, of the step's
length less its read-back's (``repro_torch.obs``; the read-back is where
the host waits for the card).  None where the program records no spans."""

import statistics


def read(rec: dict):
    try:
        from repro_torch import obs
    except ImportError:
        return None
    spans = obs.snapshot().spans
    steps = {s.id: s.end_ns - s.start_ns for s in spans
             if s.name == "engine.step"}
    host = [steps[s.parent] - (s.end_ns - s.start_ns) for s in spans
            if s.name == "engine.readback" and s.parent in steps]
    return statistics.median(host) / 1e6 if host else None
