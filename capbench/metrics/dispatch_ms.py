"""The median ``engine.dispatch`` span (ms): the host's time launching
every shard's forward in a tick (``repro_torch.obs``).  None where the
program records no spans."""

import statistics


def read(rec: dict):
    try:
        from repro_torch import obs
    except ImportError:
        return None
    got = [s.end_ns - s.start_ns for s in obs.snapshot().spans
           if s.name == "engine.dispatch"]
    return statistics.median(got) / 1e6 if got else None
