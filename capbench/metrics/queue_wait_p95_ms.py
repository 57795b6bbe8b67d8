"""The 95th percentile of the program's ``engine.queue_wait_s`` samples
(ms): each admitted request's wait from ``submit`` to its slot
(``repro_torch.obs``).  None where the program records no samples."""

import numpy as np


def read(rec: dict):
    try:
        from repro_torch import obs
    except ImportError:
        return None
    got = obs.snapshot().samples.get("engine.queue_wait_s")
    return 1e3 * float(np.percentile(got, 95)) if got else None
