"""The kernels' share of their roofline: the least time the chip could
take for the window's work, the larger of its FLOPs over 67e12 FLOP/s
and its bytes over 3.35e12 B/s (``capbench/work.py``), over the seconds
in which the device was busy."""


def read(rec: dict):
    bound, busy = rec["window"].get("bound_s"), rec["trace"]["busy_s"]
    if not bound or busy <= 0:
        return None
    return 100.0 * bound / busy
