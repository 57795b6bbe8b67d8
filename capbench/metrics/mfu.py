"""The whole step's share of the chip's fp32 peak: the window's FLOPs,
counted from the configuration's shapes (``capbench/work.py``), over the
profiled window's wall seconds and 67e12 FLOP/s."""

from capbench import work


def read(rec: dict):
    flops, wall = rec["window"].get("flops"), rec["trace"]["window_s"]
    if not flops or wall <= 0:
        return None
    return 100.0 * flops / wall / work.PEAK_FP32_FLOPS
