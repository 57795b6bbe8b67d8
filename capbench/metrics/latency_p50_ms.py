"""Median latency of the window's requests, each timed by the benchmark
from its due time to its result on the host."""


def read(rec: dict):
    return rec["window"].get("latency_p50_ms")
