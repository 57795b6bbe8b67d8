"""Median latency of the window's queries, each timed by the benchmark
from its submission to its last result on the host (MultiStream)."""


def read(rec: dict):
    return rec["window"].get("query_p50_ms")
