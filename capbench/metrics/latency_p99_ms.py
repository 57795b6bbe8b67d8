"""99th percentile latency of the window's requests, each timed by the
benchmark from its due time to its result on the host: the tail that
host stalls and the interpreter's full collections set."""


def read(rec: dict):
    return rec["window"].get("latency_p99_ms")
