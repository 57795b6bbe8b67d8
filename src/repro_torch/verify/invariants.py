"""Counter invariants of ``CapsuleEngine.stats()``: the port's copy of
``repro/verify/invariants.py``.

Every submitted request reaches exactly one terminal status, and the
per-shard counters plus the queue bucket tell the same story as the
aggregates.  Pure dict checks: no engine import, so they run on recorded
``stats()`` payloads too.
"""

from __future__ import annotations

# The serving engine's TERMINAL_STATUSES, kept here without importing the
# serving stack; a test pins the two together.
TERMINAL_STATUSES = ("ok", "timeout", "error", "shed")


def check_engine_stats(stats: dict) -> list[str]:
    """Every counter-sum invariant violation in a ``stats()`` dict (an
    empty list when healthy):

    * the terminal statuses partition the submissions:
      ``ok + timeout + error + shed == submitted``;
    * one row per shard: ``len(per_shard) == n_shards``;
    * the per-shard counters plus the queue bucket (requests that never
      reached a slot) give each aggregate terminal counter;
    * the per-shard quarantines sum to the aggregate.
    """
    problems: list[str] = []
    terminal = sum(stats[st] for st in TERMINAL_STATUSES)
    if terminal != stats["submitted"]:
        problems.append(
            f"terminal statuses sum to {terminal}, not submitted="
            f"{stats['submitted']} "
            f"({ {st: stats[st] for st in TERMINAL_STATUSES} })")
    shards = stats.get("per_shard", [])
    if len(shards) != stats.get("n_shards", len(shards)):
        problems.append(f"{len(shards)} per-shard rows for "
                        f"n_shards={stats.get('n_shards')}")
    queue = stats.get("queue_bucket", {})
    for st in TERMINAL_STATUSES:
        sharded = sum(sh[st] for sh in shards) + queue.get(st, 0)
        if sharded != stats[st]:
            problems.append(
                f"{st}: per-shard+queue accounting {sharded} != "
                f"aggregate {stats[st]}")
    if shards:
        q_sum = sum(sh.get("quarantined", 0) for sh in shards)
        if q_sum != stats.get("quarantined", q_sum):
            problems.append(
                f"quarantined: per-shard sum {q_sum} != aggregate "
                f"{stats.get('quarantined')}")
    return problems


def assert_engine_stats(engine) -> dict:
    """Assert the whole terminal-accounting contract on a live engine and
    return its ``stats()`` dict."""
    s = engine.stats()
    bad = [r.status for r in engine.finished
           if r.status not in TERMINAL_STATUSES]
    assert not bad, f"non-terminal finished statuses: {bad}"
    assert len(engine.finished) == s["submitted"], (
        f"{len(engine.finished)} finished records for "
        f"{s['submitted']} submissions")
    assert not engine.queue and all(a is None for a in engine.active), (
        "engine still holds queued/active work")
    problems = check_engine_stats(s)
    assert not problems, "; ".join(problems)
    return s
