"""Verification of the port's runtime contracts.

``verify.invariants`` holds the counter checks of ``CapsuleEngine.stats()``
that the serving tests and ``chip_smoke.py`` share.  The reference's plan
auditor and contract lint are ROADMAP queue 1, item 5.
"""

from repro_torch.verify.invariants import (assert_engine_stats,  # noqa: F401
                                           check_engine_stats)

__all__ = ["check_engine_stats", "assert_engine_stats"]
