"""Share of the engine's slots filled per tick over the window, from the
engine's own counters (``CapsuleEngine.stats()["occupancy"]``)."""


def read(rec: dict):
    occ = rec["window"].get("occupancy")
    return None if occ is None else 100.0 * occ
