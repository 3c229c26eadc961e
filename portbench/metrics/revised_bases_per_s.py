"""Bases of every read revised in the window over all the window's seconds
(whole passes, each with the CLI's start-up), by the host's clock."""

UNIT = "bases/s"


def read(rec):
    if not rec.get("passes") or rec.get("window_s", 0) <= 0:
        return None
    return sum(p["bases"] for p in rec["passes"]) / rec["window_s"]
