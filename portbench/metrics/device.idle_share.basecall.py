"""The share of the profiled pass (the traced window's first) in which no
operation ran on the card, from the profiler's timeline."""

UNIT = "%"


def read(rec):
    tl = rec.get("trace")
    if not tl or tl["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tl["busy_s"] / tl["window_s"])
