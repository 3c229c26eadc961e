"""The prep pool's start-up (``PrepPool.ready``'s return value: seconds
from the pool's construction until every worker has started), the mean
over the window's passes."""

UNIT = "s"


def read(rec):
    got = [s for p in rec.get("passes", []) for s in p.get("pool_start_s", [])]
    return sum(got) / len(got) if got else None
