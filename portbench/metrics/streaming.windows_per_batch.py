"""Windows the device computes per batch (``StreamingReviser.stats``:
windows over batches; a batch's windows include those that straddle two
reads)."""

UNIT = "windows"


def read(rec):
    engines = [e for p in rec.get("passes", []) for e in p.get("engines", [])]
    batches = sum(e["batches"] for e in engines)
    if not batches:
        return None
    return sum(e["windows"] for e in engines) / batches
