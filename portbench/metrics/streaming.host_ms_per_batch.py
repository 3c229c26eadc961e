"""The CLI process's milliseconds per device batch in the engine's host
work and the writer: ``StreamingReviser._add_read``, ``_submit`` and
``_merge_one`` and ``write_read_fasta``, over the batches of the
engines' counters (``StreamingReviser.stats``)."""

UNIT = "ms"
SPANS = ("add_read", "submit", "merge", "write")


def read(rec):
    passes = [p for p in rec.get("passes", []) if "engines" in p]
    batches = sum(e["batches"] for p in passes for e in p["engines"])
    if not batches:
        return None
    host = sum(p["span_s"].get(s, 0.0) for p in passes for s in SPANS)
    return 1e3 * host / batches
