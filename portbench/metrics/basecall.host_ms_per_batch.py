"""The CLI thread's milliseconds per device batch in the basecaller's host
work, from the program's own spans: ``basecall.chunk`` (chunks into the
pinned batch), ``basecall.submit`` (a batch to the card) and
``basecall.stitch`` (a read's labels into its bases), over the batches the
program counted (``basecall.batches``)."""

UNIT = "ms"
SPANS = ("basecall.chunk", "basecall.submit", "basecall.stitch")


def read(rec):
    took = [p["tracer"] for p in rec.get("passes", []) if p.get("tracer")]
    batches = sum(t["counters"].get("basecall.batches", 0) for t in took)
    if not batches:
        return None
    host = sum(t["span_s"].get(s, 0.0) for t in took for s in SPANS)
    return 1e3 * host / batches
