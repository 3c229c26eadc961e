"""The CRF decode kernel's share of its roofline over the profiled pass:
the least time the card needs to decode the chunks of the reads basecalled
(``portbench.crf_yardstick``: float32 operations at the card's float32
peak or bytes at the memory rate, the larger) over the kernel's device
time in the profiler's trace."""

from portbench import crf_yardstick

UNIT = "%"


def read(rec):
    tl = rec.get("trace")
    if not tl:
        return None
    secs = sum(v for k, v in tl["ops"].items() if "crf_decode" in k)
    if secs <= 0:
        return None
    chunks = sum(p.get("chunks", 0) for p in rec["passes"]
                 if p.get("profiled"))
    least = crf_yardstick.decode_least_seconds(rec["config"], chunks)
    return 100.0 * least / secs
