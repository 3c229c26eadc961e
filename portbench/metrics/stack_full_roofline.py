"""``stack_full``'s share of its roofline over the traced window: the least
time the card needs for the windows and base rows of the reads revised
(``portbench.yardstick``: operations at the bf16 peak or bytes at the
memory rate, the larger) over the kernel's device time in the profiler's
trace."""

from portbench import yardstick

UNIT = "%"


def read(rec):
    tl = rec.get("trace")
    if not tl:
        return None
    names = [k for k in tl["ops"] if "stack_full" in k]
    secs = sum(tl["ops"][k] for k in names)
    if secs <= 0:
        return None
    launches = sum(tl["launches"][k] for k in names)
    windows = sum(p["windows"] for p in rec["passes"])
    rows = sum(p["rows"] for p in rec["passes"])
    cfg = rec["config"]
    least = yardstick.least_seconds(
        yardstick.model_flops(cfg, windows, rows),
        yardstick.stack_bytes(cfg, windows, rows, launches))
    return 100.0 * least / secs
