"""The model's operations for every window revised (``portbench.yardstick``)
over the window's seconds at the card's bf16 peak (989 TFLOP/s): the whole
revision's share of the chip's peak."""

from portbench import yardstick

UNIT = "%"


def read(rec):
    passes = rec.get("passes", [])
    if not passes or rec.get("window_s", 0) <= 0:
        return None
    flops = yardstick.model_flops(rec["config"], sum(p["windows"] for p in passes),
                                  sum(p["rows"] for p in passes))
    return 100.0 * flops / (rec["window_s"] * yardstick.PEAK_BF16_FLOPS)
