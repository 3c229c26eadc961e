"""The encoder's operations for every chunk of the reads basecalled
(``portbench.crf_yardstick``: convolutions, LSTMs, linear layer) over the
window's seconds at the card's fp16 peak (989 TFLOP/s): the whole
basecall's share of the chip's peak."""

from portbench import crf_yardstick

UNIT = "%"


def read(rec):
    passes = rec.get("passes", [])
    chunks = sum(p.get("chunks", 0) for p in passes)
    if not chunks or rec.get("window_s", 0) <= 0:
        return None
    flops = crf_yardstick.model_flops(rec["config"], chunks)
    return 100.0 * flops / (rec["window_s"] * crf_yardstick.PEAK_FP16_FLOPS)
