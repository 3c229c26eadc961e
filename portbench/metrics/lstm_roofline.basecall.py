"""The five LSTMs' share of the fp16 peak over the profiled pass: their
operations for the chunks of the reads basecalled
(``portbench.crf_yardstick``) at 989 TFLOP/s over the device time of the
kernels the program launched inside its ``basecall.lstm`` spans."""

from portbench import crf_yardstick

UNIT = "%"


def read(rec):
    tl = rec.get("trace")
    secs = (tl or {}).get("span_device_s", {}).get("basecall.lstm", 0.0)
    if secs <= 0:
        return None
    chunks = sum(p.get("chunks", 0) for p in rec["passes"]
                 if p.get("profiled"))
    flops = crf_yardstick.lstm_flops(rec["config"], chunks)
    return 100.0 * flops / crf_yardstick.PEAK_FP16_FLOPS / secs
