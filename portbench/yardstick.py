"""The yardstick's arithmetic: the card's published peaks and the
operations and bytes the NanoReviser model needs, counted from a
configuration's published widths (never from the program's packed
weights or its own counters).

Operations are multiply-adds times two. Per model, the conv branch, its
Dense and the two input projections that depend on one base row only (the
features into Bi-LSTM layer 1, the signal branch into layer 3) count once
per base row a window uses; the rest (the recurrent products, the other
input projections, the per-step heads, the feature and the final Dense)
once per window. A read of n bases has n - T windows, which use its first
n - 1 rows.

Bytes: each base row's 50 signal samples and 6 features read once in bf16,
both models' weights once a launch in bf16, and each window's logits
(6 + 5) written once in f32.
"""

from __future__ import annotations

# NVIDIA H100 SXM, dense, at its 700 W limit (NVIDIA's data sheet)
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES_PER_S = 3.35e12


def row_macs(cfg: dict) -> int:
    """Multiply-adds of one model per base row."""
    q, f, k = cfg["signal_len"], cfg["conv_filters"], cfg["conv_kernel"]
    d_sig = cfg["signal_dense_units"]
    h1, _, h3, _ = cfg["lstm_units"]
    conv = q * k * 1 * f + q * k * f * f + q * f * d_sig
    return conv + 2 * cfg["n_features"] * 4 * h1 + 2 * d_sig * 4 * h3


def window_macs(cfg: dict, n_classes: int) -> int:
    """Multiply-adds of one model per window, past the per-row work."""
    h1, h2, h3, h4 = cfg["lstm_units"]
    d1, d2 = cfg["dense_units"]
    main, feat = cfg["main_out_units"], cfg["feature_units"]
    recurrent = 2 * (h1 * 4 * h1 + h2 * 4 * h2 + h3 * 4 * h3 + h4 * 4 * h4)
    inputs = 2 * (2 * h1 * 4 * h2 + 2 * h2 * 4 * h3 + 2 * h3 * 4 * h4)
    heads = 2 * h4 * d1 + d1 * d2 + d2 * main + main * feat
    return (recurrent + inputs + heads) * cfg["window"] + feat * n_classes


def weight_count(cfg: dict, n_classes: int) -> int:
    """Parameters of one model in the serving path (BN as 4 vectors)."""
    q, f, k = cfg["signal_len"], cfg["conv_filters"], cfg["conv_kernel"]
    d_sig = cfg["signal_dense_units"]
    h1, h2, h3, h4 = cfg["lstm_units"]
    d1, d2 = cfg["dense_units"]
    main, feat = cfg["main_out_units"], cfg["feature_units"]
    n = k * f + f + k * f * f + f + q * f * d_sig + d_sig
    n += 4 * (2 * f + 2 * h1 + 2 * h2 + 2 * h3)
    for d_in, h in ((cfg["n_features"], h1), (2 * h1, h2),
                    (2 * h2 + d_sig, h3), (2 * h3, h4)):
        n += 2 * (d_in * 4 * h + h * 4 * h + 4 * h)
    for d_in, d_out in ((2 * h4, d1), (d1, d2), (d2, main),
                        (cfg["window"] * main, feat), (feat, n_classes)):
        n += d_in * d_out + d_out
    return n


def read_work(cfg: dict, n_bases: int) -> tuple[int, int]:
    """(windows, base rows those windows use) of one read."""
    w = max(n_bases - cfg["window"], 0)
    return w, (w + cfg["window"] - 1 if w else 0)


def model_flops(cfg: dict, windows: int, rows: int) -> float:
    """Operations of both models over ``windows`` windows and ``rows``
    rows."""
    return 2.0 * sum(row_macs(cfg) * rows + window_macs(cfg, nc) * windows
                     for nc in cfg["n_classes"])


def stack_bytes(cfg: dict, windows: int, rows: int, launches: int) -> float:
    row_in = 2 * (cfg["signal_len"] + cfg["n_features"])
    weights = 2 * sum(weight_count(cfg, nc) for nc in cfg["n_classes"])
    return (rows * row_in + launches * weights
            + windows * 4 * sum(cfg["n_classes"]))


def least_seconds(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the operations
    over the bf16 peak and the bytes over the memory rate."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES_PER_S)
