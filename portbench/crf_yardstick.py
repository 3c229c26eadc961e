"""The yardstick of the CRF-CTC basecaller cells: the card's published
peaks and the operations and bytes Bonito's CRF-LSTM model needs, counted
from a configuration's published widths and the reads' signal lengths
(never from the program's counters).

Chunks follow Bonito's rule: a read of n samples is one chunk when n <=
chunksize, else ``(n - overlap - stub) / (chunksize - overlap)`` chunks
plus one at the start where the stub ``(n - overlap) % (chunksize -
overlap)`` is not 0. A chunk has ``(chunksize + 2 (winlen // 2) - winlen)
// stride + 1`` steps.

Operations are multiply-adds times two. Per chunk: the three convolutions
(1 -> 4 and 4 -> 16 of width 5 at every sample, 16 -> features of width
winlen at every step), the LSTMs (4 gates of ``features`` units over the
input and the state, per step and layer) and the linear layer (features ->
4 ** (state_len + 1) per step). The decode: per step, each of the S * 5
transitions (S = 4 ** state_len) takes a fixed 12 float32 operations over
its three passes (the backward recursion, the forward recursion and its
posterior, the Viterbi step: an add and a share of an exp-sum or a max in
each, and the posterior's exp and log), at the card's float32 peak outside
the tensor cores; its bytes are the fp16 move scores read once and a label
written per step (the cells write fasta: no quality bytes).
"""

from __future__ import annotations

# NVIDIA H100 SXM at its 700 W limit (NVIDIA's data sheet): dense fp16,
# float32 outside the tensor cores, HBM3
PEAK_FP16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES_PER_S = 3.35e12
DECODE_OPS_PER_TRANSITION = 12


def steps(cfg: dict) -> int:
    pad = cfg["winlen"] // 2
    return (cfg["chunksize"] + 2 * pad - cfg["winlen"]) // cfg["stride"] + 1


def read_chunks(cfg: dict, n_samples: int) -> int:
    c, o = cfg["chunksize"], cfg["overlap"]
    if n_samples <= c:
        return 1
    stub = (n_samples - o) % (c - o)
    return (n_samples - o - stub) // (c - o) + (stub > 0)


def lstm_macs(cfg: dict) -> int:
    """Multiply-adds of the LSTMs of one chunk."""
    h = cfg["features"]
    return steps(cfg) * cfg["n_layers"] * 4 * h * (h + h)


def chunk_macs(cfg: dict) -> int:
    """Multiply-adds of the encoder over one chunk."""
    c, h, t = cfg["chunksize"], cfg["features"], steps(cfg)
    convs = c * 4 * 5 * 1 + c * 16 * 5 * 4 + t * h * cfg["winlen"] * 16
    linear = t * h * 4 ** (cfg["state_len"] + 1)
    return convs + lstm_macs(cfg) + linear


def model_flops(cfg: dict, chunks: int) -> float:
    return 2.0 * chunk_macs(cfg) * chunks


def lstm_flops(cfg: dict, chunks: int) -> float:
    return 2.0 * lstm_macs(cfg) * chunks


def decode_flops(cfg: dict, chunks: int) -> float:
    n_states = 4 ** cfg["state_len"]
    return float(DECODE_OPS_PER_TRANSITION * steps(cfg) * n_states * 5 * chunks)


def decode_bytes(cfg: dict, chunks: int) -> float:
    t = steps(cfg)
    moves = 4 ** (cfg["state_len"] + 1)
    return float(chunks * t * (2 * moves + 1))


def decode_least_seconds(cfg: dict, chunks: int) -> float:
    """The least time the card could take to decode ``chunks`` chunks: the
    larger of the operations at the float32 peak and the bytes at the
    memory rate."""
    return max(decode_flops(cfg, chunks) / PEAK_F32_FLOPS,
               decode_bytes(cfg, chunks) / PEAK_HBM_BYTES_PER_S)
