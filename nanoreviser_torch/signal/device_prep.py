"""Batch finishing of host-prepped windows: normalize and mask (counterpart of
``nanoreviser_tpu/signal/device_prep.py``, plain XLA there).

The windowed prep (``signal.host_prep.prep_read_numpy``) gathers each base's
raw int16 window on the host; this step runs on whatever device its inputs
lie on: int16 -> f32, per-read ``(x - shift) / scale``, then the reference's
symmetric zero-pad mask (preprocessing.py:111-118). The mask comes after the
normalization because a raw 0 DAC value is not signal zero. Plain torch ops:
the division is IEEE on the CPU and on the card, so the result equals the
JAX function bit for bit.
"""

from __future__ import annotations

import torch


def device_preprocess_batch(
    win: torch.Tensor,       # [N_pad, Q] int16 raw window samples
    vlen: torch.Tensor,      # [N_pad] uint8 valid window length per row
    feats: torch.Tensor,     # [N_pad, 6] f16 final features
    shift_b: torch.Tensor,   # [N_pad] f32 per-read median, broadcast per base
    scale_b: torch.Tensor,   # [N_pad] f32 per-read MAD (pad rows: 1.0)
):
    """Finish a host-prepped batch: (windows [N, Q] f32, feats [N, 6] f32)."""
    query_len = win.shape[1]
    x = win.to(torch.float32)
    w = (x - shift_b[:, None]) / scale_b[:, None]
    vl = vlen.to(torch.int32)
    left = torch.div(query_len - vl + 1, 2, rounding_mode="floor")
    cols = torch.arange(query_len, dtype=torch.int32, device=win.device)[None, :]
    valid = (cols >= left[:, None]) & (cols < (left + vl)[:, None])
    windows = torch.where(valid, w, torch.zeros((), dtype=w.dtype, device=w.device))
    return windows, feats.to(torch.float32)
