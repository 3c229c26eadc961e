"""Window gather: compacted int16 signal -> normalized bf16 window rows.

Replaces the TPU kernel ``_gather_kernel`` (``nanoreviser_tpu/ops/
window_gather.py:67``, entry ``window_gather_tpu`` ``:169``). For each base
row: the 50 int16 samples at ``pos0`` of the forward signal (indices clamped
to the buffer), ``(x - shift[read]) / scale[read]`` in f32, zero outside
``[left, left + vlen)`` with ``left = (50 - vlen + 1) // 2``, stored as
bf16. Rows at or past ``rows_valid`` are zero. The output is [N, 64]: lanes
50..63 are zero and pad each row to 128 bytes.

The result is bit-exact with the JAX package's ``window_gather_xla`` (and so
with the TPU kernel): IEEE division, round-to-nearest-even to bf16.
``vlen`` and ``read_id`` are masked to the 6 and 8 bits the JAX package
packs them into.
"""

from __future__ import annotations

import torch

from . import build

Q = 50            # window samples per base (reference query length)
QP = 64           # padded output row width

WINDOW_GATHER = build.Kernel("window_gather", "window_gather",
                             "nanoreviser_tpu/ops/window_gather.py:67")


def window_gather_plain(sig, pos0, vlen, read_id, shift, scale, rows_valid: int,
                        *, out_dtype=torch.bfloat16, width: int = QP):
    """Plain PyTorch version. sig int16 [S]; pos0/vlen/read_id int32 [N];
    shift/scale f32 [R]. Returns [N, width] in ``out_dtype`` (f32 [N, 50] is
    the CPU engine's input, mirroring ``window_gather_xla_f32``)."""
    n = pos0.shape[0]
    q = torch.arange(Q, dtype=torch.int64, device=sig.device)
    vl = (vlen & 63).to(torch.int64)[:, None]
    left = torch.div(Q - vl + 1, 2, rounding_mode="floor")
    idx = (pos0.to(torch.int64)[:, None] + q[None, :]).clamp(0, sig.shape[0] - 1)
    x = sig[idx].to(torch.float32)
    rid = (read_id & 255).to(torch.int64)
    norm = (x - shift[rid][:, None]) / scale[rid][:, None]
    valid = (q[None, :] >= left) & (q[None, :] < left + vl)
    valid = valid & (torch.arange(n, device=sig.device) < rows_valid)[:, None]
    out = torch.where(valid, norm, torch.zeros_like(norm))
    if width > Q:
        out = torch.nn.functional.pad(out, (0, width - Q))
    return out.to(out_dtype)


def window_gather(sig, pos0, vlen, read_id, shift, scale, rows_valid: int):
    """bf16 [N, 64] window rows. CPU tensors take the plain version; CUDA
    tensors launch the kernel (one thread per 8 lanes of a row, one 16-byte
    store each)."""
    if sig.device.type == "cpu":
        return window_gather_plain(sig, pos0, vlen, read_id, shift, scale,
                                   rows_valid)
    build.require_cuda(sig, pos0, vlen, read_id, shift, scale)
    n = pos0.shape[0]
    for name, t, dt in (("sig", sig, torch.int16), ("pos0", pos0, torch.int32),
                        ("vlen", vlen, torch.int32),
                        ("read_id", read_id, torch.int32),
                        ("shift", shift, torch.float32),
                        ("scale", scale, torch.float32)):
        if t.dtype != dt or t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous 1-D {dt}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    if vlen.shape[0] != n or read_id.shape[0] != n:
        raise ValueError("pos0, vlen and read_id must have one entry per row")
    if shift.shape[0] < 256 or scale.shape[0] < 256:
        raise ValueError("shift/scale tables need 256 entries (8-bit read ids)")
    if n * QP >= 2**31:
        raise ValueError(f"{n} rows exceed the kernel's 32-bit indexing")
    out = torch.empty((n, QP), dtype=torch.bfloat16, device=sig.device)
    if n == 0:
        return out
    WINDOW_GATHER.launch(
        "nr_window_gather",
        build.c_ptr(sig), build.c_int(sig.shape[0]), build.c_ptr(pos0),
        build.c_ptr(vlen), build.c_ptr(read_id), build.c_ptr(shift),
        build.c_ptr(scale), build.c_int(min(rows_valid, n)), build.c_int(n),
        build.c_ptr(out), build.stream_of(sig.device))
    return out
