"""One LSTM layer of Bonito's CRF-CTC encoder (``models.crf.CrfEncoder``'s
``nn.LSTM(features, features)``) over a batch of chunks, in either
direction: the hand-written kernel ``csrc/lstm_layer.cu`` on the card and
its plain version ``lstm_layer_plain`` below, which the kernel follows
step for step.

No TPU kernel corresponds (the JAX package has no basecaller). The kernel
takes the place of cuDNN's LSTM for the widths its layout holds
(``kernel_holds``: features 384, the HAC model's); the engine
(``infer.basecall``) picks the route once from ``features``
(``lstm_route``).

Packing (``pack_lstm``, once per model): the gate rows of ``W_ih``,
``W_hh`` and the biases go to the (unit, gate) order ``4 u + g`` (gates i,
f, g, o), so that a unit's four gates are neighbours in the input
projection; ``hh_fragments`` lays ``W_hh`` out as the register images of
the kernel's wgmma A operand: CTA r of a cluster of 8, its warpgroup (3),
warp (4), k16 tile (H / 16), lane (32) and 4 registers of two fp16 each.
Rows 0-15 of a warp's tile are gates i, g, f, o (four rows each) of its
four units, so that the lanes that hold rows q and q + 8 hold gates (i, f)
or (g, o) of one unit.

Arithmetic (both versions): ``xp = x W_ih^T`` in x's type (on the card fp16
with f32 sums, one large product per layer); per step, in f32,
``h_{t-1} W_hh^T + xp_t + (b_ih + b_hh)``, the cell, c in f32; h rounded to
x's type. The kernel's sigmoid and tanh are f32 on the MUFU unit (one
reciprocal shared by a cell's gates), ~1e-6 relative from torch's. A
reversed layer walks t from the last step down and writes y in place
order, so ``lstm_layer(x, p, True)`` is ``flip(LSTM(flip(x)))``.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import torch
from torch import nn

from . import build

LSTM_LAYER = build.Kernel("lstm_layer", "lstm_layer", "none (no TPU kernel)")
KERNEL_FEATURES = 384          # the kernel's layout: 8 CTAs x 3 warpgroups x 16 units
CLUSTER, WARPGROUPS = 8, 3
CLUSTER_CHUNKS = (64, 72, 80)  # the kernel's instantiations, chunks a cluster
GATE_ROWS = (0, 2, 1, 3)       # gate of rows 4j .. 4j + 3 of a warp's 16


def kernel_holds(features: int) -> bool:
    """Whether the kernel's layout holds an LSTM of ``features`` units."""
    return features == KERNEL_FEATURES


def lstm_route(features: int, device) -> str:
    """The engine's route for its LSTMs: ``kernel`` (this module's kernel),
    ``cudnn`` (``nn.LSTM`` on the card, widths the kernel does not hold) or
    ``torch`` (``nn.LSTM`` on the CPU)."""
    if torch.device(device).type != "cuda":
        return "torch"
    return "kernel" if kernel_holds(features) else "cudnn"


def gate_order(h: int) -> torch.Tensor:
    """Packed row 4 u + g is torch's row g h + u."""
    u = torch.arange(h).repeat_interleave(4)
    g = torch.arange(4).repeat(h)
    return g * h + u


@dataclass
class PackedLstm:
    w_ih: torch.Tensor          # [4H, H], rows in the (unit, gate) order
    w_hh: torch.Tensor          # [4H, H], the same order
    bias: torch.Tensor          # [4H] f32, b_ih + b_hh in the same order
    frag: torch.Tensor | None   # W_hh's register images (hh_fragments)


def pack_lstm(rnn: nn.LSTM) -> PackedLstm:
    """An ``nn.LSTM(h, h)``'s weights in the kernel's order, on its device
    and in its type (the bias in f32), with the register images where the
    kernel holds the width."""
    h = rnn.hidden_size
    with torch.no_grad():
        order = gate_order(h).to(rnn.weight_hh_l0.device)
        w_hh = rnn.weight_hh_l0[order].contiguous()
        bias = (rnn.bias_ih_l0.float() + rnn.bias_hh_l0.float())[order].contiguous()
        return PackedLstm(rnn.weight_ih_l0[order].contiguous(), w_hh, bias,
                          hh_fragments(w_hh) if kernel_holds(h) else None)


def _fragment_index(h: int):
    """(rows, cols) [8, 3, 4, H / 16, 32, 4, 2] of the packed W_hh element
    of each fp16 in the register images: register r of lane (q, p) = (lane
    // 4, lane % 4) holds row q + 8 (r % 2) of the warp's 16 and columns
    16 k + 2 p + 8 (r // 2) + (0, 1) (mma.m16n8k16's A fragment)."""
    if not kernel_holds(h):
        raise ValueError(f"the LSTM kernel holds features {KERNEL_FEATURES}, not {h}")
    units = h // CLUSTER
    cta = torch.arange(CLUSTER).view(8, 1, 1, 1, 1, 1, 1)
    wg = torch.arange(WARPGROUPS).view(1, 3, 1, 1, 1, 1, 1)
    warp = torch.arange(4).view(1, 1, 4, 1, 1, 1, 1)
    k = torch.arange(h // 16).view(1, 1, 1, -1, 1, 1, 1)
    lane = torch.arange(32).view(1, 1, 1, 1, 32, 1, 1)
    reg = torch.arange(4).view(1, 1, 1, 1, 1, 4, 1)
    half = torch.arange(2).view(1, 1, 1, 1, 1, 1, 2)
    rho = lane // 4 + 8 * (reg % 2)                       # row of the warp's 16
    gate = torch.tensor(GATE_ROWS)[rho // 4]
    unit = units * cta + 16 * wg + 4 * warp + rho % 4
    rows = 4 * unit + gate
    cols = 16 * k + 2 * (lane % 4) + 8 * (reg // 2) + half
    shape = (CLUSTER, WARPGROUPS, 4, h // 16, 32, 4, 2)
    return rows.expand(shape), cols.expand(shape)


def hh_fragments(w_hh: torch.Tensor) -> torch.Tensor:
    """Packed W_hh [4H, H] fp16 as the kernel's register images, int32
    [8, 3, 4, H / 16, 32, 4] (each int32 two fp16, the lower column in the
    low half)."""
    rows, cols = _fragment_index(w_hh.shape[1])
    rows, cols = rows.to(w_hh.device), cols.to(w_hh.device)
    return w_hh.half()[rows, cols].contiguous().view(torch.int32).squeeze(-1)


def input_projection(x: torch.Tensor, p: PackedLstm) -> torch.Tensor:
    """x [T, N, H] -> x W_ih^T [T, N, 4H] in x's type (the packed order),
    rows of 4H contiguous. A permuted [N, H, T] x (the stem's output) is
    taken as it lies: one product per chunk of its [T, H] transpose, which
    cuBLAS reads as a column-major operand, so the [T, N, 4H] result is a
    view of [N, T, 4H]; a transposing copy of x costs more than the
    product."""
    if not x.is_contiguous() and x.permute(1, 2, 0).is_contiguous():
        xb = x.transpose(0, 1)                            # [N, T, H], column-major
        w = p.w_ih.t().unsqueeze(0).expand(xb.shape[0], -1, -1)
        return torch.bmm(xb, w).transpose(0, 1)
    return torch.matmul(x, p.w_ih.t())


def lstm_layer_plain(x: torch.Tensor, p: PackedLstm, reverse: bool) -> torch.Tensor:
    """Plain PyTorch version on x's device: the kernel's steps, with the
    products of x's type summed in f32 (the kernel's fp16 operands are
    exact in f32), c in f32 and h rounded to x's type each step."""
    t_len, n, h = x.shape
    xp = input_projection(x, p)
    w_hh = p.w_hh.float()
    bias = p.bias.float()
    hs = torch.zeros(n, h, dtype=x.dtype, device=x.device)
    c = torch.zeros(n, h, dtype=torch.float32, device=x.device)
    y = torch.empty_like(x)
    for s in range(t_len):
        t = t_len - 1 - s if reverse else s
        gates = ((hs.float() @ w_hh.t()) + xp[t].float()) + bias
        gi, gf, gg, go = gates.view(n, h, 4).unbind(-1)
        c = torch.sigmoid(gf) * c + torch.sigmoid(gi) * torch.tanh(gg)
        hs = (torch.sigmoid(go) * torch.tanh(c)).to(x.dtype)
        y[t] = hs
    return y


@functools.cache
def active_clusters(nc: int) -> int:
    """Clusters of the kernel at ``nc`` chunks a cluster that the card holds
    at once (cudaOccupancyMaxActiveClusters)."""
    fn = build.load("lstm_layer").nr_lstm_active_clusters
    fn.restype = build.ctypes.c_int
    fn.argtypes = [build.ctypes.c_int]
    return int(fn(nc))


def cluster_chunks(n: int) -> int:
    """The fewest chunks a cluster that put all ``n`` chunks in one wave of
    resident clusters (the most the kernel takes where none does)."""
    for nc in CLUSTER_CHUNKS:
        if -(-n // nc) <= active_clusters(nc):
            return nc
    return CLUSTER_CHUNKS[-1]


def lstm_layer(x: torch.Tensor, p: PackedLstm, reverse: bool) -> torch.Tensor:
    """y [T, N, H] (contiguous) of one layer. CPU tensors take the plain
    version; CUDA tensors (fp16, H the kernel holds, any strides)
    ``input_projection`` and one launch of the kernel, which reads the
    projection through its strides, on the current stream, with no scratch
    beyond the projection."""
    if x.device.type == "cpu":
        return lstm_layer_plain(x, p, reverse)
    build.require_cuda(x, p.w_ih, p.bias)
    t_len, n, h = x.shape
    if not kernel_holds(h) or p.frag is None:
        raise ValueError(f"the LSTM kernel holds features {KERNEL_FEATURES} "
                         f"with packed fragments, not {h}")
    if x.dtype != torch.float16:
        raise ValueError(f"x must be float16, got {x.dtype}")
    y = torch.empty((t_len, n, h), dtype=x.dtype, device=x.device)
    if n == 0 or t_len == 0:
        return y
    xp = input_projection(x, p)
    row = 4 * h                      # xp's rows are contiguous: strides in rows
    LSTM_LAYER.launch(
        "nr_lstm_layer", build.c_ptr(xp), build.c_int(xp.stride(0) // row),
        build.c_int(xp.stride(1) // row), build.c_ptr(p.bias), build.c_ptr(p.frag),
        build.c_ptr(y), build.c_int(t_len), build.c_int(n), build.c_int(int(reverse)),
        build.c_int(cluster_chunks(n)), build.stream_of(x.device))
    return y
