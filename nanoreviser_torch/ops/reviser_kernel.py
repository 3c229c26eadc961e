"""The reviser stack: weight packing, plain versions, and the entries to the
two CUDA kernels of ``csrc/reviser_stack.cu``.

``stack_logits_full`` replaces the TPU kernel ``_kernel_full``
(``nanoreviser_tpu/ops/reviser_kernel.py:283``, entry ``stack_logits_full``
``:678``) with one kernel, ``stack_full``. Per base row w of a batch,
window w covers rows w..w+T-1. The function, in two plain halves:

* ``base_rows_plain`` (once per base row and model): the conv branch in
  dense form, ``relu(x@W1+c1) -> relu(.@W2+c2) -> .@C + x@E + cb`` (50 ->
  400 -> 400 -> 64), the layer-1 input projections of both directions (6 ->
  2x64, bias included) and the layer-3 signal projections (64 -> 2x512).
  Outputs ``p1`` [2, N, 128] and ``p3`` [2, N, 1024] in f32.
* ``stack_heads_plain`` (per window and model): 4 Bi-LSTM layers (H
  16/64/128/64, Keras hard_sigmoid gates), the per-t relu heads 128 -> 128
  -> 32 -> 6, ``feature = relu(sum_t main_t @ fw[t] + fb)``, the logits
  ``feature @ fow + fob`` and optionally the max softmax probability
  ``1 / sum(exp(l - max))``.

The kernel runs the conv branch per base row into shared memory and the
two projections per (window, t) from there, on the tensor cores; its
products read the weights in mma fragment order (``pack_full_weights``,
made once per engine by ``kernel_weights``), Bi-LSTM layers 2-4 in the
order a producer warp streams them into the block's ring, 16 KB a fill.
Both kernels launch as clusters of ``stack_cluster_size()`` = 2 blocks
that split Bi-LSTM layers 2-4 by direction (each block streams half of
their weights for both blocks' windows); the logits are bit-identical to
the unsplit schedule's.

The pre-gathered-window entry ``stack_logits_multi`` replaces the TPU kernel
``_kernel`` (``nanoreviser_tpu/ops/reviser_kernel.py:251``, entries
``stack_logits_multi`` ``:611`` and ``stack_logits_pallas`` ``:749``): each
window brings its own T rows of features and conv-branch output, so nothing
is shared between windows. One kernel, ``stack_windows``, stages those rows
and runs ``stack_full``'s stack core on them (the layer-1 and
layer-3-signal projections per (window, t), the 4 layers and the heads of
``stack_heads_plain``), for 1 or 2 models, from the same fragment-packed
weights.

Rounding follows the TPU kernel: matmul operands are bf16 with f32
accumulation; z1, z2 and s64 are rounded to bf16 (``:339-348``); p1/p3
stay f32; h is rounded to bf16 after every step while c stays f32
(``:136-143``); head activations and the feature are rounded to bf16 before
the next product. Model 2 has 5 classes; its 6th logit carries bias -1e9 so
it never wins.

Weights are packed unpadded, row-major, in the layout the plain versions
read and ``pack_full_weights`` packs from: each matrix [in, out], LSTM gate
columns i,f,c,o of one direction contiguous, the two directions side by
side where one projection produces both (``wi1``, ``b1``, ``wi3s``) and on
a leading direction axis otherwise; both models stacked on a leading model
axis.

Two plain versions sit beside the kernels: the f32 one (the CPU engine's
path, held against the JAX f32 model) and the bf16-operand one (held
against the TPU kernels in interpret mode and, on the card, against the CUDA
kernels). Both share one stack core, fed per step either base-row slices
(``stack_heads_plain``) or per-window projections (``stack_windows_plain``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..models.fused import bn_affine
from . import build

H1, H2, H3, H4 = 16, 64, 128, 64    # hidden sizes of the 4 Bi-LSTM layers
NB_MAX = 6                          # model1 class count; model2 padded to it
Q = 50                              # signal samples per base row
QP = 64                             # padded row width of the gathered signal
PAD_LOGIT_BIAS = -1e9

# the kernels' fragment-packed products (pack_full_weights), per model:
# [n8 tiles, k16 tiles, 32 lanes, 4] for a product; for the gate product of
# Bi-LSTM layer 1 [directions, unit groups of 8, k16 tiles of the
# segments, gate pairs (i f | c o), 32 lanes, 2 gates x 4], for layers 2-4
# the same tiles as the ring's 16 KB fills [directions, fills a step, 8
# warps, 2 tiles, gate pairs, 32 lanes, 2 gates x 4]
FULL_SHAPES = {
    "cw1_f": (50, 4, 32, 4), "cw2_f": (50, 25, 32, 4),
    "cc_f": (8, 25, 32, 4), "ce_f": (8, 4, 32, 4),
    "l1_f": (2, H1 // 8, 2, 2, 32, 8), "l2_r": (2, 3, 8, 2, 2, 32, 8),
    "l3_r": (2, 20, 8, 2, 2, 32, 8), "l4_r": (2, 10, 8, 2, 2, 32, 8),
    "d1_f": (16, 8, 32, 4), "d2_f": (4, 8, 32, 4), "mo_f": (1, 2, 32, 4),
}
# matrices go to the kernels in bf16, biases in f32
MATRICES = ("cw1", "cw2", "cc", "ce", "wi1", "wi3s", "wh1", "wi2", "wh2",
            "wi3", "wh3", "wi4", "wh4", "d1w", "d2w", "mow", "fw",
            "fow") + tuple(FULL_SHAPES)
# the argument order of the C entries (csrc/reviser_stack.cu), per model:
# the stack core's weights (all that nr_stack_windows reads), and before
# them the conv branch's for nr_stack_full
CONV_ORDER = ("cw1_f", "cb1", "cw2_f", "cb2", "cc_f", "ce_f", "cbias")
CORE_ORDER = ("l1_f", "b1", "l2_r", "b2", "l3_r", "b3", "l4_r", "b4",
              "d1_f", "d1b", "d2_f", "d2b", "mo_f", "mob",
              "fw", "fb", "fow", "fob")
FULL_ORDER = CONV_ORDER + CORE_ORDER


def stack_shapes(t_len: int) -> dict:
    """Per-model shape of every packed weight."""
    return {
        "cw1": (Q, 400), "cb1": (400,), "cw2": (400, 400), "cb2": (400,),
        "cc": (400, 64), "ce": (Q, 64), "cbias": (64,),
        "wi1": (6, 2 * 4 * H1), "b1": (2 * 4 * H1,),
        "wi3s": (64, 2 * 4 * H3),
        "wh1": (2, H1, 4 * H1),
        "wi2": (2, 2 * H1, 4 * H2), "b2": (2, 4 * H2), "wh2": (2, H2, 4 * H2),
        "wi3": (2, 2 * H2, 4 * H3), "b3": (2, 4 * H3), "wh3": (2, H3, 4 * H3),
        "wi4": (2, 2 * H3, 4 * H4), "b4": (2, 4 * H4), "wh4": (2, H4, 4 * H4),
        "d1w": (2 * H4, 128), "d1b": (128,), "d2w": (128, 32), "d2b": (32,),
        "mow": (32, NB_MAX), "mob": (NB_MAX,),
        "fw": (t_len, NB_MAX, 16), "fb": (16,),
        "fow": (16, NB_MAX), "fob": (NB_MAX,),
    }


# --------------------------------------------------------------- weight prep


def conv_dense_form(params: dict) -> dict:
    """Fold the conv residual block + per-step dense into 3 dense matmuls
    (copy of ``nanoreviser_tpu/ops/reviser_kernel.py:384``, numpy f64).

    Conv1D('same', k=3) is a banded linear map, so with the BN affines
    (s, t) folded the branch x[50] -> out64 is exactly
      out64 = relu(relu(x@W1 + c1) @ W2 + c2) @ C + x@E + cb
    with W1 [50, 400], W2 [400, 400], C [400, 64], E [50, 64].
    """
    w1 = np.asarray(params["conv1"]["w"], np.float64)   # [3, 1, F]
    b1 = np.asarray(params["conv1"]["b"], np.float64)
    w2 = np.asarray(params["conv2"]["w"], np.float64)   # [3, F, F]
    b2 = np.asarray(params["conv2"]["b"], np.float64)
    d = np.asarray(params["sig_dense"]["w"], np.float64)   # [S*F, 64]
    bd = np.asarray(params["sig_dense"]["b"], np.float64)
    s1, t1 = bn_affine(params["bn_c1"])
    s2, t2 = bn_affine(params["bn_c2"])
    kk, _, f = w1.shape
    s = d.shape[0] // f
    half = kk // 2

    # W1[j, p*F + c] = w1[j - p + half, 0, c] for |j - p| <= half
    w1_dense = np.zeros((s, s * f), np.float64)
    w2_dense = np.zeros((s * f, s * f), np.float64)
    for p in range(s):
        for dk in range(-half, half + 1):
            j = p + dk
            if 0 <= j < s:
                w1_dense[j, p * f : (p + 1) * f] = w1[dk + half, 0]
                w2_dense[j * f : (j + 1) * f, p * f : (p + 1) * f] = w2[dk + half]
    c1 = np.tile(b1, s)
    s1r, t1r = np.tile(s1, s), np.tile(t1, s)
    s2r, t2r = np.tile(s2, s), np.tile(t2, s)

    w2f = s1r[:, None] * w2_dense
    c2 = t1r @ w2_dense + np.tile(b2, s)
    c_mat = s2r[:, None] * d
    e_mat = d.reshape(s, f, -1).sum(axis=1)            # residual x broadcast
    cb = t2r @ d + bd
    return {
        "W1": w1_dense.astype(np.float32), "c1": c1.astype(np.float32),
        "W2": w2f.astype(np.float32), "c2": c2.astype(np.float32),
        "C": c_mat.astype(np.float32), "E": e_mat.astype(np.float32),
        "cb": cb.astype(np.float32),
    }


def pack_stack_weights(fused: dict, t_len: int) -> dict:
    """Kernel-layout f32 weights of one model from BN-folded params
    (``models.fused.fold_inference_params``)."""
    f32 = lambda x: np.asarray(x, np.float32)
    cd = conv_dense_form(fused)
    w = {"cw1": cd["W1"], "cb1": cd["c1"], "cw2": cd["W2"], "cb2": cd["c2"],
         "cc": cd["C"], "ce": cd["E"], "cbias": cd["cb"]}

    r1, r2 = fused["read_rnn1"], fused["read_rnn2"]
    t1, t2 = fused["total_rnn1"], fused["total_rnn2"]
    dirs = ("fwd", "bwd")
    w["wi1"] = np.concatenate([f32(r1[d]["wi"]) for d in dirs], axis=1)
    w["b1"] = np.concatenate([f32(r1[d]["b"]) for d in dirs])
    w["wh1"] = np.stack([f32(r1[d]["wh"]) for d in dirs])
    w["wi2"] = np.stack([f32(r2[d]["wi"]) for d in dirs])
    w["b2"] = np.stack([f32(r2[d]["b"]) for d in dirs])
    w["wh2"] = np.stack([f32(r2[d]["wh"]) for d in dirs])
    # total_rnn1 input = [read (2*H2) | signal (64)]: the signal rows are
    # applied once per base row (base_rows_plain), the read rows per window
    w["wi3"] = np.stack([f32(t1[d]["wi"])[: 2 * H2] for d in dirs])
    w["wi3s"] = np.concatenate([f32(t1[d]["wi"])[2 * H2 :] for d in dirs], axis=1)
    w["b3"] = np.stack([f32(t1[d]["b"]) for d in dirs])
    w["wh3"] = np.stack([f32(t1[d]["wh"]) for d in dirs])
    w["wi4"] = np.stack([f32(t2[d]["wi"]) for d in dirs])
    w["b4"] = np.stack([f32(t2[d]["b"]) for d in dirs])
    w["wh4"] = np.stack([f32(t2[d]["wh"]) for d in dirs])

    w["d1w"], w["d1b"] = f32(fused["dense1"]["w"]), f32(fused["dense1"]["b"])
    w["d2w"], w["d2b"] = f32(fused["dense2"]["w"]), f32(fused["dense2"]["b"])
    w["mow"], w["mob"] = f32(fused["main_out"]["w"]), f32(fused["main_out"]["b"])
    w["fw"] = f32(fused["feature"]["w"]).reshape(t_len, NB_MAX, 16)
    w["fb"] = f32(fused["feature"]["b"])
    fow = f32(fused["final_out"]["w"])                    # [16, C]
    n_cls = fow.shape[1]
    w["fow"] = np.zeros((16, NB_MAX), np.float32)
    w["fow"][:, :n_cls] = fow
    w["fob"] = np.full(NB_MAX, PAD_LOGIT_BIAS, np.float32)
    w["fob"][:n_cls] = f32(fused["final_out"]["b"])

    for k, shape in stack_shapes(t_len).items():
        if w[k].shape != shape:
            raise ValueError(f"packed {k} has shape {w[k].shape}, want {shape}")
    return w


def stack_models(per_model: list[dict]) -> dict:
    """Stack per-model packed weights on a leading model axis."""
    return {k: np.stack([m[k] for m in per_model]) for k in per_model[0]}


def weights_to_device(ws: dict, device, matrix_dtype=torch.bfloat16) -> dict:
    """Stacked numpy weights -> contiguous tensors on ``device``: matrices in
    ``matrix_dtype`` (bf16 for the kernels), biases in f32."""
    return {
        k: torch.tensor(v, dtype=matrix_dtype if k in MATRICES else torch.float32,
                        device=device).contiguous()
        for k, v in ws.items()
    }


_FRAG_K = np.array([0, 1, 8, 9])


def mma_b_fragments(w: np.ndarray, cols: np.ndarray) -> np.ndarray:
    """The B fragments of ``mma.sync.m16n8k16`` for w [K, N], K zero-padded
    to a multiple of 16; ``cols`` [n, 8] names the columns of n n8 tiles.
    Returns [n, K/16, 32, 4]: for k16 tile k and lane l = 4g + i,
    (w[16k+2i, c], w[16k+2i+1, c], w[16k+2i+8, c], w[16k+2i+9, c]) with
    c = cols[., g] -- the lane's two 32-bit registers b0, b1."""
    k_pad = -(-w.shape[0] // 16) * 16
    wp = np.zeros((k_pad, w.shape[1]), w.dtype)
    wp[: w.shape[0]] = w
    lane = np.arange(32)
    rows = (16 * np.arange(k_pad // 16)[:, None, None]
            + 2 * (lane % 4)[None, :, None] + _FRAG_K[None, None, :])
    return wp[rows[None], cols[:, lane // 4][:, None, :, None]]


def _dense_fragments(w: np.ndarray) -> np.ndarray:
    """[N/8, K/16, 32, 4] fragments of a product, N zero-padded to 8."""
    n8 = -(-w.shape[1] // 8) * 8
    wp = np.zeros((w.shape[0], n8), w.dtype)
    wp[:, : w.shape[1]] = w
    return mma_b_fragments(wp, np.arange(n8).reshape(-1, 8))


def _gate_fragments(segments, hidden: int) -> np.ndarray:
    """[H/8, tiles, 2, 32, 8]: per group u of 8 hidden units, the k16 tiles
    of each input segment ([K_s, 4H]) in turn, gate g's n8 tile covering
    columns g*H + 8u .. 8u+7; a tile holds gates (i, f) of the 32 lanes,
    then gates (c, o), so that a warp copies each half as 512 contiguous
    bytes."""
    groups = []
    for u in range(hidden // 8):
        cols = hidden * np.arange(4)[:, None] + 8 * u + np.arange(8)[None, :]
        tiles = np.concatenate([mma_b_fragments(s, cols) for s in segments],
                               axis=1)                       # [4, tiles, 32, 4]
        groups.append(tiles.reshape(2, 2, -1, 32, 4).transpose(2, 0, 3, 1, 4)
                      .reshape(-1, 2, 32, 8))
    return np.stack(groups)


def ring_fills(tiles: np.ndarray) -> np.ndarray:
    """A split layer's gate tiles of one direction ([H/8 groups, tiles, 2,
    32, 8], ``_gate_fragments``) in the order of the ring's fills: [fills,
    8 warps, 2, 2, 32, 8], warp w's two tiles of fill f being tiles 2f and
    2f + 1 of its groups' tiles in turn (groups wQ .. wQ + Q - 1, Q = H /
    64)."""
    if tiles.shape[0] % 8:
        raise ValueError(f"{tiles.shape[0]} unit groups do not split over 8 warps")
    return tiles.reshape(8, -1, 2, 2, 32, 8).transpose(1, 0, 2, 3, 4, 5)


def pack_full_weights(ws: dict) -> dict:
    """The kernels' fragment-packed products (``FULL_SHAPES``, stacked
    over the models, f32) from the stacked row-major weights (numpy or
    tensors, f32 or bf16). A pure permutation with zero padding, so rounding
    to bf16 before or after packing gives the same bits. Each LSTM layer's
    gate product per direction: its input segments, then wh -- layer 1 (the
    features, 6 -> 16 padded) and layer 3 ([l2 | s64]) read the direction's
    slice of the side-by-side ``wi1`` / ``wi3s``; layers 2-4 in the
    order of the ring's fills (``ring_fills``)."""
    w = {k: (v.float().cpu().numpy() if torch.is_tensor(v)
             else np.asarray(v, np.float32))
         for k, v in ws.items() if k in _ROW_MAJOR}
    per_model = []
    for m in range(w["wh1"].shape[0]):
        g = {k: v[m] for k, v in w.items()}
        out = {k: _dense_fragments(g[src]) for k, src in (
            ("cw1_f", "cw1"), ("cw2_f", "cw2"), ("cc_f", "cc"), ("ce_f", "ce"),
            ("d1_f", "d1w"), ("d2_f", "d2w"), ("mo_f", "mow"))}
        segs = {
            "l1_f": (H1, lambda d: (g["wi1"][:, 4 * H1 * d : 4 * H1 * (d + 1)],
                                    g["wh1"][d])),
            "l2_r": (H2, lambda d: (g["wi2"][d], g["wh2"][d])),
            "l3_r": (H3, lambda d: (g["wi3"][d],
                                    g["wi3s"][:, 4 * H3 * d : 4 * H3 * (d + 1)],
                                    g["wh3"][d])),
            "l4_r": (H4, lambda d: (g["wi4"][d], g["wh4"][d])),
        }
        for k, (hidden, seg) in segs.items():
            order = (lambda x: x) if k == "l1_f" else ring_fills
            out[k] = np.stack([order(_gate_fragments(seg(d), hidden)) for d in (0, 1)])
        per_model.append(out)
    packed = stack_models(per_model)
    for k, shape in FULL_SHAPES.items():
        if packed[k].shape[1:] != shape:
            raise ValueError(f"packed {k} has shape {packed[k].shape}, want {shape}")
    return packed


def kernel_weights(ws: dict, device) -> dict:
    """The kernels' weights on ``device`` from the stacked numpy weights:
    the row-major set (bf16 matrices, f32 biases) plus the
    fragment-packed products that both kernels read. Made once per
    engine; a one-model slice ``{k: v[m]}`` equals packing model m
    alone."""
    out = weights_to_device(ws, device)
    out.update(weights_to_device(pack_full_weights(ws), device))
    return out


# ------------------------------------------------------------ plain versions


def _rnd(x: torch.Tensor, bf16: bool) -> torch.Tensor:
    """Round to bf16 (kept in f32) where the kernel stores bf16."""
    return x.to(torch.bfloat16).to(torch.float32) if bf16 else x


_ROW_MAJOR = frozenset(stack_shapes(1))


def _plain_weights(ws: dict, bf16: bool) -> dict:
    """f32 views of the row-major weights; matrices rounded to bf16 for the
    bf16 version (biases stay f32, as in the kernels)."""
    return {k: _rnd(v.to(torch.float32), bf16 and k in MATRICES)
            for k, v in ws.items() if k in _ROW_MAJOR}


def _hs(x):
    return torch.clamp(0.2 * x + 0.5, 0.0, 1.0)


def base_rows_plain(ws: dict, sig: torch.Tensor, feats: torch.Tensor,
                    n_rows: int, *, bf16: bool = True):
    """The per-base-row half of the stack: rows [0, n_rows) of sig
    [N, >=50] and feats [N, 6] -> (p1 [2, n_rows, 128], p3 [2, n_rows,
    1024]) in f32."""
    w = _plain_weights(ws, bf16)
    x = _rnd(sig[:n_rows, :Q].to(torch.float32), bf16)
    f = _rnd(feats[:n_rows].to(torch.float32), bf16)
    p1, p3 = [], []
    for m in range(w["cw1"].shape[0]):
        z1 = _rnd(torch.relu(x @ w["cw1"][m] + w["cb1"][m]), bf16)
        z2 = _rnd(torch.relu(z1 @ w["cw2"][m] + w["cb2"][m]), bf16)
        s64 = _rnd(z2 @ w["cc"][m] + x @ w["ce"][m] + w["cbias"][m], bf16)
        p1.append(f @ w["wi1"][m] + w["b1"][m])
        p3.append(s64 @ w["wi3s"][m])
    return torch.stack(p1), torch.stack(p3)


def _lstm_pass(step_in, wh, hidden, t_len, reverse, bf16):
    """One direction: z_t = step_in(t) + h @ wh; returns per-t h."""
    n = step_in(0).shape[0]
    h = step_in(0).new_zeros(n, hidden)
    c = step_in(0).new_zeros(n, hidden)
    outs = [None] * t_len
    for t in (range(t_len - 1, -1, -1) if reverse else range(t_len)):
        z = step_in(t) + h @ wh
        i = _hs(z[:, :hidden])
        fg = _hs(z[:, hidden : 2 * hidden])
        g = torch.tanh(z[:, 2 * hidden : 3 * hidden])
        o = _hs(z[:, 3 * hidden :])
        c = fg * c + i * g
        h = _rnd(o * torch.tanh(c), bf16)
        outs[t] = h
    return outs


def _stack_core_plain(w: dict, m: int, p1_at, p3_at, t_len: int,
                      bf16: bool) -> torch.Tensor:
    """Bi-LSTM stack + heads of model ``m`` for n windows. ``p1_at(t)``
    gives the layer-1 pre-activations [n, 128] of step t (bias included),
    ``p3_at(t)`` the layer-3 signal parts [n, 1024], both f32. Returns the
    logits [n, 6]."""
    def proj(inputs, wi, b):
        return lambda t: inputs[t] @ wi + b

    def pair(f, b):
        return [torch.cat([x, y], dim=1) for x, y in zip(f, b)]

    l1 = pair(*[_lstm_pass(lambda t, d=d: p1_at(t)[:, 64 * d : 64 * d + 64],
                           w["wh1"][m, d], H1, t_len, d == 1, bf16)
                for d in (0, 1)])
    l2 = pair(*[_lstm_pass(proj(l1, w["wi2"][m, d], w["b2"][m, d]),
                           w["wh2"][m, d], H2, t_len, d == 1, bf16)
                for d in (0, 1)])
    l3 = []
    for d in (0, 1):
        pm = proj(l2, w["wi3"][m, d], w["b3"][m, d])
        l3.append(_lstm_pass(
            lambda t, d=d, pm=pm: pm(t) + p3_at(t)[:, 512 * d : 512 * d + 512],
            w["wh3"][m, d], H3, t_len, d == 1, bf16))
    l3 = pair(*l3)
    l4 = pair(*[_lstm_pass(proj(l3, w["wi4"][m, d], w["b4"][m, d]),
                           w["wh4"][m, d], H4, t_len, d == 1, bf16)
                for d in (0, 1)])
    acc = l4[0].new_zeros(l4[0].shape[0], 16)
    for t in range(t_len):
        h = _rnd(torch.relu(l4[t] @ w["d1w"][m] + w["d1b"][m]), bf16)
        h = _rnd(torch.relu(h @ w["d2w"][m] + w["d2b"][m]), bf16)
        mo = _rnd(torch.relu(h @ w["mow"][m] + w["mob"][m]), bf16)
        acc = acc + mo @ w["fw"][m, t]
    feature = _rnd(torch.relu(acc + w["fb"][m]), bf16)
    return feature @ w["fow"][m] + w["fob"][m]


def stack_heads_plain(ws: dict, p1: torch.Tensor, p3: torch.Tensor, *,
                      t_len: int, w_valid: int, n_windows: int,
                      want_probs: bool, bf16: bool = True):
    """The per-window half of the stack. p1 [2, R, 128], p3 [2, R, 1024]
    with R >= w_valid + t_len - 1. Returns logits [2, n_windows, 6] and
    probs [2, n_windows] (or None); windows >= w_valid are zero."""
    w = _plain_weights(ws, bf16)
    n_models = w["wh1"].shape[0]
    logits = p1.new_zeros(n_models, n_windows, NB_MAX)
    probs = p1.new_zeros(n_models, n_windows) if want_probs else None
    if w_valid == 0:
        return logits, probs
    wv = w_valid
    for m in range(n_models):
        lg = _stack_core_plain(w, m, lambda t, m=m: p1[m, t : t + wv],
                               lambda t, m=m: p3[m, t : t + wv], t_len, bf16)
        logits[m, :wv] = lg
        if want_probs:
            probs[m, :wv] = max_prob(lg)
    return logits, probs


def stack_windows_plain(ws: dict, feats: torch.Tensor, sig_outs: torch.Tensor,
                        *, t_len: int, want_probs: bool, bf16: bool):
    """Plain version of ``stack_windows``: pre-gathered windows, feats
    [B, T, 6] shared by all models and sig_outs [M, B, T, 64] per model.
    The layer-1 and layer-3-signal projections run per (window, t), then the
    stack core of ``stack_heads_plain``. With ``bf16`` the inputs and
    matrices are rounded where the kernel rounds them (the CPU wrapper's
    path, and the kernel's yardstick on the card); without, it is the f32
    model. Returns (logits [M, B, 6], probs [M, B] or None)."""
    w = _plain_weights(ws, bf16)
    n_models, n_win = sig_outs.shape[0], sig_outs.shape[1]
    if w["wh1"].shape[0] != n_models:
        raise ValueError(f"{w['wh1'].shape[0]} models of weights for "
                         f"{n_models} models of sig_outs")
    f = _rnd(feats.to(torch.float32), bf16)
    logits = f.new_zeros(n_models, n_win, NB_MAX)
    probs = f.new_zeros(n_models, n_win) if want_probs else None
    if n_win == 0:
        return logits, probs
    for m in range(n_models):
        s = _rnd(sig_outs[m].to(torch.float32), bf16)
        p1 = f @ w["wi1"][m] + w["b1"][m]              # [B, T, 128]
        p3 = s @ w["wi3s"][m]                          # [B, T, 1024]
        lg = _stack_core_plain(w, m, lambda t, p1=p1: p1[:, t],
                               lambda t, p3=p3: p3[:, t], t_len, bf16)
        logits[m] = lg
        if want_probs:
            probs[m] = max_prob(lg)
    return logits, probs


def max_prob(logits: torch.Tensor) -> torch.Tensor:
    """Max softmax probability, as the kernels compute it: 1/sum(exp(l-max))."""
    mx = logits.max(dim=-1, keepdim=True).values
    return 1.0 / torch.exp(logits - mx).sum(dim=-1)


def stack_logits_plain(ws: dict, sig: torch.Tensor, feats: torch.Tensor, *,
                       t_len: int, w_valid: int, n_windows: int,
                       want_probs: bool, bf16: bool):
    """Both plain halves: per-base rows [N, 64|50] -> (logits, probs)."""
    n_p = w_valid + t_len - 1 if w_valid else 0
    p1, p3 = base_rows_plain(ws, sig, feats, n_p, bf16=bf16)
    return stack_heads_plain(ws, p1, p3, t_len=t_len, w_valid=w_valid,
                             n_windows=n_windows, want_probs=want_probs,
                             bf16=bf16)


# ------------------------------------------------------------ kernel entries

STACK_FULL = build.Kernel("stack_full", "reviser_stack",
                          "nanoreviser_tpu/ops/reviser_kernel.py:283")
STACK_WINDOWS = build.Kernel("stack_windows", "reviser_stack",
                             "nanoreviser_tpu/ops/reviser_kernel.py:251")


def _weight_ptrs(ws: dict, order, t_len: int, n_models: int = 2,
                 per_model: bool = False):
    """Device pointers of the weights in ``order``, checked for type, shape
    and contiguity: one per weight (the stacked array), or with
    ``per_model`` those of model 0, then those of model 1, ..."""
    shapes = {**stack_shapes(t_len), **FULL_SHAPES}
    for k in order:
        if k not in ws:
            raise ValueError(f"weight {k} missing (the kernels' packed weights "
                             f"come from kernel_weights)")
        v = ws[k]
        want = torch.bfloat16 if k in MATRICES else torch.float32
        if v.dtype != want or tuple(v.shape[1:]) != shapes[k] or not v.is_contiguous():
            raise ValueError(f"weight {k}: {v.dtype} {tuple(v.shape)}, want "
                             f"{want} [M, {shapes[k]}] contiguous")
        if v.shape[0] != n_models:
            raise ValueError(f"weight {k}: {v.shape[0]} models, want {n_models}")
    if per_model:
        return [ws[k][m].data_ptr() for m in range(n_models) for k in order]
    return [ws[k].data_ptr() for k in order]


def stack_logits_full(ws: dict, sig: torch.Tensor, feats: torch.Tensor, *,
                      t_len: int, w_valid: int, want_probs: bool,
                      n_windows: int | None = None):
    """Logits [2, W, 6] f32 (+ max prob [2, W]) of both models for the
    windows of per-base rows ``sig`` (bf16 [N, 64], the gather output) and
    ``feats`` (f32 [N, 6]); W defaults to N - t_len. Only windows < w_valid
    are computed; the rest stay zero. CUDA tensors launch ``stack_full``
    once (``ws`` from ``kernel_weights``); CPU tensors take the bf16 plain
    version."""
    if n_windows is None:
        n_windows = sig.shape[0] - t_len
    if sig.device.type == "cpu":
        return stack_logits_plain(ws, sig, feats, t_len=t_len, w_valid=w_valid,
                                  n_windows=n_windows, want_probs=want_probs,
                                  bf16=True)
    build.require_cuda(sig, feats)
    if sig.dtype != torch.bfloat16 or sig.dim() != 2 or sig.shape[1] != QP:
        raise ValueError(f"sig must be bf16 [N, {QP}], got {sig.dtype} "
                         f"{tuple(sig.shape)}")
    if feats.dtype != torch.float32 or feats.dim() != 2 or feats.shape[1] != 6:
        raise ValueError(f"feats must be f32 [N, 6], got {feats.dtype} "
                         f"{tuple(feats.shape)}")
    if not (sig.is_contiguous() and feats.is_contiguous()):
        raise ValueError("sig and feats must be contiguous")
    if w_valid > n_windows:
        raise ValueError(f"w_valid={w_valid} exceeds n_windows={n_windows}")
    n_p = w_valid + t_len - 1 if w_valid else 0
    if n_p > min(sig.shape[0], feats.shape[0]):
        raise ValueError(f"{w_valid} windows need {n_p} rows, got "
                         f"{sig.shape[0]} / {feats.shape[0]}")
    dev = sig.device
    logits = torch.zeros((2, n_windows, NB_MAX), dtype=torch.float32, device=dev)
    probs = (torch.zeros((2, n_windows), dtype=torch.float32, device=dev)
             if want_probs else None)
    if w_valid == 0:
        return logits, probs
    ptrs = _weight_ptrs(ws, FULL_ORDER, t_len, per_model=True)
    STACK_FULL.launch(
        "nr_stack_full",
        build.ptr_array(ptrs), build.c_ptr(sig), build.c_ptr(feats),
        build.c_int(n_p), build.c_int(t_len), build.c_int(w_valid),
        build.c_int(n_windows), build.c_ptr(logits),
        build.c_ptr(probs) if probs is not None else build.c_void_p(0),
        build.stream_of(dev))
    return logits, probs


def stack_full_fetch_bytes(t_len: int, cluster: int = 1) -> dict:
    """Weight bytes of one ``stack_full`` block and model by the kernel's
    schedule with clusters of ``cluster`` CTAs: the conv products and
    biases once, then the stack core's (``stack_windows_fetch_bytes``)."""
    nbytes = lambda k: 2 * math.prod(FULL_SHAPES[k])
    conv = (sum(nbytes(k) for k in ("cw1_f", "cw2_f", "cc_f", "ce_f"))
            + 4 * (400 + 400 + 64))
    core = stack_windows_fetch_bytes(t_len, cluster)
    return {"l2": core["l2"] + conv, "sm": core["sm"] + conv, "peer": core["peer"]}


def stack_windows_fetch_bytes(t_len: int, cluster: int = 1) -> dict:
    """Bytes the stack core of one block and model moves by the kernels'
    schedule with clusters of ``cluster`` CTAs (the N-split; 1: none):
    ``l2``, the bytes the L2 serves it; ``sm``, the bytes its SM receives
    from L2 (equal: nothing is multicast); ``peer``, the bytes it takes from
    its peers' shared memory. Every step streams its layer's packed gate
    products and reads their biases: layer 1 whole, layers 2-4 split, each
    block streaming 1/cluster of their gate columns (and biases). The heads'
    products are read once per pair of m16 tiles, ceil(T/2) times; the
    feature and final weights once. Per step of layers 2-4 a block copies
    the x (and s) rows of its cluster - 1 peers' 16 windows, and the peers
    store the (cluster - 1)/cluster of its h that they compute."""
    if cluster < 1:
        raise ValueError(f"cluster must be >= 1, got {cluster}")
    nbytes = lambda k: 2 * math.prod(FULL_SHAPES[k])
    bias = lambda h: 4 * 2 * 4 * h
    split = sum(nbytes(k) for k in ("l2_r", "l3_r", "l4_r")) + bias(H2 + H3 + H4)
    if split % cluster:
        raise ValueError(f"layers 2-4 do not split over {cluster} CTAs")
    lstm = nbytes("l1_f") + bias(H1) + split // cluster
    heads = ((nbytes("d1_f") + nbytes("d2_f") + nbytes("mo_f")) * ((t_len + 1) // 2)
             + 4 * (128 + 32 + NB_MAX) + 2 * t_len * NB_MAX * 16 + 4 * 16
             + 2 * 16 * NB_MAX + 4 * NB_MAX)
    weights = t_len * lstm + heads
    rows = 16 * (2 * H1 + (2 * H2 + 64) + 2 * H3)       # x|s of layers 2-4
    h_in = 16 * 2 * (H2 + H3 + H4) * (cluster - 1) // cluster
    peer = t_len * 2 * ((cluster - 1) * rows + h_in)
    return {"l2": weights, "sm": weights, "peer": peer}


def _stack_lib():
    return build.load(STACK_FULL.source)


def stack_cluster_size() -> int:
    """CTAs per cluster of both stack kernels, as their library fixes it
    (``nr_stack_cluster_size``); the wrappers never choose it. Loads, and
    if needed builds, the library."""
    return int(_stack_lib().nr_stack_cluster_size())


def stack_active_clusters(kernel: str, t_len: int) -> int:
    """``cudaOccupancyMaxActiveClusters`` of ``stack_full`` or
    ``stack_windows`` at T (needs a card): the clusters the card holds at
    once."""
    which = {"stack_full": 0, "stack_windows": 1}[kernel]
    n = int(_stack_lib().nr_stack_active_clusters(build.c_int(which),
                                                  build.c_int(t_len)))
    if n < 0:
        raise build.KernelLaunchError(f"{kernel}: no occupancy at T={t_len}")
    return n


# --------------------------------------------- the pre-gathered-window entry


def windows_ring_slots(t_len: int) -> int:
    """16 KB slots of the weight ring that ``stack_windows`` takes at T, as
    the kernel's library decides them (``nr_stack_windows_ring_slots``,
    beside the shared-memory layout it depends on); 0 where no ring fits.
    Loads, and if needed builds, the library."""
    return int(_stack_lib().nr_stack_windows_ring_slots(build.c_int(t_len)))


def stack_smem_bytes(kernel: str, t_len: int) -> int:
    """Dynamic shared memory of a ``stack_full`` or ``stack_windows`` launch
    at T, its weight ring included (``nr_stack_smem_bytes``; 0 where no ring
    fits)."""
    which = {"stack_full": 0, "stack_windows": 1}[kernel]
    return int(_stack_lib().nr_stack_smem_bytes(build.c_int(which), build.c_int(t_len)))


def stack_logits_multi(ws: dict, feats: torch.Tensor, sig_outs: torch.Tensor,
                       *, t_len: int, want_probs: bool = False):
    """Logits [M, B, 6] f32 of M = 1 or 2 models for pre-gathered windows:
    ``feats`` f32 [B, T, 6] (shared by the models) and ``sig_outs`` f32
    [M, B, T, 64] (each model's conv-branch output). With ``want_probs``
    returns (logits, max prob [M, B]). Counterpart of the TPU entry
    ``stack_logits_multi`` (``nanoreviser_tpu/ops/reviser_kernel.py:611``);
    any B. CUDA tensors launch ``stack_windows`` (one launch for all
    models; ``ws`` from ``kernel_weights``, T <= 13); CPU tensors take the
    bf16 plain version."""
    if feats.device.type == "cpu":
        logits, probs = stack_windows_plain(ws, feats, sig_outs, t_len=t_len,
                                            want_probs=want_probs, bf16=True)
        return (logits, probs) if want_probs else logits
    build.require_cuda(feats, sig_outs)
    if sig_outs.dim() != 4 or sig_outs.shape[0] not in (1, 2):
        raise ValueError(f"sig_outs must be [M, B, T, 64] with M 1 or 2, got "
                         f"{tuple(sig_outs.shape)}")
    n_models, n_win = sig_outs.shape[0], sig_outs.shape[1]
    for name, arr, shape in (("feats", feats, (n_win, t_len, 6)),
                             ("sig_outs", sig_outs, (n_models, n_win, t_len, 64))):
        if (arr.dtype != torch.float32 or tuple(arr.shape) != shape
                or not arr.is_contiguous()):
            raise ValueError(f"{name} must be contiguous f32 {list(shape)}, got "
                             f"{arr.dtype} {tuple(arr.shape)}")
    if sig_outs.data_ptr() % 16:
        raise ValueError("sig_outs must be 16-byte aligned")
    if not windows_ring_slots(t_len):
        raise ValueError(f"stack_windows does not fit T={t_len} in shared "
                         f"memory (no weight ring fits beside its rows)")
    dev = feats.device
    logits = torch.empty((n_models, n_win, NB_MAX), dtype=torch.float32, device=dev)
    probs = (torch.empty((n_models, n_win), dtype=torch.float32, device=dev)
             if want_probs else None)
    if n_win:
        ptrs = _weight_ptrs(ws, CORE_ORDER, t_len, n_models, per_model=True)
        STACK_WINDOWS.launch(
            "nr_stack_windows",
            build.ptr_array(ptrs), build.c_int(n_models), build.c_ptr(feats),
            build.c_ptr(sig_outs), build.c_int(n_win), build.c_int(t_len),
            build.c_ptr(logits),
            build.c_ptr(probs) if probs is not None else build.c_void_p(0),
            build.stream_of(dev))
    return (logits, probs) if want_probs else logits


def stack_logits_single(w: dict, feats: torch.Tensor, sig_out: torch.Tensor,
                        *, t_len: int, want_probs: bool = False):
    """Single-model wrapper (counterpart of the TPU entry
    ``stack_logits_pallas``, ``nanoreviser_tpu/ops/reviser_kernel.py:749``):
    ``w`` holds one model's weights without the model axis (for the card,
    ``{k: v[m]}`` of ``kernel_weights``); feats [B, T, 6], sig_out [B, T,
    64] -> logits [B, 6] (+ max prob [B])."""
    ws = {k: v[None] for k, v in w.items()}
    out = stack_logits_multi(ws, feats, sig_out[None], t_len=t_len,
                             want_probs=want_probs)
    if want_probs:
        return out[0][0], out[1][0]
    return out[0]


def stack_logits_reference(fused: dict, feats, sig_out) -> torch.Tensor:
    """f32 reference of the stack for kernel testing: ``fused`` is a folded
    parameter tree of tensors (``models.fused.fold_inference_params`` +
    ``params_from_numpy``); delegates to ``models.fused.lstm_stack_apply``."""
    from ..models.fused import lstm_stack_apply

    return lstm_stack_apply(fused, torch.as_tensor(feats), torch.as_tensor(sig_out))


def executed_mac_counts(t_len: int) -> dict:
    """Algorithmic MAC counts per model for the stack, from the architecture
    dims (copy of ``nanoreviser_tpu/ops/reviser_kernel.py:774``, the single
    source for the kernels' bounds).

    "per_base": the work that depends on one base row only (conv branch,
    layer-1 projection of the features, layer-3 projection of the conv
    output); "per_window": the work per window once those are hoisted per
    base row (what ``stack_heads_plain`` runs); "naive_per_window": the hoisted
    terms recomputed every (window, t); "per_window_pregathered": what the
    pre-gathered-window path runs per window (``stack_windows``), where only
    the projections of the features and conv outputs are per (window, t) --
    the conv branch itself runs outside the kernel.
    """
    q = 50                                   # window samples (conv length)
    conv = 1 * 8 * 3 * q + 8 * 8 * 3 * q + 8 * q * 64   # conv1, conv2, sig_dense
    l1_proj = 2 * 6 * (4 * H1)                          # feats -> L1 gates
    l3_sig = 2 * H4 * (4 * H3)                          # sig_dense -> L3 gates
    per_base = conv + l1_proj + l3_sig
    # once per (window, t): recurrent matmuls ...
    rec = 2 * (H1 * 4 * H1 + H2 * 4 * H2 + H3 * 4 * H3 + H4 * 4 * H4)
    # ... window-dependent input projections ...
    proj_t = 2 * (2 * H1 * 4 * H2      # L1 out (2 dirs) -> L2 gates
                  + 2 * H2 * 4 * H3    # L2 out -> L3 gates (read part)
                  + 2 * H3 * 4 * H4)   # L3 out -> L4 gates
    # ... and the per-t heads (dense1/dense2/main_out/feature accumulation)
    heads_t = 2 * H4 * 128 + 128 * 32 + 32 * NB_MAX + NB_MAX * 16
    per_window_per_t = rec + proj_t + heads_t
    final = 16 * NB_MAX                       # final_out, once per window
    per_window = per_window_per_t * t_len + final
    return {
        "per_base": per_base,
        "per_window": per_window,
        "naive_per_window": (per_window_per_t + per_base) * t_len + final,
        "per_window_pregathered": per_window + (l1_proj + l3_sig) * t_len,
    }
