"""Functional building blocks of the reviser models, eager torch.

Counterpart of ``nanoreviser_tpu/models/layers.py``. The numerics follow
Keras 2.2.4 (the stack that produced the shipped weights, reference
lstmmodel.py / nanorevcnn.py), which is why ``torch.nn.LSTM`` and
``torch.nn.BatchNorm1d`` are not used:

* LSTM: gate order [i, f, c, o]; the recurrent activation is Keras'
  hard_sigmoid ``clip(0.2x + 0.5, 0, 1)``; cell activation tanh.
* Bidirectional: the backward pass consumes the flipped sequence and its
  output is flipped back, so both directions align per time step; concat.
* BatchNormalization: eps=1e-3, last axis; moving statistics at inference,
  the batch's biased moments in training.
* Conv1D: 'same' padding, stride 1, ReLU applied before the following BN.

Parameters are nested dicts of tensors with the JAX package's names and
layouts (``wi`` [D, 4H], ``wh`` [H, 4H], ``b`` [4H]; conv ``w`` [k, Cin, Cout]).
"""

from __future__ import annotations

import torch

BN_EPS = 1e-3


def hard_sigmoid(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(0.2 * x + 0.5, 0.0, 1.0)


def lstm(params: dict, x: torch.Tensor, reverse: bool = False) -> torch.Tensor:
    """Single-direction LSTM over [B, T, D] -> [B, T, H]."""
    wi, wh, b = params["wi"], params["wh"], params["b"]
    hidden = wh.shape[0]
    if reverse:
        x = torch.flip(x, dims=(1,))
    x_proj = x @ wi + b                                  # [B, T, 4H]
    h = x.new_zeros(x.shape[0], hidden)
    c = x.new_zeros(x.shape[0], hidden)
    outs = []
    for t in range(x.shape[1]):
        z = x_proj[:, t] + h @ wh
        i = hard_sigmoid(z[:, :hidden])
        f = hard_sigmoid(z[:, hidden : 2 * hidden])
        g = torch.tanh(z[:, 2 * hidden : 3 * hidden])
        o = hard_sigmoid(z[:, 3 * hidden :])
        c = f * c + i * g
        h = o * torch.tanh(c)
        outs.append(h)
    out = torch.stack(outs, dim=1)
    if reverse:
        out = torch.flip(out, dims=(1,))
    return out


def bilstm(params: dict, x: torch.Tensor) -> torch.Tensor:
    """Bidirectional LSTM with concat merge: [B, T, D] -> [B, T, 2H]."""
    fwd = lstm(params["fwd"], x, reverse=False)
    bwd = lstm(params["bwd"], x, reverse=True)
    return torch.cat([fwd, bwd], dim=-1)


def batch_norm(params: dict, x: torch.Tensor, eps: float = BN_EPS) -> torch.Tensor:
    """Inference-mode BN over the last axis with Keras eps=1e-3."""
    inv = torch.rsqrt(params["var"] + eps)
    return (x - params["mean"]) * inv * params["gamma"] + params["beta"]


def batch_norm_train(params: dict, x: torch.Tensor, eps: float = BN_EPS,
                     mesh=None) -> tuple[torch.Tensor, dict]:
    """Training-mode BN: normalize by the batch moments over every axis but
    the last; returns (y, {"mean", "var"}) for the moving-statistics update.
    The variance is the biased one (``jnp.var``), not torch's default.

    With a distributed ``mesh`` (``parallel.Mesh``) ``x`` is this process's
    slice of the global batch, every slice of the same size, and the
    moments are the global batch's, as the JAX package takes them under
    ``jit`` over dp-sharded arrays. They take two passes, as
    ``var(correction=0)`` does (the global sum gives the mean, then the
    global sum of squared deviations the variance: one pass of sums of
    squares cancels in f32), each a differentiable all-reduce
    (``parallel.all_reduce_sum``), so the backward is global too and every
    process calls it."""
    axes = tuple(range(x.dim() - 1))
    if mesh is None or not mesh.distributed:
        mean = x.mean(dim=axes)
        var = x.var(dim=axes, correction=0)
    else:
        from ..parallel import all_reduce_sum

        n = (x.numel() // x.shape[-1]) * mesh.world
        mean = all_reduce_sum(x.sum(dim=axes), mesh) / n
        d = x - mean
        var = all_reduce_sum((d * d).sum(dim=axes), mesh) / n
    y = (x - mean) * torch.rsqrt(var + eps) * params["gamma"] + params["beta"]
    return y, {"mean": mean, "var": var}


def conv1d_relu(params: dict, x: torch.Tensor) -> torch.Tensor:
    """Conv1D(k, 'same', relu) over [N, L, Cin] -> [N, L, Cout]."""
    w = params["w"]
    k = w.shape[0]
    pad = (k - 1) // 2
    xp = torch.nn.functional.pad(x, (0, 0, pad, pad))
    length = x.shape[1]
    cols = torch.stack([xp[:, i : i + length, :] for i in range(k)], dim=2)
    out = torch.einsum("blki,kio->blo", cols, w)
    return torch.relu(out + params["b"])


def dense(params: dict, x: torch.Tensor, activation=None) -> torch.Tensor:
    out = x @ params["w"] + params["b"]
    if activation is not None:
        out = activation(out)
    return out
