"""Inference-time model fusion: fold BatchNorms into LSTM input projections.

Counterpart of ``nanoreviser_tpu/models/fused.py``. At inference every
BatchNorm is an affine map y = x*s + t with s = gamma/sqrt(var+eps),
t = beta - mean*s. The three BNs between recurrent layers each feed a
linear input projection, so they fold exactly into the next layer's (wi, b):

    bn_r1 -> read_rnn2.wi            (all 32 input rows)
    bn_r2 -> total_rnn1.wi[:128]     (the read half of the concat input)
    bn_t1 -> total_rnn2.wi           (all 256 input rows)

Folding runs once at load time in numpy f64. ``signal_branch_apply``,
``lstm_stack_apply`` and ``fused_forward`` are the eager torch f32 forwards
on folded params (the conv branch keeps its BNs).
"""

from __future__ import annotations

import numpy as np
import torch

from .layers import BN_EPS, bilstm, dense
from .reviser import ReviserConfig, signal_branch


def bn_affine(bn: dict) -> tuple[np.ndarray, np.ndarray]:
    var = np.asarray(bn["var"], np.float64)
    s = np.asarray(bn["gamma"], np.float64) / np.sqrt(var + BN_EPS)
    t = np.asarray(bn["beta"], np.float64) - np.asarray(bn["mean"], np.float64) * s
    return s, t


def _fold_into(lstm_params: dict, s: np.ndarray, t: np.ndarray, rows: slice) -> dict:
    """Fold y = x*s + t (applied to input rows ``rows``) into (wi, b)."""
    out = {}
    for dirn in ("fwd", "bwd"):
        wi = np.asarray(lstm_params[dirn]["wi"], np.float64)
        b = np.asarray(lstm_params[dirn]["b"], np.float64)
        wi_rows = wi[rows]
        new_wi = wi.copy()
        new_wi[rows] = s[:, None] * wi_rows
        new_b = b + t @ wi_rows
        out[dirn] = {
            "wi": new_wi.astype(np.float32),
            "wh": np.asarray(lstm_params[dirn]["wh"], np.float32),
            "b": new_b.astype(np.float32),
        }
    return out


def fold_inference_params(params: dict) -> dict:
    """Numpy parameter tree with bn_r1/bn_r2/bn_t1 folded away."""
    s1, t1 = bn_affine(params["bn_r1"])
    s2, t2 = bn_affine(params["bn_r2"])
    s3, t3 = bn_affine(params["bn_t1"])
    fused = dict(params)
    fused["read_rnn2"] = _fold_into(params["read_rnn2"], s1, t1, slice(None))
    fused["total_rnn1"] = _fold_into(params["total_rnn1"], s2, t2, slice(0, 128))
    fused["total_rnn2"] = _fold_into(params["total_rnn2"], s3, t3, slice(None))
    for k in ("bn_r1", "bn_r2", "bn_t1"):
        fused.pop(k)
    return fused


# [B,T,50(,1)] -> [B,T,64] via the conv residual branch (the JAX name)
signal_branch_apply = signal_branch


def lstm_stack_apply(fused: dict, feats: torch.Tensor,
                     sig_out: torch.Tensor) -> torch.Tensor:
    """The LSTM stack + heads on folded params.

    feats: [B,T,6]; sig_out: [B,T,64]. Returns logits [B, n_classes]."""
    r = bilstm(fused["read_rnn1"], feats)
    r = bilstm(fused["read_rnn2"], r)
    h = torch.cat([r, sig_out], dim=-1)
    h = bilstm(fused["total_rnn1"], h)
    h = bilstm(fused["total_rnn2"], h)
    h = dense(fused["dense1"], h, torch.relu)
    h = dense(fused["dense2"], h, torch.relu)
    main = dense(fused["main_out"], h, torch.relu)
    feature = dense(fused["feature"], main.reshape(main.shape[0], -1), torch.relu)
    return dense(fused["final_out"], feature)


def fused_forward(fused: dict, signal: torch.Tensor, feats: torch.Tensor,
                  cfg: ReviserConfig) -> torch.Tensor:
    """Full inference forward on folded params; returns probs [B, C]."""
    sig_out = signal_branch_apply(fused, signal, cfg)
    logits = lstm_stack_apply(fused, feats, sig_out).to(torch.float32)
    return torch.softmax(logits, dim=-1)
