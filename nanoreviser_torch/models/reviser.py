"""The reviser network, eager torch (inference and training forward).

Counterpart of ``nanoreviser_tpu/models/reviser.py`` (reference
lstmmodel.py:32-133). model1 and model2 differ only in their class count
(6 vs 5):

    signal [B,T,50,1] -> identity block (2x Conv1D(8,k=3,'same',relu)+BN,
                          residual add broadcasting the 1-channel input onto
                          the 8-channel conv output, reference nanorevcnn.py:37)
                      -> (dropout 0.2, train only)
                      -> flatten per step [B,T,400] -> Dense(64) [B,T,64]
    read   [B,T,6]    -> BiLSTM(16) -> BN -> BiLSTM(64) -> BN   [B,T,128]
    concat            -> BiLSTM(128) -> BN -> BiLSTM(64)        [B,T,128]
                      -> Dense(128,relu) -> Dense(32,relu)
                      -> Dense(6,relu) 'main_out'               [B,T,6]
                      -> flatten [B,T*6] -> Dense(16,relu) 'feature'
                      -> Dense(nb_classes, softmax) 'final_out'

Parameter trees are nested dicts with the JAX package's names. The Keras
importer and ``init_reviser_params`` give numpy trees; ``params_from_numpy``
carries such a tree (from either package) to torch tensors.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .layers import batch_norm, batch_norm_train, bilstm, conv1d_relu, dense


@dataclass(frozen=True)
class ReviserConfig:
    window: int = 13          # T, sliding-window length in bases
    signal_len: int = 50      # raw samples per base window
    n_features: int = 6       # per-base scalar features
    n_classes: int = 6        # 6 for model1, 5 for model2
    conv_filters: int = 8
    conv_kernel: int = 3
    dropout_rate: float = 0.2  # after the residual add, training only


def params_from_numpy(params: dict, device="cpu", dtype=torch.float32) -> dict:
    """Numpy (or array-like) parameter tree -> the same tree of tensors."""
    if isinstance(params, dict):
        return {k: params_from_numpy(v, device, dtype) for k, v in params.items()}
    return torch.tensor(np.asarray(params), dtype=dtype, device=device)


def _bn(params: dict, name: str, h: torch.Tensor, stats: dict | None,
        mesh=None) -> torch.Tensor:
    """BN ``name`` on its moving statistics, or, given ``stats`` (training),
    on the batch moments (the global batch's over a distributed ``mesh``),
    which it records in ``stats[name]``."""
    if stats is None:
        return batch_norm(params[name], h)
    y, stats[name] = batch_norm_train(params[name], h, mesh=mesh)
    return y


def _dropout_mask(shape, keep: float, generator: torch.Generator, device,
                  mesh) -> torch.Tensor:
    """The keep mask of this process's rows. Over a distributed ``mesh`` it
    is drawn at the global batch's shape and this process's contiguous
    block of rows is kept, so N processes on the same generator state use
    exactly the masks of one process on the global batch."""
    if mesh is None or not mesh.distributed:
        return torch.rand(shape, generator=generator, device=device) < keep
    rows = shape[0]
    u = torch.rand((rows * mesh.world, *shape[1:]), generator=generator,
                   device=device)
    return u[mesh.rank * rows : (mesh.rank + 1) * rows] < keep


def signal_branch(params: dict, signal: torch.Tensor, cfg: ReviserConfig,
                  stats: dict | None = None,
                  generator: torch.Generator | None = None,
                  mesh=None) -> torch.Tensor:
    """[B,T,S] or [B,T,S,1] -> [B,T,64] through the conv residual branch.

    With ``stats`` (a dict) it runs in training mode: its BNs normalize by
    the batch moments, which go into ``stats``, and dropout follows the
    residual add (mask drawn from ``generator``). ``mesh``: see
    ``reviser_apply``."""
    if signal.dim() == 3:
        signal = signal[..., None]
    b, t, s, c = signal.shape
    x = signal.reshape(b * t, s, c)
    h = _bn(params, "bn_c1", conv1d_relu(params["conv1"], x), stats, mesh)
    h = _bn(params, "bn_c2", conv1d_relu(params["conv2"], h), stats, mesh)
    h = h + x  # residual: broadcasts the 1-channel input onto the filters
    if stats is not None and cfg.dropout_rate > 0:
        if generator is None:
            raise ValueError("training with dropout needs a torch.Generator")
        keep = 1.0 - cfg.dropout_rate
        mask = _dropout_mask(h.shape, keep, generator, h.device, mesh)
        h = torch.where(mask, h / keep, 0.0)
    h = h.reshape(b, t, s * cfg.conv_filters)
    return dense(params["sig_dense"], h)


def reviser_apply(params: dict, signal: torch.Tensor, feats: torch.Tensor,
                  cfg: ReviserConfig | None = None, *, train: bool = False,
                  generator: torch.Generator | None = None, mesh=None):
    """Forward pass. signal: [B, T, S(, 1)]; feats: [B, T, 6].

    Returns (probs [B, n_classes], feature [B, 16]); with ``train=True``
    also the BN batch statistics, {name: {"mean", "var"}} for bn_c1,
    bn_c2, bn_r1, bn_r2 and bn_t1, and dropout draws its mask from
    ``generator``, a ``torch.Generator`` on the tensors' device.

    ``mesh`` (training over a distributed ``parallel.Mesh``): the inputs are
    this process's slice of the global batch, the BN moments are the global
    batch's and the dropout mask is this slice's rows of the global one."""
    if cfg is None:
        cfg = ReviserConfig(window=feats.shape[1],
                            n_classes=params["final_out"]["b"].shape[0])
    stats = {} if train else None
    sig_out = signal_branch(params, signal, cfg, stats, generator, mesh)
    r = _bn(params, "bn_r1", bilstm(params["read_rnn1"], feats), stats, mesh)
    r = _bn(params, "bn_r2", bilstm(params["read_rnn2"], r), stats, mesh)
    h = torch.cat([r, sig_out], dim=-1)
    h = _bn(params, "bn_t1", bilstm(params["total_rnn1"], h), stats, mesh)
    h = bilstm(params["total_rnn2"], h)
    h = dense(params["dense1"], h, torch.relu)
    h = dense(params["dense2"], h, torch.relu)
    main = dense(params["main_out"], h, torch.relu)           # [B,T,6]
    feature = dense(params["feature"], main.reshape(main.shape[0], -1),
                    torch.relu)                               # [B,16]
    probs = torch.softmax(dense(params["final_out"], feature).to(torch.float32),
                          dim=-1)
    if train:
        return probs, feature, stats
    return probs, feature


class Reviser(torch.nn.Module):
    """One reviser model holding its parameters as buffers (inference)."""

    def __init__(self, params: dict, cfg: ReviserConfig | None = None):
        super().__init__()
        self.cfg = cfg
        self._names = []
        for path, arr in _flatten(params):
            name = "__".join(path)
            self.register_buffer(name, torch.tensor(np.asarray(arr),
                                                    dtype=torch.float32))
            self._names.append(path)

    def params(self) -> dict:
        tree: dict = {}
        for path in self._names:
            node = tree
            for key in path[:-1]:
                node = node.setdefault(key, {})
            node[path[-1]] = getattr(self, "__".join(path))
        return tree

    def forward(self, signal: torch.Tensor, feats: torch.Tensor):
        return reviser_apply(self.params(), signal, feats, self.cfg)


def _flatten(tree: dict, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


# --------------------------------------------------------------- random init


def _glorot(gen: torch.Generator, shape) -> np.ndarray:
    fan_in, fan_out = shape[-2], shape[-1]
    limit = np.sqrt(6.0 / (fan_in + fan_out))
    u = torch.rand(shape, generator=gen, dtype=torch.float64)
    return ((2.0 * u - 1.0) * limit).numpy().astype(np.float32)


def _orthogonal(gen: torch.Generator, shape) -> np.ndarray:
    """Orthogonal init of a [rows, cols] matrix (Keras / JAX semantics:
    QR of a normal draw, columns sign-fixed by diag(R))."""
    rows, cols = shape
    a = torch.randn((max(rows, cols), min(rows, cols)), generator=gen,
                    dtype=torch.float64)
    q, r = torch.linalg.qr(a)
    q = q * torch.sign(torch.diagonal(r))[None, :]
    if rows < cols:
        q = q.T
    return q.numpy().astype(np.float32)


def _lstm_params(gen, d_in, hidden):
    # Keras LSTM init: glorot kernel, orthogonal recurrent, zero bias with
    # unit_forget_bias (forget-gate bias = 1)
    bias = np.zeros(4 * hidden, dtype=np.float32)
    bias[hidden : 2 * hidden] = 1.0
    return {"wi": _glorot(gen, (d_in, 4 * hidden)),
            "wh": _orthogonal(gen, (hidden, 4 * hidden)),
            "b": bias}


def _bilstm_params(gen, d_in, hidden):
    return {"fwd": _lstm_params(gen, d_in, hidden),
            "bwd": _lstm_params(gen, d_in, hidden)}


def _bn_params(dim):
    return {"gamma": np.ones(dim, np.float32), "beta": np.zeros(dim, np.float32),
            "mean": np.zeros(dim, np.float32), "var": np.ones(dim, np.float32)}


def _dense_params(gen, d_in, d_out):
    return {"w": _glorot(gen, (d_in, d_out)), "b": np.zeros(d_out, np.float32)}


def init_reviser_params(gen: torch.Generator, cfg: ReviserConfig) -> dict:
    """Random numpy parameter tree with Keras default initializers (glorot
    kernels, orthogonal recurrent kernels, zero biases except forget gates
    at 1, identity BN) plus the center-loss ``centers`` [n_classes, 16],
    which the serving path ignores. Counterpart of the JAX
    ``init_reviser_params``; the draws come from ``gen`` and differ from
    JAX's."""
    f = cfg.conv_filters
    return {
        "conv1": {"w": _glorot(gen, (cfg.conv_kernel, 1, f)),
                  "b": np.zeros(f, np.float32)},
        "bn_c1": _bn_params(f),
        "conv2": {"w": _glorot(gen, (cfg.conv_kernel, f, f)),
                  "b": np.zeros(f, np.float32)},
        "bn_c2": _bn_params(f),
        "sig_dense": _dense_params(gen, cfg.signal_len * f, 64),
        "read_rnn1": _bilstm_params(gen, cfg.n_features, 16),
        "bn_r1": _bn_params(32),
        "read_rnn2": _bilstm_params(gen, 32, 64),
        "bn_r2": _bn_params(128),
        "total_rnn1": _bilstm_params(gen, 192, 128),
        "bn_t1": _bn_params(256),
        "total_rnn2": _bilstm_params(gen, 256, 64),
        "dense1": _dense_params(gen, 128, 128),
        "dense2": _dense_params(gen, 128, 32),
        "main_out": _dense_params(gen, 32, 6),
        "feature": _dense_params(gen, cfg.window * 6, 16),
        "final_out": _dense_params(gen, 16, cfg.n_classes),
        # center-loss class centers (Keras Embedding init: uniform +-0.05),
        # drawn last and from a copy of gen, so that gen, every weight above
        # and every draw made from gen after this call stay as they were
        # before the train path needed centers
        "centers": (0.05 * (2.0 * torch.rand(
            (cfg.n_classes, 16), generator=_copy(gen), dtype=torch.float64)
            - 1.0)).numpy().astype(np.float32),
    }


def _copy(gen: torch.Generator) -> torch.Generator:
    g = torch.Generator(device=gen.device)
    g.set_state(gen.get_state())
    return g


def randomize_inference_stats(params: dict, gen: torch.Generator) -> dict:
    """Copy of ``params`` with random biases and BN statistics and scaled-up
    head weights.

    Freshly initialized weights have zero biases and identity BNs, and their
    heads barely separate windows: most windows tie or land on one class.
    Tests and the chip smoke perturb them (biases and BN shifts uniform in
    [-0.3, 0.3], BN scales in [0.8, 1.2], variances in [0.5, 1.5], head
    kernels times 1.5) so that BN folding and every bias are exercised and
    the labels vary from window to window. The gain keeps logits small
    enough that the bf16 stack stays within the f32 bar (atol 0.15): at 2.0
    model 2's logits differed by up to 0.25 on the CPU."""
    scale, head_gain = 0.3, 1.5
    def u(shape):
        return torch.rand(shape, generator=gen, dtype=torch.float64).numpy()

    def jitter(b):
        return (b + scale * (2 * u(b.shape) - 1)).astype(np.float32)

    out: dict = {}
    for key, node in params.items():
        if key.startswith("bn_"):
            dim = node["gamma"].shape[0]
            out[key] = {
                "gamma": (0.8 + 0.4 * u(dim)).astype(np.float32),
                "beta": (scale * (2 * u(dim) - 1)).astype(np.float32),
                "mean": (scale * (2 * u(dim) - 1)).astype(np.float32),
                "var": (0.5 + u(dim)).astype(np.float32),
            }
        elif isinstance(node, dict) and "fwd" in node:
            out[key] = {d: dict(node[d], b=jitter(node[d]["b"]))
                        for d in ("fwd", "bwd")}
        elif key in ("dense1", "dense2", "main_out", "feature"):
            out[key] = {"w": (node["w"] * head_gain).astype(np.float32),
                        "b": jitter(node["b"])}
        elif key == "final_out":
            out[key] = {"w": (node["w"] * head_gain).astype(np.float32),
                        "b": (node["b"] + 0.05 * scale * (2 * u(node["b"].shape) - 1)
                              ).astype(np.float32)}
        elif isinstance(node, dict) and "b" in node:
            out[key] = dict(node, b=jitter(node["b"]))
        else:
            out[key] = node
    return out
