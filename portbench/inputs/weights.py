"""Random weights of the NanoReviser model pair from a seed, and their Keras
``.h5`` files.

The weights are drawn on the device, with a ``torch.Generator`` there, in
one call per model: one uniform draw is cut into every leaf and scaled
(Glorot-uniform kernels with fan-in and fan-out over the receptive field,
recurrent kernels uniform with the variance of an orthogonal matrix,
biases and BN statistics perturbed so that every bias and BN takes part and
the labels vary from window to window). The columns of the last two Dense
kernels sum to zero: the relu features under them have positive means,
which would otherwise add a fixed offset to each class and pick one class
for nearly every window. ``set_label_shares`` then shifts the last layer's
biases of the insert and delete classes so that each wins about the share
of windows the configuration gives it, as a trained model's do: without
it, how many bases the merge writes (0.75-1.8 times the input) was the
seed's choice, and the seed changed the work. They are served from the
``.h5`` file in float32, the type Keras saves.

``save_keras_weights`` is the benchmark's copy of
``nanoreviser_torch/models/export_keras.py``: Keras 2.2.4 ``save_weights``
groups and names, in the order of the reference graph.
"""

from __future__ import annotations

import numpy as np

from .hdf5w import File


def layout(cfg: dict, n_classes: int) -> list[tuple[tuple, tuple, str]]:
    """(path in the parameter tree, shape, kind) of every leaf."""
    f, k, q = cfg["conv_filters"], cfg["conv_kernel"], cfg["signal_len"]
    h1, h2, h3, h4 = cfg["lstm_units"]
    d1, d2 = cfg["dense_units"]
    t, feat, main = cfg["window"], cfg["feature_units"], cfg["main_out_units"]
    out = [(("conv1", "w"), (k, 1, f), "kernel"), (("conv1", "b"), (f,), "bias"),
           (("conv2", "w"), (k, f, f), "kernel"), (("conv2", "b"), (f,), "bias"),
           (("sig_dense", "w"), (q * f, cfg["signal_dense_units"]), "kernel"),
           (("sig_dense", "b"), (cfg["signal_dense_units"],), "bias")]
    for name, dim in (("bn_c1", f), ("bn_c2", f), ("bn_r1", 2 * h1),
                      ("bn_r2", 2 * h2), ("bn_t1", 2 * h3)):
        out += [((name, s), (dim,), "bn_" + s)
                for s in ("gamma", "beta", "mean", "var")]
    d_sig = cfg["signal_dense_units"]
    for name, d_in, h in (("read_rnn1", cfg["n_features"], h1),
                          ("read_rnn2", 2 * h1, h2),
                          ("total_rnn1", 2 * h2 + d_sig, h3),
                          ("total_rnn2", 2 * h3, h4)):
        for d in ("fwd", "bwd"):
            out += [((name, d, "wi"), (d_in, 4 * h), "kernel"),
                    ((name, d, "wh"), (h, 4 * h), "recurrent"),
                    ((name, d, "b"), (4 * h,), "lstm_bias")]
    for name, d_in, d_out in (("dense1", 2 * h4, d1), ("dense2", d1, d2),
                              ("main_out", d2, main), ("feature", t * main, feat),
                              ("final_out", feat, n_classes)):
        kind = "final" if name == "final_out" else "head"
        out += [((name, "w"), (d_in, d_out), kind + "_kernel"),
                ((name, "b"), (d_out,), kind + "_bias")]
    return out


def random_params(cfg: dict, n_classes: int, seed: int, device) -> dict:
    """A numpy parameter tree drawn on ``device`` from ``seed``."""
    import torch

    leaves = layout(cfg, n_classes)
    sizes = [int(np.prod(s)) for _, s, _ in leaves]
    gen = torch.Generator(device=device).manual_seed(int(seed))
    u = torch.rand(sum(sizes), generator=gen, device=device,
                   dtype=torch.float64)
    u = (2.0 * u - 1.0).cpu().numpy()            # uniform in [-1, 1)
    tree: dict = {}
    pos = 0
    for (path, shape, kind), size in zip(leaves, sizes):
        x = u[pos : pos + size].reshape(shape)
        pos += size
        if kind in ("kernel", "head_kernel", "final_kernel"):
            rf = int(np.prod(shape[:-2])) if len(shape) > 2 else 1
            v = x * np.sqrt(6.0 / (rf * (shape[-2] + shape[-1])))
            if kind != "kernel":
                v = v * 1.5                       # heads that separate windows
            if path[0] in ("feature", "final_out"):
                v = v - v.mean(axis=0)            # no class wins by the mean
        elif kind == "recurrent":
            v = x * np.sqrt(3.0 / shape[-1])      # the variance of an orthogonal
        elif kind == "lstm_bias":
            h = shape[0] // 4
            v = 0.3 * x
            v[h : 2 * h] += 1.0                   # Keras unit_forget_bias
        elif kind == "final_bias":
            v = 0.015 * x
        elif kind in ("bias", "head_bias", "bn_beta", "bn_mean"):
            v = 0.3 * x
        elif kind == "bn_gamma":
            v = 1.0 + 0.2 * x
        elif kind == "bn_var":
            v = 1.0 + 0.5 * x
        else:
            raise ValueError(kind)
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = v.astype(np.float32)
    return tree


def set_label_shares(params: dict, logits: np.ndarray, shares: dict,
                     rounds: int = 8) -> None:
    """Shift ``final_out``'s bias of each class c in ``shares`` so that c is
    the largest of ``logits`` (computed with the present biases, one row a
    window) in about ``shares[c]`` of the windows."""
    logits = np.asarray(logits, np.float64)
    delta = np.zeros(logits.shape[1])
    for _ in range(rounds):
        for c, want in shares.items():
            rest = np.delete(logits + delta, c, axis=1).max(1)
            delta[c] = -np.quantile(logits[:, c] - rest, 1.0 - want)
    b = params["final_out"]["b"]
    params["final_out"]["b"] = (b + delta).astype(np.float32)


def _bn_arrays(name: str, bn: dict) -> dict:
    return {f"{name}/gamma:0": bn["gamma"], f"{name}/beta:0": bn["beta"],
            f"{name}/moving_mean:0": bn["mean"],
            f"{name}/moving_variance:0": bn["var"]}


def _dense_arrays(name: str, d: dict) -> dict:
    return {f"{name}/kernel:0": d["w"], f"{name}/bias:0": d["b"]}


def _lstm_arrays(name: str, lp: dict) -> dict:
    out = {}
    for tag, d in (("forward", lp["fwd"]), ("backward", lp["bwd"])):
        out[f"{tag}_{name}/kernel:0"] = d["wi"]
        out[f"{tag}_{name}/recurrent_kernel:0"] = d["wh"]
        out[f"{tag}_{name}/bias:0"] = d["b"]
    return out


def save_keras_weights(params: dict, path: str) -> None:
    """Keras 2 ``save_weights`` layout: one group per layer, named as the
    reference graph names them, in its order."""
    layers = [
        ("time_distributed_1", _dense_arrays("conv", params["conv1"])),
        ("time_distributed_2", _bn_arrays("bn", params["bn_c1"])),
        ("time_distributed_3", _dense_arrays("conv", params["conv2"])),
        ("bidirectional_1", _lstm_arrays("read_rnn1", params["read_rnn1"])),
        ("time_distributed_4", _bn_arrays("bn", params["bn_c2"])),
        ("batch_normalization_3", _bn_arrays("batch_normalization_3", params["bn_r1"])),
        ("bidirectional_2", _lstm_arrays("read_rnn11", params["read_rnn2"])),
        ("batch_normalization_4", _bn_arrays("batch_normalization_4", params["bn_r2"])),
        ("time_distributed_6", _dense_arrays("signal_x_out", params["sig_dense"])),
        ("bidirectional_3", _lstm_arrays("total_rnn1", params["total_rnn1"])),
        ("batch_normalization_5", _bn_arrays("batch_normalization_5", params["bn_t1"])),
        ("bidirectional_4", _lstm_arrays("total_rnn2", params["total_rnn2"])),
        ("dense_1", _dense_arrays("dense_1", params["dense1"])),
        ("dense_2", _dense_arrays("dense_2", params["dense2"])),
        ("main_out", _dense_arrays("main_out", params["main_out"])),
        ("feature", _dense_arrays("feature", params["feature"])),
        ("final_out", _dense_arrays("final_out", params["final_out"])),
    ]
    with File(path) as f:
        f.attrs["layer_names"] = np.array([name.encode() for name, _ in layers])
        f.attrs["backend"] = b"tensorflow"
        for name, arrays in layers:
            grp = f.create_group(name)
            for wname, arr in arrays.items():
                grp.create_dataset(wname, np.asarray(arr, np.float32))
            grp.attrs["weight_names"] = np.array([w.encode() for w in arrays])
