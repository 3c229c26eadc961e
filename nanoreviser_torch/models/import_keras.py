"""Import reference Keras `.h5` weights into the reviser param tree.

Copy of ``nanoreviser_tpu/models/import_keras.py`` (numpy and the
package's own HDF5 reader, ``io.hdf5``).
The tree holds numpy arrays; ``models.reviser.params_from_numpy`` carries it
to torch tensors.

The reference ships predict-model weights saved by Keras 2.2.4
``save_weights`` (HDF5 with ``layer_names``/``weight_names`` attrs). Layer
numbering differs across files (e.g. ``bidirectional_1`` vs
``bidirectional_13``), so layers are classified by weight *shape/role*
rather than name:

* 3-D conv kernels: (k, 1, F) -> conv1, (k, F, F) -> conv2
* BN groups (4 same-shape 1-D arrays): dims F, F, 32, 128, 256 in encounter
  order -> bn_c1, bn_c2, bn_r1, bn_r2, bn_t1
* Bidirectional LSTMs by input dim: 6 -> read_rnn1, 32 -> read_rnn2,
  192 -> total_rnn1, 256 -> total_rnn2
* Dense by shape: (S*F,64) signal dense, (128,128), (128,32), (32,6) main_out,
  (T*6,16) feature, (16,nb) final_out

The shipped files were trained with an effective window of 11 (``feature``
kernel is (66,16)), not the advertised 13 — ``infer_window_size`` recovers T
from the weights (SURVEY.md §5 checklist item 5).
"""

from __future__ import annotations

import os

import numpy as np

from ..io import hdf5


def _layer_arrays(f: hdf5.File):
    """Yield (layer_name, {weight_name: np.ndarray}) in saved order."""
    for lname in f.attrs["layer_names"]:
        lname = lname.decode() if isinstance(lname, bytes) else str(lname)
        grp = f[lname]
        wnames = [
            n.decode() if isinstance(n, bytes) else str(n)
            for n in grp.attrs.get("weight_names", [])
        ]
        if not wnames:
            continue
        yield lname, {wn: np.asarray(grp[wn]) for wn in wnames}


def _classify_bn(arrs: dict) -> dict:
    out = {}
    for wn, arr in arrs.items():
        key = wn.rsplit("/", 1)[-1]
        if key.startswith("gamma"):
            out["gamma"] = arr
        elif key.startswith("beta"):
            out["beta"] = arr
        elif key.startswith("moving_mean"):
            out["mean"] = arr
        elif key.startswith("moving_variance"):
            out["var"] = arr
    return out


def _classify_bilstm(arrs: dict) -> dict:
    fwd, bwd = {}, {}
    for wn, arr in arrs.items():
        dst = bwd if "/backward" in wn or "backward_" in wn else fwd
        key = wn.rsplit("/", 1)[-1]
        if key.startswith("kernel"):
            dst["wi"] = arr
        elif key.startswith("recurrent_kernel"):
            dst["wh"] = arr
        elif key.startswith("bias"):
            dst["b"] = arr
    return {"fwd": fwd, "bwd": bwd}


def infer_window_size(h5_path: str | os.PathLike) -> int:
    """Recover the trained window length T from the feature kernel (T*6, 16)."""
    with hdf5.File(h5_path, "r") as f:
        for _, arrs in _layer_arrays(f):
            for wn, arr in arrs.items():
                if arr.ndim == 2 and arr.shape[1] == 16 and arr.shape[0] % 6 == 0:
                    if arr.shape[0] not in (16, 32, 128):
                        return arr.shape[0] // 6
    raise ValueError(f"Could not infer window size from {h5_path}")


def load_keras_weights(h5_path: str | os.PathLike) -> tuple[dict, int, int]:
    """Load a reference predict-model `.h5` into the param tree.

    Returns (params, window, n_classes).
    """
    params: dict = {}
    bn_seen = 0
    bn_slots = ["bn_c1", "bn_c2", "bn_r1", "bn_r2", "bn_t1"]
    window = None
    n_classes = None

    with hdf5.File(h5_path, "r") as f:
        for lname, arrs in _layer_arrays(f):
            shapes = [a.shape for a in arrs.values()]
            n_arr = len(arrs)
            if n_arr == 4 and all(len(s) == 1 for s in shapes):
                params[bn_slots[bn_seen]] = _classify_bn(arrs)
                bn_seen += 1
            elif n_arr == 6:
                lp = _classify_bilstm(arrs)
                d_in = lp["fwd"]["wi"].shape[0]
                slot = {6: "read_rnn1", 32: "read_rnn2", 192: "total_rnn1", 256: "total_rnn2"}[d_in]
                params[slot] = lp
            elif n_arr == 2:
                kernel = next(a for a in arrs.values() if a.ndim >= 2)
                bias = next(a for a in arrs.values() if a.ndim == 1)
                if kernel.ndim == 3:
                    slot = "conv1" if kernel.shape[1] == 1 else "conv2"
                    params[slot] = {"w": kernel, "b": bias}
                    continue
                d_in, d_out = kernel.shape
                if d_out == 64 and d_in >= 200:
                    slot = "sig_dense"
                elif (d_in, d_out) == (128, 128):
                    slot = "dense1"
                elif (d_in, d_out) == (128, 32):
                    slot = "dense2"
                elif (d_in, d_out) == (32, 6):
                    slot = "main_out"
                elif d_out == 16:
                    slot = "feature"
                    window = d_in // 6
                elif d_in == 16:
                    slot = "final_out"
                    n_classes = d_out
                else:
                    raise ValueError(f"Unrecognized dense layer {lname} {kernel.shape}")
                params[slot] = {"w": kernel, "b": bias}
            elif n_arr == 1:
                # center-loss Embedding (train-model weights only)
                params["centers"] = next(iter(arrs.values()))
            else:
                raise ValueError(f"Unrecognized layer {lname} with {n_arr} arrays")

    required = {
        "conv1", "bn_c1", "conv2", "bn_c2", "sig_dense",
        "read_rnn1", "bn_r1", "read_rnn2", "bn_r2",
        "total_rnn1", "bn_t1", "total_rnn2",
        "dense1", "dense2", "main_out", "feature", "final_out",
    }
    missing = required - set(params)
    if missing:
        raise ValueError(f"Missing layers in {h5_path}: {sorted(missing)}")
    return params, int(window), int(n_classes)
