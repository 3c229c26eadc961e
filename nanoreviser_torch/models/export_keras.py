"""Export a reviser param tree to a Keras-2-style `.h5` weight file.

Copy of ``nanoreviser_tpu/models/export_keras.py`` (numpy and the
package's own HDF5 writer, ``io.hdf5``).

Produces the same container format the reference ships (HDF5 with
``layer_names``/``weight_names`` attrs, one group per layer) so artifacts
drop into reference-compatible tooling and round-trip through our own
shape-classifying importer (import_keras.py).
"""

from __future__ import annotations

import numpy as np

from ..io import hdf5


def _bn_arrays(name: str, bn: dict) -> dict:
    return {
        f"{name}/gamma:0": bn["gamma"],
        f"{name}/beta:0": bn["beta"],
        f"{name}/moving_mean:0": bn["mean"],
        f"{name}/moving_variance:0": bn["var"],
    }


def _dense_arrays(name: str, d: dict) -> dict:
    return {f"{name}/kernel:0": d["w"], f"{name}/bias:0": d["b"]}


def _lstm_arrays(name: str, lp: dict) -> dict:
    out = {}
    for tag, d in (("forward", lp["fwd"]), ("backward", lp["bwd"])):
        out[f"{tag}_{name}/kernel:0"] = d["wi"]
        out[f"{tag}_{name}/recurrent_kernel:0"] = d["wh"]
        out[f"{tag}_{name}/bias:0"] = d["b"]
    return out


def save_keras_weights(params: dict, path: str, window: int, n_classes: int):
    # Group order = Keras's topological traversal of the reference graph
    # (the two branches interleave by node depth) — legacy h5 loading
    # matches layers BY ORDER, not by name, so this order is what makes
    # ``model.load_weights(path)`` work on a rebuild of the reference
    # architecture (verified in tests/test_export_keras.py).
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
    with hdf5.File(path, "w") as f:
        f.attrs["layer_names"] = np.array(
            [name.encode() for name, _ in layers]
        )
        f.attrs["backend"] = b"jax-nanoreviser-tpu"
        for name, arrays in layers:
            grp = f.create_group(name)
            wnames = []
            for wname, arr in arrays.items():
                full = f"{name}/{wname}"
                grp.create_dataset(wname, data=np.asarray(arr, np.float32))
                wnames.append(full.encode())
            grp.attrs["weight_names"] = np.array(
                [w.split(b"/", 1)[1] for w in wnames]
            )
