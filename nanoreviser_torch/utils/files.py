"""Training artifact names and the training summary files.

Counterpart of ``nanoreviser_tpu/utils/files.py:20-57`` (reference
fileoptions.py): the model file scheme ``<species>_win<w>_<e>ep_<tag>.h5``
(:57-75), the reference's ``hisroty`` spelling of the history file kept
for drop-in compatibility, and the summary dict (:89-102).

The history CSV is written without pandas (the card's machine has none),
byte for byte as ``pd.DataFrame(history).to_csv(index=False)`` writes it:
a header of the keys, one row per epoch, floats as ``repr`` and NaN as an
empty field.
"""

from __future__ import annotations

import json
import math
import os
import time


def model_fn_generate(
    model_dir: str,
    train_model_dir: str,
    output_dir: str,
    species: str,
    window_size: int,
    epochs: int,
    model_tag: str,
) -> tuple[str, str, str, str]:
    """(predict .h5, train .h5, history .csv, parameters .json) paths."""
    stem = f"{species}_win{window_size}_{epochs}ep_{model_tag}"
    model_predict_fn = os.path.join(model_dir, stem + ".h5")
    model_train_fn = os.path.join(train_model_dir, "train_" + stem + ".h5")
    model_history_fn = os.path.join(output_dir, stem + "_hisroty.csv")
    model_summary_fn = os.path.join(output_dir, stem + "_parameters.json")
    return model_predict_fn, model_train_fn, model_history_fn, model_summary_fn


def summary_generate(args, start_t: float) -> dict:
    return {
        "model_type": args.model_type,
        "species": args.species,
        "input_file": args.fast5_base_dir,
        "read_counts": args.read_counts,
        "window_size": args.window_size,
        "epochs": args.epochs,
        "batch_size": args.batch_size,
        "validation_split": args.validation_split,
        "training_time": str(int(time.time() - start_t)) + " seconds",
    }


def _csv_field(v: float) -> str:
    v = float(v)
    return "" if math.isnan(v) else repr(v)


def history_csv(history: dict) -> str:
    """``history`` (column name -> list of floats, all of one length) as
    pandas' ``to_csv(index=False)`` text."""
    cols = list(history)
    rows = zip(*(history[c] for c in cols))
    lines = [",".join(cols)] + [",".join(_csv_field(v) for v in r) for r in rows]
    return "\n".join(lines) + "\n"


def write_summary_file(history: dict, summary: dict, history_fn: str,
                       summary_fn: str) -> None:
    with open(summary_fn, "w") as f:
        json.dump(summary, f)
    with open(history_fn, "w") as f:
        f.write(history_csv(history))
