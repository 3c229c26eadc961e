"""Training data: labelled per-read caches and the windowed corpus.

Copy of ``nanoreviser_tpu/train/data.py`` (numpy and the port's own
modules), mirroring the reference training pipeline
(nanorevtrainutils.py:56-218) with the same on-disk ``.npz`` artifact
(keys refvals, refvals2, readVals, signal_mean/std, signal_len,
ab_mean/std, signal_x, mapvals, starts, scale, shift), so that caches of
the reference, of the JAX package and of the port interoperate.

Labelling engines:
* "sw"       - the banded Smith-Waterman path (``align.sw``, whose default
               backend is the port's host library);
* "graphmap" - a subprocess, exactly like the reference (the last SAM
               record wins; an unmapped read raises).

The corpus reproduces get_trainning_input exactly, including the windows
that straddle read boundaries in the concatenation of all reads (reference
:198-209) and the y2 = refvals2 - 1 target shift (:213). ``BatchIterator``
draws the same permutation from the same seed as the JAX package's, so
both packages train on identical batches.
"""

from __future__ import annotations

import os
import subprocess
from dataclasses import dataclass

import numpy as np

from ..align.labels import clean_read_map_ref, fix_raw_starts_for_clipped_bases
from ..align.sam import parse_sam_record, pick_sam_record
from ..io.fast5 import get_read_data
from ..io.writers import format_train_fasta
from ..signal.features import base_colors, base_labels
from ..signal.segmentation import segment_signal


@dataclass
class LabeledRead:
    refvals: np.ndarray      # [N] int labels (model1 target space)
    refvals2: np.ndarray     # [N] int labels (model2 target space, pre -1)
    readvals: np.ndarray     # [N] base colors
    signal_mean: np.ndarray
    signal_std: np.ndarray
    signal_len: np.ndarray
    ab_mean: np.ndarray
    ab_std: np.ndarray
    signal_x: np.ndarray     # [N, 50]
    mapvals: np.ndarray
    starts: np.ndarray
    scale: float
    shift: float


def _align_with_graphmap(
    read_fasta_fn: str, genome_fn: str, out_fn: str, graphmap_exe: str,
    genome_index: dict,
):
    cmd = [graphmap_exe, "align", "-r", genome_fn, "-d", read_fasta_fn,
           "-o", out_fn, "-t", "1"]
    with open(os.devnull, "w") as devnull:
        status = subprocess.call(cmd, stdout=devnull, stderr=devnull)
    if status != 0:
        raise RuntimeError("Align Error, please check your graphmap or bwa mem")
    with open(out_fn) as fp:
        record = pick_sam_record(fp.readlines())
    return parse_sam_record(record, genome_index)


def _align_with_sw(read_seq: str, index, genome: dict):
    from ..align.sw import align_read_to_genome

    result = align_read_to_genome(read_seq, index, genome)
    if result is None:
        raise RuntimeError("Map Error, the read is unmapped.")
    return result


def label_read(
    fast5_fn: str,
    genome: dict[str, str],
    *,
    engine: str = "sw",
    kmer_index=None,
    genome_fn: str | None = None,
    graphmap_exe: str = "graphmap",
    tmp_dir: str = "./train_tmp",
    basecall_group: str = "Basecall_1D_000",
    basecall_subgroup: str = "BaseCalled_template",
    bases_override: str | None = None,
) -> LabeledRead:
    """Decode + align + label + segment one training read.

    ``bases_override`` substitutes the decoded base string before alignment
    (same length: substitutions only, so starts and signal stay
    consistent), to inject known errors whose correction the signal can
    evidence.
    """
    rd = get_read_data(fast5_fn, basecall_group, basecall_subgroup)
    if bases_override is not None:
        if len(bases_override) != rd.n_bases:
            raise ValueError("bases_override must preserve read length")
        import dataclasses

        rd = dataclasses.replace(rd, bases=bases_override)

    if engine == "graphmap":
        os.makedirs(tmp_dir, exist_ok=True)
        stem = os.path.basename(str(fast5_fn)).split(".")[0]
        read_fasta_fn = os.path.join(tmp_dir, stem + ".fasta")
        with open(read_fasta_fn, "w") as fp:
            fp.write(format_train_fasta(str(fast5_fn), rd.bases))
        out_fn = os.path.join(tmp_dir, stem + ".sam")
        cols = _align_with_graphmap(
            read_fasta_fn, genome_fn, out_fn, graphmap_exe, genome
        )
        read_vals, map_vals, ref_vals = cols.read_vals, cols.map_vals, cols.ref_vals
        start_clip, end_clip = cols.start_clipped_bases, cols.end_clipped_bases
        os.remove(out_fn)
        os.remove(read_fasta_fn)
    elif engine == "sw":
        res = _align_with_sw(rd.bases, kmer_index, genome)
        read_vals, map_vals, ref_vals = res.read_vals, res.map_vals, res.ref_vals
        start_clip, end_clip = res.start_clipped_bases, res.end_clipped_bases
    else:
        raise ValueError(f"unknown alignment engine {engine!r}")

    starts, lengths, read_start, ab_mean, ab_std = fix_raw_starts_for_clipped_bases(
        int(start_clip), int(end_clip),
        rd.starts, rd.lengths, rd.read_start_rel_to_raw, rd.ab_mean, rd.ab_std,
    )
    clean_read, clean_map, clean_ref, clean_ref2 = clean_read_map_ref(
        read_vals, map_vals, ref_vals
    )
    signal = rd.signal[int(read_start):]
    seg = segment_signal(signal, starts, int(lengths[-1]))

    return LabeledRead(
        refvals=base_labels(clean_ref),
        refvals2=base_labels(clean_ref2),
        readvals=base_colors(clean_read),
        signal_mean=np.asarray(seg.event_mean),
        signal_std=np.asarray(seg.event_std),
        signal_len=np.asarray(lengths),
        ab_mean=np.asarray(ab_mean),
        ab_std=np.asarray(ab_std),
        signal_x=seg.windows.astype(np.float64),
        mapvals=np.array(list(clean_map)),
        starts=np.asarray(starts),
        scale=seg.scale,
        shift=seg.shift,
    )


def save_read_npz(labeled: LabeledRead, save_name: str) -> None:
    """Reference-compatible npz cache (nanorevtrainutils.py:113-126)."""
    np.savez(
        save_name,
        refvals=labeled.refvals,
        refvals2=labeled.refvals2,
        readVals=labeled.readvals,
        signal_mean=labeled.signal_mean,
        signal_std=labeled.signal_std,
        signal_len=labeled.signal_len,
        ab_mean=labeled.ab_mean,
        ab_std=labeled.ab_std,
        signal_x=labeled.signal_x,
        mapvals=labeled.mapvals,
        starts=labeled.starts,
        scale=labeled.scale,
        shift=labeled.shift,
    )


@dataclass
class TrainingCorpus:
    """Streaming windowed corpus: base arrays, windows gathered per batch.

    The reference materializes every length-T window of the concatenated
    corpus up front (nanorevtrainutils.py:198-209), a ~T x RAM blowup of the
    [N, 50] signal data. Here only the base
    arrays are kept; window w is rows [w, w+T) and BatchIterator gathers it
    at batch time. Sample ORDER and VALUES are identical to the reference's
    materialized tensors (windows straddle read boundaries; targets are the
    window centers, y2 pre-shifted by -1).
    """

    feats: np.ndarray      # [N, 6] f32 per-base features
    signal: np.ndarray     # [N, 50] f32 per-base signal windows
    y: np.ndarray          # [W, 1] i32 model1 targets (window centers)
    y2: np.ndarray         # [W, 1] i32 model2 targets (refvals2 - 1)
    window: int

    @property
    def n_windows(self) -> int:
        return len(self.y)

    def materialize(self):
        """The reference's full [W, T, *] tensors (tests / tiny corpora)."""
        w = np.arange(self.n_windows)[:, None] + np.arange(self.window)[None, :]
        return self.feats[w], self.signal[w], self.y, self.y2


def load_training_corpus(
    train_input_dir: str, window_size: int = 13
) -> TrainingCorpus:
    """Streaming training corpus, sample-identical to get_trainning_input.

    Loads every per-read .npz, concatenates base arrays (windows straddle
    read boundaries — reference quirk, :198-209), and derives the center
    targets — WITHOUT materializing the [W, T, 50] window tensor.
    """
    xs, signals, ys, y2s = [], [], [], []
    for fn in sorted(os.listdir(train_input_dir)):
        if not fn.endswith(".npz"):
            continue
        try:
            z = np.load(os.path.join(train_input_dir, fn))
            shift, scale = float(z["shift"]), float(z["scale"])
            feats = np.stack(
                [
                    z["readVals"] / 300.0,
                    z["signal_mean"] / shift,
                    z["signal_std"] / scale,
                    z["signal_len"] / 10.0,
                    z["ab_mean"],
                    z["ab_std"],
                ],
                axis=1,
            )
            n = min(len(feats), len(z["signal_x"]), len(z["refvals"]))
            xs.append(feats[:n])
            signals.append(z["signal_x"][:n])
            ys.append(z["refvals"][:n])
            y2s.append(z["refvals2"][:n])
        except Exception as exc:  # noqa: BLE001 — mirror reference's skip
            print("！！！[Error] training input file:", fn, exc)
            continue
    if not xs:
        raise RuntimeError("！！！[Error] fatal errors in loading training data.")

    x = np.concatenate(xs, axis=0).astype(np.float32)
    signal_x = np.concatenate(signals, axis=0).astype(np.float32)
    y = np.concatenate(ys, axis=0).astype(np.int32)
    y2 = np.concatenate(y2s, axis=0).astype(np.int32)

    n_total = len(x)
    if n_total <= 2 * window_size:
        raise RuntimeError("！！！[Error] corpus smaller than two windows.")
    set_bef = (window_size - 1) // 2
    set_aft = (window_size + 1) // 2
    y_train = y[set_bef:-set_aft].reshape(-1, 1)
    y_train2 = (y2[set_bef:-set_aft] - 1).reshape(-1, 1)
    return TrainingCorpus(
        feats=x, signal=signal_x, y=y_train, y2=y_train2, window=window_size
    )


class BatchIterator:
    """Keras-fit-like batching: validation_split from the END (pre-shuffle),
    per-epoch shuffling of the train portion, fixed-shape padded batches.

    Two input layouts:
    * pre-windowed: x [W, T, 6] / signal_x [W, T, 50] (tests, tiny corpora);
    * streaming (window=T given, x.ndim == 2): x [N, 6] / signal_x [N, 50]
      base arrays; window w is rows [w, w+T), gathered per batch. Identical
      samples in identical order, without the reference's ~T x RAM blowup
      (nanorevtrainutils.py:198-209).
    """

    def __init__(
        self,
        x: np.ndarray,
        signal_x: np.ndarray,
        y: np.ndarray,
        batch_size: int,
        validation_split: float = 0.0,
        seed: int = 0,
        window: int | None = None,
    ):
        self.streaming = x.ndim == 2
        if self.streaming and not window:
            raise ValueError("streaming base arrays require window=")
        n = len(y)
        n_val = int(n * validation_split)
        self.n = n
        self.n_train = n - n_val
        self.x, self.signal_x, self.y = x, signal_x, y
        self.batch_size = batch_size
        self.window = window
        self.rng = np.random.default_rng(seed)

    def _gather(self, idx: np.ndarray, weight: np.ndarray) -> dict:
        if self.streaming:
            rows = idx[:, None] + np.arange(self.window)[None, :]
            signal, feats = self.signal_x[rows], self.x[rows]
        else:
            signal, feats = self.signal_x[idx], self.x[idx]
        return {
            "signal": signal,
            "feats": feats,
            "y": self.y[idx, 0],
            "weight": weight,
        }

    def _padded(self, idx: np.ndarray):
        pad = self.batch_size - len(idx)
        weight = np.ones(self.batch_size, np.float32)
        if pad:
            idx = np.concatenate([idx, np.zeros(pad, np.int64)])
            weight[len(idx) - pad :] = 0.0
        return idx, weight

    def epoch(self):
        order = self.rng.permutation(self.n_train)
        bs = self.batch_size
        for i in range(0, self.n_train, bs):
            idx, weight = self._padded(order[i : i + bs])
            yield self._gather(idx, weight)

    def validation(self):
        bs = self.batch_size
        for i in range(self.n_train, self.n, bs):
            idx, weight = self._padded(np.arange(i, min(i + bs, self.n)))
            yield self._gather(idx, weight)

    @property
    def steps_per_epoch(self) -> int:
        return -(-self.n_train // self.batch_size)
