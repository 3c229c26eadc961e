"""Bonito's CRF-CTC basecaller: its configuration, its encoder and an
importer of its model directories.

The architecture is ONT Bonito's ``rnn_encoder`` with a
``LinearCRFEncoder`` head (nanoporetech/bonito, ``bonito/crf/model.py``),
at the widths of ``dna_r9.4.1_e8_hac@v3.3``: per chunk of raw signal,
normalised by its read's median and MAD (x 1.4826),

1. Conv1d(1 -> 4, k 5, pad 2) + swish, Conv1d(4 -> 16, k 5, pad 2) + swish,
   Conv1d(16 -> features, k winlen, stride, pad winlen // 2) + swish, all
   with bias;
2. ``n_layers`` unidirectional LSTMs of ``features`` units (torch gate
   order i, f, g, o); layer i (from 0) runs on the time-reversed sequence
   and flips back when ``(n_layers - i) % 2`` is 1;
3. Linear(features -> 4 ** (state_len + 1)) with bias, then ``tanh(x) *
   scale``: the move scores, ``[T, N, n_states * 4]``, column ``s * 4 + r``
   the move into state s that emits base r.

The blank (stay) column of score ``blank_score`` that Bonito puts before
each group of 4 is left to the decode (``ops.crf_decode``), which reads it
as a constant. A Bonito model directory holds ``config.toml`` and
``weights_<n>.tar`` (a state dict saved by ``torch.save``); the highest
``n`` is loaded. ``load_bonito_model`` refuses, with the value in the
message, a configuration this package does not run.
"""

from __future__ import annotations

import glob
import os
import re
import tomllib
from dataclasses import dataclass

import torch
from torch import nn

LABELS = ("N", "A", "C", "G", "T")


@dataclass(frozen=True)
class CrfConfig:
    features: int = 384
    n_layers: int = 5
    stride: int = 5
    winlen: int = 19
    state_len: int = 4
    scale: float = 5.0
    blank_score: float = 2.0
    chunksize: int = 4000
    overlap: int = 500

    @property
    def n_states(self) -> int:
        return 4 ** self.state_len

    @property
    def n_moves(self) -> int:
        """Columns of the encoder's output: 4 moves into each state."""
        return 4 * self.n_states

    def steps(self, samples: int) -> int:
        """Output steps of a chunk of ``samples`` samples."""
        pad = self.winlen // 2
        return (samples + 2 * pad - self.winlen) // self.stride + 1

    def reverse(self, layer: int) -> bool:
        return (self.n_layers - layer) % 2 == 1


def _want(ok: bool, what: str, value) -> None:
    if not ok:
        raise ValueError(f"unsupported Bonito config: {what} = {value!r}")


def parse_bonito_config(doc: dict) -> CrfConfig:
    """A ``CrfConfig`` from a Bonito ``config.toml``'s tables; raises
    ValueError naming the first setting this package does not run."""
    model = doc.get("model", {})
    _want(model.get("package", "bonito.crf") == "bonito.crf", "model.package",
          model.get("package"))
    labels = tuple(doc.get("labels", {}).get("labels", LABELS))
    _want(labels == LABELS, "labels.labels", list(labels))
    _want(doc.get("input", {}).get("features", 1) == 1, "input.features",
          doc.get("input", {}).get("features"))
    enc = doc.get("encoder", {})
    for key, want in (("activation", "swish"), ("rnn_type", "lstm"),
                      ("first_conv_size", 4), ("expand_blanks", True)):
        _want(enc.get(key, want) == want, f"encoder.{key}", enc.get(key))
    state_len = doc.get("global_norm", {}).get("state_len")
    _want(isinstance(state_len, int) and 1 <= state_len <= 5,
          "global_norm.state_len", state_len)
    _want(enc.get("blank_score") is not None, "encoder.blank_score",
          enc.get("blank_score"))
    _want(enc.get("scale") is not None, "encoder.scale", enc.get("scale"))
    n_layers = enc.get("num_layers", enc.get("n_layers", 5))
    _want(isinstance(n_layers, int) and n_layers >= 1, "encoder.num_layers",
          n_layers)
    bc = doc.get("basecaller", {})
    cfg = CrfConfig(
        features=int(enc.get("features", 768)), n_layers=n_layers,
        stride=int(enc.get("stride", 5)), winlen=int(enc.get("winlen", 19)),
        state_len=state_len, scale=float(enc["scale"]),
        blank_score=float(enc["blank_score"]),
        chunksize=int(bc.get("chunksize", 4000)),
        overlap=int(bc.get("overlap", 500)))
    _want(cfg.features >= 1, "encoder.features", cfg.features)
    _want(cfg.stride >= 1 and cfg.winlen >= 1, "encoder.stride/winlen",
          (cfg.stride, cfg.winlen))
    _want(cfg.overlap >= 0 and cfg.chunksize > cfg.overlap
          and cfg.steps(cfg.chunksize) > (cfg.overlap // 2) // cfg.stride,
          "basecaller.chunksize/overlap", (cfg.chunksize, cfg.overlap))
    return cfg


class CrfEncoder(nn.Module):
    """The encoder: [N, 1, samples] -> move scores [T, N, n_states * 4]."""

    def __init__(self, cfg: CrfConfig):
        super().__init__()
        self.cfg = cfg
        f = cfg.features
        self.convs = nn.ModuleList([
            nn.Conv1d(1, 4, 5, padding=2),
            nn.Conv1d(4, 16, 5, padding=2),
            nn.Conv1d(16, f, cfg.winlen, stride=cfg.stride,
                      padding=cfg.winlen // 2)])
        self.rnns = nn.ModuleList([nn.LSTM(f, f) for _ in range(cfg.n_layers)])
        self.linear = nn.Linear(f, cfg.n_moves)

    def stem(self, x: torch.Tensor) -> torch.Tensor:
        for conv in self.convs:
            x = nn.functional.silu(conv(x))
        return x.permute(2, 0, 1)                           # [T, N, features]

    def lstms(self, x: torch.Tensor) -> torch.Tensor:
        for i, rnn in enumerate(self.rnns):
            if self.cfg.reverse(i):
                x = rnn(x.flip(0))[0].flip(0)
            else:
                x = rnn(x)[0]
        return x

    def head(self, x: torch.Tensor) -> torch.Tensor:
        return torch.tanh(self.linear(x)) * self.cfg.scale

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.head(self.lstms(self.stem(x)))


# -------------------------------------------------- Bonito's state-dict keys


def bonito_keys(cfg: CrfConfig) -> dict:
    """{Bonito state-dict key: this module's key}. Bonito's ``Serial``
    numbers its modules: the three convolutions 0-2, a ``Permute`` at 3,
    the LSTMs (``RNNWrapper.rnn``) from 4, the ``LinearCRFEncoder`` last."""
    out = {}
    for i in range(3):
        for p in ("weight", "bias"):
            out[f"encoder.{i}.conv.{p}"] = f"convs.{i}.{p}"
    for k in range(cfg.n_layers):
        for p in ("weight_ih_l0", "weight_hh_l0", "bias_ih_l0", "bias_hh_l0"):
            out[f"encoder.{4 + k}.rnn.{p}"] = f"rnns.{k}.{p}"
    for p in ("weight", "bias"):
        out[f"encoder.{4 + cfg.n_layers}.linear.{p}"] = f"linear.{p}"
    return out


def import_bonito_state(state: dict, cfg: CrfConfig) -> dict:
    """Bonito's state dict (keys optionally under ``module.``, as a model
    trained data-parallel saves them) as this module's."""
    state = {k[len("module."):] if k.startswith("module.") else k: v
             for k, v in state.items()}
    keys = bonito_keys(cfg)
    missing = sorted(set(keys) - set(state))
    if missing:
        raise ValueError(f"Bonito weights lack {missing[:4]}"
                         + (" ..." if len(missing) > 4 else ""))
    return {ours: state[theirs] for theirs, ours in keys.items()}


def export_bonito_state(module: CrfEncoder) -> dict:
    """This module's weights under Bonito's keys."""
    own = module.state_dict()
    return {theirs: own[ours].detach().clone()
            for theirs, ours in bonito_keys(module.cfg).items()}


def weights_file(model_dir: str) -> str:
    found = []
    for path in glob.glob(os.path.join(model_dir, "weights_*.tar")):
        m = re.fullmatch(r"weights_(\d+)\.tar", os.path.basename(path))
        if m:
            found.append((int(m.group(1)), path))
    if not found:
        raise FileNotFoundError(f"no weights_<n>.tar in {model_dir}")
    return max(found)[1]


def load_bonito_model(model_dir: str) -> CrfEncoder:
    """The encoder of a Bonito model directory, on the CPU in float32."""
    with open(os.path.join(model_dir, "config.toml"), "rb") as fp:
        cfg = parse_bonito_config(tomllib.load(fp))
    state = torch.load(weights_file(model_dir), map_location="cpu",
                       weights_only=True)
    module = CrfEncoder(cfg)
    module.load_state_dict(import_bonito_state(state, cfg))
    return module.eval()


def save_bonito_model(module: CrfEncoder, model_dir: str, n: int = 1) -> None:
    """A Bonito model directory of ``module``: ``config.toml`` and
    ``weights_<n>.tar``."""
    cfg = module.cfg
    os.makedirs(model_dir, exist_ok=True)
    text = (
        '[model]\npackage = "bonito.crf"\n\n'
        '[labels]\nlabels = ["N", "A", "C", "G", "T"]\n\n'
        '[input]\nfeatures = 1\n\n'
        f'[global_norm]\nstate_len = {cfg.state_len}\n\n'
        f'[encoder]\nactivation = "swish"\nrnn_type = "lstm"\n'
        f'features = {cfg.features}\nnum_layers = {cfg.n_layers}\n'
        f'stride = {cfg.stride}\nwinlen = {cfg.winlen}\n'
        f'scale = {cfg.scale!r}\nblank_score = {cfg.blank_score!r}\n\n'
        f'[basecaller]\nchunksize = {cfg.chunksize}\n'
        f'overlap = {cfg.overlap}\n')
    with open(os.path.join(model_dir, "config.toml"), "w") as fp:
        fp.write(text)
    torch.save(export_bonito_state(module),
               os.path.join(model_dir, f"weights_{n}.tar"))
