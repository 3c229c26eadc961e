"""Plain reference of NanoReviser's model-mode revision, in NumPy and
PyTorch, written from the published description (reference
``nanorev_fast5_handeler.py``, ``preprocessing.py``, ``lstmmodel.py``,
``nanorevcnn.py``, ``output_handeler.py`` of pkubioinformatics/NanoReviser)
and not from the program. It imports nothing of the program and takes only
what the benchmark made from the seed: the reads' event tables and signals,
and the weight trees.

Per read:

* decode: the Albacore event table in forward order, move 0 emits
  nothing, move 1 the state's centre base at the event's start, move 2 the
  bases at [1] and [2] of the state at start and start + 2; durations are
  the differences of the starts, the last 3 samples if the last two starts
  are under 5 apart, else 5;
* per base row: the raw signal from the first base on, normalized by its
  median and median absolute deviation; the window [st - 25, st + 25)
  clipped to the signal, zero-padded to 50 with ceil(pad / 2) on the left;
  the six features [colour / 300 (A 250, G 180, T 100, C 30, other 0),
  event mean / median, event std / MAD, duration / 10, Albacore's event
  mean, Albacore's event stdv], the event moments over [start, next
  start) of the raw signal (population moments);
* the model per window of T rows (window i covers rows i .. i + T - 1, and
  a read of n bases has n - T windows): two Conv1D(8, 3, same, relu) each
  followed by BN, the input added back, Dense(64) on the flattened 400
  values; BiLSTM(16) on the features, BN, BiLSTM(64), BN, concatenated
  with the signal branch, BiLSTM(128), BN, BiLSTM(64); Dense(128, relu),
  Dense(32, relu), Dense(6, relu) per step; Dense(16, relu) on the T x 6
  flattened; Dense(classes). LSTM gates i, f, c, o with Keras's
  hard_sigmoid, BN eps 1e-3;
* the merge (``output_handeler.py``'s rules, placed at the window centre).

``precision="f32"`` computes in float32 with TF32 off: the reference.
``precision="fp8"`` rounds both operands of every matrix product to
float8 e4m3 (scaled per tensor for weights, per row for activations,
accumulated in float32): the control, the step below the bf16 the program
serves in.
"""

from __future__ import annotations

import numpy as np

LABEL_CHARS = np.frombuffer(b"D-CTGA", np.uint8)    # model 1 class -> char
COLOUR = np.zeros(256)
for _b, _c in zip(b"AGTC", (250.0, 180.0, 100.0, 30.0)):
    COLOUR[_b] = _c
QUERY = 50


# ------------------------------------------------------------------ inputs


def decode(events: np.ndarray, signal: np.ndarray):
    """(bases u8, starts relative to the first base, durations, ab_mean,
    ab_std, signal from the first base on)."""
    move = events["move"].astype(np.int64)
    n_emit = np.where(move == 0, 0, np.where(move == 2, 2, 1))
    ev = np.repeat(np.arange(len(events)), n_emit)
    second = np.zeros(len(ev), bool)
    first_of_pair = np.zeros(len(ev), bool)
    pair_start = np.cumsum(n_emit) - n_emit
    twos = np.flatnonzero(n_emit == 2)
    first_of_pair[pair_start[twos]] = True
    second[pair_start[twos] + 1] = True
    states = np.frombuffer(events["model_state"].astype("S5").tobytes(),
                           np.uint8).reshape(-1, 5)
    bases = np.where(first_of_pair, states[ev, 1], states[ev, 2]).astype(np.uint8)
    starts = events["start"].astype(np.int64)[ev] + 2 * second
    dur = np.empty(len(starts), np.float64)
    dur[:-1] = np.diff(starts)
    dur[-1] = 3.0 if starts[-1] - starts[-2] < 5 else 5.0
    if len(signal) < starts[-1] + dur[-1]:
        raise ValueError("signal shorter than the events")
    tail = np.asarray(signal[starts[0]:], np.int64)
    return (bases, starts - starts[0], dur,
            events["mean"].astype(np.float64)[ev],
            events["stdv"].astype(np.float64)[ev], tail)


def base_rows(events: np.ndarray, signal: np.ndarray):
    """(bases u8 [n], signal windows f32 [n, 50], features f32 [n, 6])."""
    bases, st, dur, ab_mean, ab_std, tail = decode(events, signal)
    ns = len(tail)
    med = float(np.median(tail))
    mad = float(np.median(np.abs(tail - med)))
    lo = np.maximum(st - QUERY // 2, 0)
    hi = np.minimum(st + QUERY // 2, ns)
    left = (QUERY - (hi - lo) + 1) // 2
    col = np.arange(QUERY)[None, :]
    src = lo[:, None] + col - left[:, None]
    inside = (src >= lo[:, None]) & (src < hi[:, None])
    win = np.where(inside, (tail[np.clip(src, 0, ns - 1)] - med) / mad, 0.0)
    end = np.empty_like(st)
    end[:-1] = st[1:]
    end[-1] = min(st[-1] + int(dur[-1]), ns)
    c1 = np.concatenate([[0], np.cumsum(tail)])
    c2 = np.concatenate([[0], np.cumsum(tail * tail)])
    cnt = np.maximum(end - st, 1).astype(np.float64)
    mean = (c1[end] - c1[st]) / cnt
    std = np.sqrt(np.maximum((c2[end] - c2[st]) / cnt - mean * mean, 0.0))
    feats = np.stack([COLOUR[bases] / 300.0, mean / med, std / mad, dur / 10.0,
                      ab_mean, ab_std], axis=1)
    return bases, win.astype(np.float32), feats.astype(np.float32)


# ------------------------------------------------------------------- model


class _Ops:
    """The matrix product of the chosen precision."""

    def __init__(self, precision: str):
        import torch

        if precision not in ("f32", "fp8"):
            raise ValueError(precision)
        self.fp8 = precision == "fp8"
        self.torch = torch

    def _q(self, x, dim):
        torch = self.torch
        amax = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-30)
        s = amax / 448.0                       # e4m3's largest finite value
        return (x / s).to(torch.float8_e4m3fn).to(torch.float32) * s

    def mm(self, x, w):
        """x [..., k] @ w [k, n]."""
        if self.fp8:
            x = self._q(x, -1)
            w = self._q(w, (0, 1))
        return x @ w


def _hard_sigmoid(x):
    return (0.2 * x + 0.5).clamp(0.0, 1.0)


def _bn(p, x):
    return (x - p["mean"]) / (p["var"] + 1e-3).sqrt() * p["gamma"] + p["beta"]


def _lstm(ops, p, x, reverse: bool):
    torch = ops.torch
    h_units = p["wh"].shape[0]
    xs = torch.flip(x, (1,)) if reverse else x
    z_in = ops.mm(xs, p["wi"]) + p["b"]
    h = x.new_zeros(x.shape[0], h_units)
    c = x.new_zeros(x.shape[0], h_units)
    out = []
    for t in range(x.shape[1]):
        z = z_in[:, t] + ops.mm(h, p["wh"])
        i, f, g, o = z.split(h_units, dim=-1)
        c = _hard_sigmoid(f) * c + _hard_sigmoid(i) * torch.tanh(g)
        h = _hard_sigmoid(o) * torch.tanh(c)
        out.append(h)
    out = torch.stack(out, 1)
    return torch.flip(out, (1,)) if reverse else out


def _bilstm(ops, p, x):
    return ops.torch.cat([_lstm(ops, p["fwd"], x, False),
                          _lstm(ops, p["bwd"], x, True)], -1)


def _conv_relu(ops, p, x):
    """Conv1D(k, same) + relu over [N, L, C]."""
    torch = ops.torch
    k = p["w"].shape[0]
    xp = torch.nn.functional.pad(x, (0, 0, (k - 1) // 2, k // 2))
    cols = torch.cat([xp[:, j : j + x.shape[1]] for j in range(k)], -1)
    return torch.relu(ops.mm(cols, p["w"].reshape(-1, p["w"].shape[-1])) + p["b"])


def signal_rows(ops, p, win):
    """[N, 50] windows -> [N, 64] (the conv branch and its Dense)."""
    x = win[:, :, None]
    h = _bn(p["bn_c1"], _conv_relu(ops, p["conv1"], x))
    h = _bn(p["bn_c2"], _conv_relu(ops, p["conv2"], h))
    h = (h + x).reshape(win.shape[0], -1)
    return ops.mm(h, p["sig_dense"]["w"]) + p["sig_dense"]["b"]


def window_logits(ops, p, feats, sig):
    """feats [B, T, 6], sig [B, T, 64] -> logits [B, classes]."""
    torch = ops.torch
    r = _bn(p["bn_r1"], _bilstm(ops, p["read_rnn1"], feats))
    r = _bn(p["bn_r2"], _bilstm(ops, p["read_rnn2"], r))
    h = _bn(p["bn_t1"], _bilstm(ops, p["total_rnn1"], torch.cat([r, sig], -1)))
    h = _bilstm(ops, p["total_rnn2"], h)
    h = torch.relu(ops.mm(h, p["dense1"]["w"]) + p["dense1"]["b"])
    h = torch.relu(ops.mm(h, p["dense2"]["w"]) + p["dense2"]["b"])
    h = torch.relu(ops.mm(h, p["main_out"]["w"]) + p["main_out"]["b"])
    h = torch.relu(ops.mm(h.reshape(h.shape[0], -1), p["feature"]["w"])
                   + p["feature"]["b"])
    return ops.mm(h, p["final_out"]["w"]) + p["final_out"]["b"]


def _to_torch(tree, device):
    import torch

    if isinstance(tree, dict):
        return {k: _to_torch(v, device) for k, v in tree.items()}
    return torch.tensor(np.asarray(tree), dtype=torch.float32, device=device)


def read_logits(models: list, rows: list, window: int, device,
                precision: str = "f32", block: int = 16384) -> list:
    """Logits of every window of every read, for each model.

    ``models``: numpy weight trees; ``rows``: per read (bases, win, feats)
    of ``base_rows``. Returns per read a list of f32 numpy arrays
    [n - window, classes], one per model. Runs in blocks of windows."""
    import torch

    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        ops = _Ops(precision)
        n = [len(b) for b, _, _ in rows]
        offs = np.concatenate([[0], np.cumsum(n)])
        win = torch.from_numpy(np.concatenate([w for _, w, _ in rows])).to(device)
        feats = torch.from_numpy(np.concatenate([f for _, _, f in rows])).to(device)
        # window (read r, i) starts at row offs[r] + i
        first = np.concatenate([offs[r] + np.arange(max(n[r] - window, 0))
                                for r in range(len(rows))]).astype(np.int64)
        first = torch.from_numpy(first).to(device)
        steps = torch.arange(window, device=device)
        out = []
        with torch.no_grad():
            for tree in models:
                p = _to_torch(tree, device)
                sig = torch.cat([signal_rows(ops, p, win[i : i + block])
                                 for i in range(0, len(win), block)])
                got = []
                for i in range(0, len(first), block):
                    idx = first[i : i + block, None] + steps[None, :]
                    got.append(window_logits(ops, p, feats[idx], sig[idx]))
                out.append(torch.cat(got).cpu().numpy()
                           if got else np.zeros((0, 1), np.float32))
        wins = np.concatenate([[0], np.cumsum([max(k - window, 0) for k in n])])
        return [[m[wins[r] : wins[r + 1]] for m in out] for r in range(len(rows))]
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


# ------------------------------------------------------------------- merge


def calibrate(bases: np.ndarray, y1: np.ndarray, window: int,
              min_agree: float = 0.5, min_n: int = 64) -> tuple[int, np.ndarray]:
    """The window-centre offset the weights encode: the shift k in 0..T
    that best matches model 1's base calls to the read's bases, else
    (T - 1) // 2 when no shift reaches ``min_agree``. Returns (offset, the
    agreement of each k, nan where fewer than ``min_n`` windows count)."""
    chars = LABEL_CHARS[y1]
    agree = np.full(window + 1, np.nan)
    for k in range(window + 1):
        m = min(len(bases) - k, len(chars))
        if m >= min_n:
            agree[k] = np.mean(chars[:m] == bases[k : k + m])
    best = int(np.nanargmax(agree)) if np.isfinite(agree).any() else -1
    if best < 0 or agree[best] < min_agree:
        return (window - 1) // 2, agree
    return best, agree


def merge(bases: np.ndarray, y1: np.ndarray, y2: np.ndarray,
          offset: int) -> bytes:
    """The revised read: window i's pair of calls revises base i + offset;
    the bases before and after the windows pass through."""
    out = bytearray(bases[:offset].tobytes())
    for i in range(len(y1)):
        b = int(bases[offset + i])
        y = int(LABEL_CHARS[y1[i]])
        z = int(LABEL_CHARS[y2[i] + 1])
        if y == z and y in b"ACGT":
            out.append(y)
        elif y == ord("D") and z in b"ACGT":
            out += bytes([b, z])
        elif y == ord("-") and z == ord("-"):
            pass
        else:
            out.append(b)
    out += bases[offset + len(y1):].tobytes()
    return bytes(out)
