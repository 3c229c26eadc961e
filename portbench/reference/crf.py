"""Plain reference of Bonito's CRF-CTC basecaller, as the port's
``--revise_mode basecaller --basecaller_model`` runs it, in float32.

Written from the published description (nanoporetech/bonito
``bonito/crf/model.py``: ``rnn_encoder``, ``LinearCRFEncoder``,
``SeqdistModel.decode_batch``; ``bonito/util.py`` ``chunk`` and
``stitch``; davidcpage/seqdist's CTC-CRF) and not from the program. It
imports numpy and torch only, no kernel and no module of the program;
``tests/torch_crf_reference.py`` and ``portbench/reference/crf.py`` are the
same file. Weights are Bonito's state dict (its key names); ``cfg`` a dict
of ``features``, ``n_layers``, ``stride``, ``winlen``, ``state_len``,
``scale``, ``blank_score``, ``chunksize``, ``overlap``.

Per read:

* the whole raw signal normalised by its median and MAD x 1.4826 (a MAD
  of 0 scales by 1). Departure: Bonito first trims the open-pore start and
  scales to pA; the scaling cancels in the normalisation, the trim is left
  out;
* chunks of ``chunksize`` samples, ``chunksize - overlap`` apart, the last
  ending at the read's end, and one at the start where they leave a stub;
  a shorter read is one chunk padded with zeros on the left;
* per chunk: Conv1d(1, 4, 5, pad 2), Conv1d(4, 16, 5, pad 2), Conv1d(16,
  features, winlen, stride, pad winlen // 2), each with bias and swish;
  ``n_layers`` LSTMs of ``features`` units (gates i, f, g, o; sigmoid,
  tanh), layer i on the reversed sequence when ``(n_layers - i) % 2`` is 1,
  each written out step by step; Linear(features, 4 ** (state_len + 1)),
  ``tanh(x) * scale``, and the blank score before each group of 4: scores
  ``[T, N, S, 5]`` over S = 4 ** state_len states, column 0 the stay in s,
  column 1 + r the move into s from ``s // 4 + r * S // 4``, emitting r;
* the posterior of each step's transitions under the CTC-CRF with every
  start and end state free, by forward and backward recursions (each
  step's alphas and betas shifted by their largest value, and each step's
  posteriors normalised over the step, which is dividing by Z);
* the Viterbi path over ``log(posterior + 1e-8)`` (``decode_batch``; each
  step's scores shifted by their largest value), ties to the lowest
  column and the lowest end state; each step's label is the path's column
  (0 emits nothing); departure: decoded per chunk, then stitched (Bonito
  0.3 stitched scores and ran a beam search over the read);
* stitching: the first chunk keeps steps up to ``(stub + overlap // 2) //
  stride`` (its middle end without a stub), the others from ``(overlap //
  2) // stride``, the middle ones up to ``(chunksize - overlap // 2) //
  stride``, the last to its end; a one-chunk read keeps everything;
* the bases N A C G T by label, and, the port's rule and not Bonito's
  qstring, quality ``33 + clamp(rint(-10 log10(1 - p)), 1, 50)`` of each
  emitted move's posterior p; the read trimmed ``[13:-12]`` (the reference
  NanoReviser's ``[13:-13]`` of a harvested fastq line).

``precision="fp8"`` rounds both operands of every matrix product and
convolution to float8 e4m3 (scaled per tensor for weights, per row for
activations, accumulated in float32): the control, the step below the
fp16 the program serves in.
"""

from __future__ import annotations

import math

import numpy as np

LABELS = np.frombuffer(b"NACGT", np.uint8)


def normalise(sig: np.ndarray) -> np.ndarray:
    x = np.asarray(sig, np.float64)
    med = np.median(x)
    mad = np.median(np.abs(x - med)) * 1.4826
    if mad == 0:
        mad = 1.0
    return (x.astype(np.float32) - np.float32(med)) / np.float32(mad)


def chunk(x: np.ndarray, chunksize: int, overlap: int):
    """([n, chunksize] chunks, stub)."""
    n = len(x)
    if n < chunksize:
        out = np.zeros((1, chunksize), np.float32)
        out[0, chunksize - n:] = x
        return out, 0
    step = chunksize - overlap
    stub = (n - overlap) % step
    rest = [x[k : k + chunksize] for k in range(stub, n - chunksize + 1, step)]
    if stub > 0:
        rest = [x[:chunksize]] + rest
    return np.stack(rest).astype(np.float32), stub


def stitch(per_chunk: list, stub: int, cfg: dict) -> np.ndarray:
    """One read's per-step values from its chunks' ([T] each)."""
    if len(per_chunk) == 1:
        return per_chunk[0]
    semi = cfg["overlap"] // 2
    start = semi // cfg["stride"]
    end = (cfg["chunksize"] - semi) // cfg["stride"]
    first_end = (stub + semi) // cfg["stride"] if stub > 0 else end
    parts = [per_chunk[0][:first_end]]
    parts += [c[start:end] for c in per_chunk[1:-1]]
    parts.append(per_chunk[-1][start:])
    return np.concatenate(parts)


class Ops:
    """Matrix products and convolutions in the chosen precision."""

    def __init__(self, precision: str = "f32"):
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
            w = self._q(w, tuple(range(w.dim())))
        return x @ w

    def conv(self, x, w, b, stride, pad):
        torch = self.torch
        if self.fp8:
            x = self._q(x, (1, 2))
            w = self._q(w, tuple(range(w.dim())))
        return torch.nn.functional.conv1d(x, w, b, stride=stride, padding=pad)


def lstm(ops: Ops, x, w_ih, w_hh, b_ih, b_hh, reverse: bool):
    """x [T, N, D] -> [T, N, H], one step at a time."""
    torch = ops.torch
    if reverse:
        x = x.flip(0)
    hidden = w_hh.shape[1]
    xp = ops.mm(x, w_ih.T) + b_ih + b_hh
    h = x.new_zeros(x.shape[1], hidden)
    c = x.new_zeros(x.shape[1], hidden)
    out = []
    for t in range(x.shape[0]):
        g = xp[t] + ops.mm(h, w_hh.T)
        i = torch.sigmoid(g[:, :hidden])
        f = torch.sigmoid(g[:, hidden : 2 * hidden])
        gg = torch.tanh(g[:, 2 * hidden : 3 * hidden])
        o = torch.sigmoid(g[:, 3 * hidden :])
        c = f * c + i * gg
        h = o * torch.tanh(c)
        out.append(h)
    y = torch.stack(out)
    return y.flip(0) if reverse else y


def hidden(ops: Ops, state: dict, cfg: dict, chunks):
    """Chunks [N, chunksize] (a torch f32 tensor) -> the last LSTM's
    output [T, N, features]."""
    torch = ops.torch
    x = chunks[:, None, :]
    convs = ((5, 1), (5, 1), (cfg["winlen"], cfg["stride"]))
    for i, (k, stride) in enumerate(convs):
        x = ops.conv(x, state[f"encoder.{i}.conv.weight"],
                     state[f"encoder.{i}.conv.bias"], stride, k // 2)
        x = x * torch.sigmoid(x)
    x = x.permute(2, 0, 1)
    n_layers = cfg["n_layers"]
    for i in range(n_layers):
        p = f"encoder.{4 + i}.rnn."
        x = lstm(ops, x, state[p + "weight_ih_l0"], state[p + "weight_hh_l0"],
                 state[p + "bias_ih_l0"], state[p + "bias_hh_l0"],
                 reverse=(n_layers - i) % 2 == 1)
    return x


def scores(ops: Ops, state: dict, cfg: dict, chunks):
    """Chunks [N, chunksize] (a torch f32 tensor) -> scores [T, N, S, 5]."""
    torch = ops.torch
    x = hidden(ops, state, cfg, chunks)
    lin = f"encoder.{4 + cfg['n_layers']}.linear."
    y = torch.tanh(ops.mm(x, state[lin + "weight"].T) + state[lin + "bias"])
    y = y * cfg["scale"]
    t_len, n, _ = y.shape
    n_states = 4 ** cfg["state_len"]
    moves = y.reshape(t_len, n, n_states, 4)
    blank = torch.full((t_len, n, n_states, 1), float(cfg["blank_score"]),
                       dtype=y.dtype, device=y.device)
    return torch.cat([blank, moves], -1)


def sources(state_len: int):
    """(``src`` [S, 5]: the state column j of state s comes from; ``inv_s``,
    ``inv_j`` [S, 5]: the (state, column) pairs that come from each state,
    found by scanning ``src``)."""
    import torch

    n_states = 4 ** state_len
    src = [[s] + [s // 4 + r * (n_states // 4) for r in range(4)]
           for s in range(n_states)]
    leave = [[] for _ in range(n_states)]
    for s in range(n_states):
        for j in range(5):
            leave[src[s][j]].append((s, j))
    assert all(len(v) == 5 for v in leave)
    return (torch.tensor(src), torch.tensor([[s for s, _ in v] for v in leave]),
            torch.tensor([[j for _, j in v] for v in leave]))


def posteriors(sc, state_len: int):
    """Scores [T, N, S, 5] -> posteriors [T, N, S, 5]."""
    import torch

    t_len, n, n_states, _ = sc.shape
    src, inv_s, inv_j = (t.to(sc.device) for t in sources(state_len))
    alpha = [sc.new_zeros(n, n_states)]
    for t in range(t_len):
        a = torch.logsumexp(alpha[-1][:, src] + sc[t], -1)
        alpha.append(a - a.max(1, keepdim=True).values)
    beta = [None] * (t_len + 1)
    beta[t_len] = sc.new_zeros(n, n_states)
    for t in range(t_len - 1, -1, -1):
        # the transitions of step t + 1 that leave each state
        b = torch.logsumexp(sc[t][:, inv_s, inv_j] + beta[t + 1][:, inv_s], -1)
        beta[t] = b - b.max(1, keepdim=True).values
    post = []
    for t in range(t_len):
        u = alpha[t][:, src] + sc[t] + beta[t + 1][:, :, None]
        z = torch.logsumexp(u.reshape(n, -1), 1)[:, None, None]
        post.append(torch.exp(u - z))
    return torch.stack(post)


def viterbi(logp, state_len: int):
    """Scores [T, N, S, 5] -> (columns [N, T] of the best path, its
    states' columns' scores' positions as (state [N, T]))."""
    import torch

    t_len, n, n_states, _ = logp.shape
    src = sources(state_len)[0].to(logp.device)
    v = logp.new_zeros(n, n_states)
    back = []
    for t in range(t_len):
        cand = (v - v.max(1, keepdim=True).values)[:, src] + logp[t]
        v, j = cand.max(-1)                     # the first of equal values
        back.append(j)
    rows = torch.arange(n, device=logp.device)
    s = v.argmax(1)
    cols = torch.empty(n, t_len, dtype=torch.long, device=logp.device)
    states = torch.empty(n, t_len, dtype=torch.long, device=logp.device)
    for t in range(t_len - 1, -1, -1):
        j = back[t][rows, s]
        cols[:, t] = j
        states[:, t] = s
        s = src[s, j]
    return cols, states


def chunk_labels(ops: Ops, state: dict, cfg: dict, chunks, quality: bool):
    """Chunks [N, chunksize] -> (labels [N, T] u8, quality chars [N, T] u8
    or None), numpy."""
    import torch

    post = posteriors(scores(ops, state, cfg, chunks), cfg["state_len"])
    cols, states = viterbi(torch.log(post + 1e-8), cfg["state_len"])
    labels = cols.to(torch.uint8).cpu().numpy()
    if not quality:
        return labels, None
    t_len, n = post.shape[:2]
    p = post[torch.arange(t_len)[None, :].to(post.device),
             torch.arange(n)[:, None].to(post.device), states, cols]
    q = torch.log1p(-p.clamp(max=1.0)) * (-10.0 / math.log(10.0))
    q = torch.round(q).clamp(1.0, 50.0) + 33
    return labels, q.to(torch.uint8).cpu().numpy()


def basecall_reads(state: dict, cfg: dict, signals: list, device="cpu",
                   precision: str = "f32", quality: bool = False,
                   block: int = 256) -> list:
    """What the mode writes for each raw int16 signal: (read, quality
    string or None), or (None, None) where the trimmed read is empty.
    Chunks run in blocks of ``block``."""
    import torch

    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        ops = Ops(precision)
        w = {k: v.to(device=device, dtype=torch.float32) for k, v in state.items()}
        pieces = [chunk(normalise(s), cfg["chunksize"], cfg["overlap"])
                  for s in signals]
        allc = np.concatenate([c for c, _ in pieces])
        labels, quals = [], []
        with torch.no_grad():
            for i in range(0, len(allc), block):
                x = torch.from_numpy(allc[i : i + block]).to(device)
                lab, q = chunk_labels(ops, w, cfg, x, quality)
                labels.append(lab)
                quals.append(q)
        labels = np.concatenate(labels)
        quals = np.concatenate(quals) if quality else None
        out, k = [], 0
        for c, stub in pieces:
            lab = stitch(list(labels[k : k + len(c)]), stub, cfg)
            moves = np.flatnonzero(lab)
            seq = LABELS[lab[moves]].tobytes().decode()[13:-12]
            qual = None
            if quality:
                qual = stitch(list(quals[k : k + len(c)]), stub, cfg)
                qual = qual[moves].tobytes().decode()[13:-12]
            k += len(c)
            out.append((seq, qual) if seq else (None, None))
        return out
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
