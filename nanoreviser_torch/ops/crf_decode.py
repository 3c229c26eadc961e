"""CRF decode of Bonito's CTC-CRF move scores: per chunk, the labels of
the Viterbi path over the forward-backward posteriors' logs, and the
quality of each step's move.

No TPU kernel corresponds (the JAX package has no basecaller); the CUDA
kernel is ``csrc/crf_decode.cu`` (its header gives the recursions), the
plain version ``crf_decode_plain`` below, which the CPU path runs and
which the kernel follows step for step.

Input: move scores ``[T, N, S * 4]`` (``models.crf.CrfEncoder``; column
``s * 4 + r`` the move into state s that emits base r, ``S = 4 **
state_len``); the stay in a state scores ``blank``. Output: ``labels``
u8 ``[N, T]`` (0 the stay, which emits nothing; 1 + r a move emitting
base r of ``N A C G T``'s A-T) and, with ``quality``, u8 ``[N, T]``: the
fastq character of the chosen move's posterior p, ``33 + clamp(rint(-10
log10(1 - p)), 1, 50)``.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import build

CRF_DECODE = build.Kernel("crf_decode", "crf_decode", "none (no TPU kernel)")
Q_SCALE = -10.0 / math.log(10.0)


def tables(state_len: int, device=None):
    """(``prev`` [S, 5]: the state column j of state s comes from (j = 0 the
    stay, 1 + r the move emitting r); ``succ_s``, ``succ_j`` [S, 5]: the 5
    (state, column) pairs that leave state p: its stay, then the moves into
    4 (p mod S/4) + q, q < 4, which all emit p // (S/4))."""
    n = 4 ** state_len
    hi = n // 4
    s = torch.arange(n, device=device)
    prev = torch.stack([s] + [s // 4 + r * hi for r in range(4)], 1)
    succ_s = torch.stack([s] + [4 * (s % hi) + q for q in range(4)], 1)
    succ_j = torch.stack([torch.zeros_like(s)] + [1 + s // hi] * 4, 1)
    return prev, succ_s, succ_j


def qual_chars(p: torch.Tensor) -> torch.Tensor:
    q = torch.round(torch.log1p(-p.clamp(max=1.0)) * Q_SCALE).clamp(1.0, 50.0)
    return (q + 33).to(torch.uint8)


def _scores5(scores: torch.Tensor, blank: float, state_len: int):
    t_len, n, c = scores.shape
    n_states = 4 ** state_len
    if c != 4 * n_states:
        raise ValueError(f"scores have {c} columns, state_len {state_len} "
                         f"needs {4 * n_states}")
    stay = torch.full((t_len, n, n_states, 1), float(blank),
                      device=scores.device)
    return torch.cat([stay, scores.float().reshape(t_len, n, n_states, 4)], -1)


def crf_posteriors_plain(scores: torch.Tensor, blank: float,
                         state_len: int) -> torch.Tensor:
    """The posterior of every step's transitions, [T, N, S, 5] (column 0
    the stay, 1 + r the move from ``prev``), in float32: the backward and
    forward recursions of the kernel, each step's betas and alphas less
    their largest value, each step's posteriors normalised over the step."""
    m = _scores5(scores, blank, state_len)
    t_len, n, n_states, _ = m.shape
    prev, succ_s, succ_j = tables(state_len, scores.device)
    betas = torch.zeros(t_len + 1, n, n_states, device=scores.device)
    b = betas[t_len]
    for t in range(t_len, 0, -1):
        b = torch.logsumexp(m[t - 1][:, succ_s, succ_j] + b[:, succ_s], -1)
        b = b - b.max(1, keepdim=True).values
        betas[t - 1] = b
    post = torch.empty_like(m)
    a = torch.zeros(n, n_states, device=scores.device)
    for t in range(1, t_len + 1):
        am = a[:, prev] + m[t - 1]
        u = am + betas[t][:, :, None]
        post[t - 1] = torch.exp(
            u - torch.logsumexp(u.reshape(n, -1), 1)[:, None, None])
        a = torch.logsumexp(am, -1)
        a = a - a.max(1, keepdim=True).values
    return post


def crf_decode_plain(scores: torch.Tensor, blank: float, state_len: int,
                     quality: bool = False):
    """Plain PyTorch version, in float32 on the scores' device: the Viterbi
    path over ``log(posterior + 1e-8)`` (each step's scores less the last
    step's largest value; ties to the lowest column, and to the lowest end
    state), traced back."""
    post = crf_posteriors_plain(scores, blank, state_len)
    t_len, n, n_states, _ = post.shape
    dev = scores.device
    prev = tables(state_len, dev)[0]
    logp = torch.log(post + 1e-8)
    v = torch.zeros(n, n_states, device=dev)
    bp = torch.empty(t_len, n, n_states, dtype=torch.long, device=dev)
    for t in range(t_len):
        cand = (v - v.max(1, keepdim=True).values)[:, prev] + logp[t]
        v, bp[t] = cand.max(-1)
    s = v.argmax(1)
    rows = torch.arange(n, device=dev)
    labels = torch.empty(n, t_len, dtype=torch.uint8, device=dev)
    quals = torch.empty(n, t_len, dtype=torch.uint8, device=dev) if quality else None
    for t in range(t_len - 1, -1, -1):
        j = bp[t, rows, s]
        labels[:, t] = j.to(torch.uint8)
        if quality:
            quals[:, t] = qual_chars(post[t, rows, s, j])
        s = prev[s, j]
    return labels, quals


def crf_decode(scores: torch.Tensor, blank: float, state_len: int,
               quality: bool = False):
    """(labels, quals or None). CPU tensors take the plain version; CUDA
    tensors (fp16 scores) launch the kernel: one block of max(32, S)
    threads per chunk, with f32 [N, T + 1, S] and u8 [N, T, S] (two with
    ``quality``) of scratch from the caching allocator."""
    if scores.device.type == "cpu":
        return crf_decode_plain(scores, blank, state_len, quality)
    build.require_cuda(scores)
    t_len, n, c = scores.shape
    n_states = 4 ** state_len
    if not 1 <= state_len <= 5:
        raise ValueError(f"the decode kernel takes state_len 1-5, not {state_len}")
    if scores.dtype != torch.float16 or not scores.is_contiguous():
        raise ValueError(f"scores must be contiguous float16, got {scores.dtype}")
    if c != 4 * n_states:
        raise ValueError(f"scores have {c} columns, state_len {state_len} "
                         f"needs {4 * n_states}")
    dev = scores.device
    labels = torch.empty(n, t_len, dtype=torch.uint8, device=dev)
    quals = (torch.empty(n, t_len, dtype=torch.uint8, device=dev)
             if quality else None)
    if n == 0 or t_len == 0:
        return labels, quals
    betas = torch.empty(n, t_len + 1, n_states, dtype=torch.float32, device=dev)
    bp = torch.empty(n, t_len, n_states, dtype=torch.uint8, device=dev)
    qs = (torch.empty(n, t_len, n_states, dtype=torch.uint8, device=dev)
          if quality else None)
    none = build.c_void_p(None)
    CRF_DECODE.launch(
        "nr_crf_decode", build.c_ptr(scores), build.c_int(t_len),
        build.c_int(n), build.c_int(state_len), ctypes.c_float(blank),
        build.c_ptr(betas), build.c_ptr(bp),
        build.c_ptr(qs) if quality else none, build.c_ptr(labels),
        build.c_ptr(quals) if quality else none, build.stream_of(dev))
    return labels, quals
