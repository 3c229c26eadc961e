"""Banded affine-gap glocal alignment: the training labeller's aligner.

Counterpart of ``nanoreviser_tpu/align/sw.py``, which fills the role the
reference gives the GraphMap mapper (alignutils.py:30-63):

1. k-mer seeding (host, numpy): locate the read on the genome and pick the
   best diagonal and strand from exact-match seed votes;
2. banded affine-gap GLOCAL alignment (read global, target local) of the
   read against the seeded genome window. Each query row updates its whole
   diagonal band at once; the in-row left-gap chain
   F(k) = max_{k'<k} H(k') + open + (k-k')*ext is an exact prefix max
   (valid because open <= ext makes re-opening inside a gap never
   optimal). Ties go DIAG, then UP, then LEFT;
3. moves are 2 bits each, packed 4 to a byte, and walked back on the host.

``align_banded`` runs the DP on one of two backends with identical
results (ops, j_start and score; all score arithmetic is f32 in the JAX
package's operation order):

* ``"auto"`` / ``"native"``: ``nr_banded_sw`` of the port's host library
  (C++, the GIL released, so labelling threads scale). A library that does
  not build raises; there is no fallback.
* ``"torch"``: ``banded_sw_torch``, the JAX package's row scan
  (``_banded_align_emit``) as torch ops on a given device, one row of the
  band per step; only when asked for by name.

The output is per-column (read, ref, map) strings in the shape of
``align.sam.parse_sam_record``, so the label pipeline (``align.labels``) is
shared with the GraphMap path.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

NEG_INF = -1.0e9

DIAG, UP, LEFT = 0, 1, 2  # 2-bit move codes

_BASE_CODE = np.full(256, 4, np.int8)
for _i, _b in enumerate("ACGT"):
    _BASE_CODE[ord(_b)] = _i
_COMP_CODE = np.array([3, 2, 1, 0, 4], np.int8)


def encode_seq(seq: str) -> np.ndarray:
    return _BASE_CODE[np.frombuffer(seq.encode("ascii"), np.uint8)]


def revcomp_codes(codes: np.ndarray) -> np.ndarray:
    return _COMP_CODE[codes[::-1]]


# ------------------------------------------------------------------- seeding


@dataclass
class SeedHit:
    chrom: str
    strand: str
    t_start: int
    t_end: int
    votes: int
    margin_lead: int = 0      # expected unaligned target prefix in the window
    margin_tail: int = 0      # expected unaligned target suffix


def _rolling_kmers(codes: np.ndarray, k: int) -> np.ndarray:
    """The 2-bit code of every k-mer starting at each position; -1 where the
    k-mer holds an N."""
    if len(codes) < k:
        return np.zeros(0, np.int64)
    acc = np.zeros(len(codes) - k + 1, np.int64)
    for i in range(k):
        acc = acc * 4 + codes[i : len(codes) - k + 1 + i]
    win = np.lib.stride_tricks.sliding_window_view(codes == 4, k)
    return np.where(win.any(axis=1), -1, acc)


class KmerIndex:
    """Host-side exact-match k-mer index over the genome (numpy).

    Memory: 8 bytes per indexed position (int32 k-mer code for k <= 15 +
    int32/int64 position). For genomes over ~50 Mbp, positions are sampled
    every ``stride`` bases (seed votes only need a sparse diagonal
    consensus), keeping a human-genome index ~6 GB instead of the ~50 GB a
    dense int64 table would need.
    """

    def __init__(self, genome: dict[str, str], k: int = 15,
                 stride: int | None = None):
        if k > 15:
            raise ValueError("k must be <= 15 (int32 k-mer codes)")
        total = sum(len(s) for s in genome.values())
        if stride is None:
            stride = 1 if total < 50_000_000 else 4
        self.k = k
        self.stride = stride
        self._tables = {}
        for chrom, seq in genome.items():
            codes = encode_seq(seq)
            kmers = _rolling_kmers(codes, k)
            pos = np.arange(0, len(kmers), stride)
            sampled = kmers[pos].astype(np.int32)
            order = np.argsort(sampled, kind="stable")
            pos_dtype = np.int32 if len(codes) < 2**31 else np.int64
            self._tables[chrom] = (
                sampled[order], pos[order].astype(pos_dtype), codes
            )

    def seed(
        self, read_codes: np.ndarray, margin: int = 400, sample_stride: int = 11
    ) -> SeedHit | None:
        k = self.k
        best = None
        for strand, q in (("+", read_codes), ("-", revcomp_codes(read_codes))):
            q_kmers = _rolling_kmers(q, k)
            sample = np.arange(0, len(q_kmers), sample_stride)
            q_sample = q_kmers[sample].astype(np.int32)
            for chrom, (skmers, spos, codes) in self._tables.items():
                lo = np.searchsorted(skmers, q_sample, side="left")
                hi = np.searchsorted(skmers, q_sample, side="right")
                n_hits = hi - lo
                ok = (q_sample >= 0) & (n_hits > 0) & (n_hits <= 8)
                if not ok.any():
                    continue
                diags = np.concatenate(
                    [
                        spos[l:h] - qi
                        for qi, l, h in zip(sample[ok], lo[ok], hi[ok])
                    ]
                )
                uniq, counts = np.unique(diags // 64, return_counts=True)
                top = int(counts.argmax())
                votes = int(counts[top])
                if best is None or votes > best[0]:
                    diag = int(uniq[top] * 64)
                    t_start = max(diag - margin, 0)
                    t_end = min(diag + len(q) + margin, len(codes))
                    best = (
                        votes,
                        SeedHit(
                            chrom, strand, t_start, t_end, votes,
                            margin_lead=diag - t_start,
                            margin_tail=max(t_end - (diag + len(q)), 0),
                        ),
                    )
        return best[1] if best else None


# ------------------------------------------------------------------ banded DP

_ROW_CHUNK = 4096   # rows whose substitution scores are built at once


def _band_line(m: int, n: int, t_lead: int, t_tail: int):
    """j0(i): the target column at the band's centre on row i, interpolated
    from the expected first aligned column (t_lead) to the expected last
    (n - t_tail) across the read."""
    span = max(n - t_lead - t_tail, 1)
    return lambda i: t_lead + (span * i) // max(m, 1)


def banded_sw_torch(
    q_codes: np.ndarray,
    t_codes: np.ndarray,
    band: int = 512,
    t_lead: int = 0,
    t_tail: int = 0,
    match: float = 2.0,
    mismatch: float = -3.0,
    gap_open: float = -5.0,
    gap_extend: float = -2.0,
    device: str | torch.device = "cuda",
) -> tuple[np.ndarray, int, float]:
    """(ops, j_start, score): the banded DP as torch ops on ``device``, then
    the host traceback. Same results as ``native.banded_sw_native``.

    The row loop enqueues its work without reading anything back; the
    packed moves, the end column and the score come to the host once, at
    the end. Band cells outside the target score a substitution against
    the target clamped into its 256-padded range, as the JAX scan does."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' but no CUDA device is available; "
                           "pass device='cpu'")
    q = np.ascontiguousarray(q_codes, np.int8)
    t = np.ascontiguousarray(t_codes, np.int8)
    m, n = len(q), len(t)
    if m < 1 or n < 1 or band < 4 or band % 4:
        raise ValueError(f"banded_sw_torch: m={m}, n={n}, band={band}")
    half = band // 2
    j0 = _band_line(m, n, t_lead, t_tail)
    rows_j0 = np.array([j0(i) for i in range(m)], np.int64)

    # the target padded as the JAX scan pads it (code 4 up to a multiple of
    # 256), then extended by its end values so that a clamped index is a
    # plain slice
    n_pad = -(-n // 256) * 256
    t_p = np.full(n_pad, 4, np.int8)
    t_p[:n] = t
    lo = half
    hi = max(int(rows_j0[-1]) + half - n_pad, 0) + 1
    t_ext = torch.from_numpy(np.concatenate(
        [np.full(lo, t_p[0], np.int8), t_p, np.full(hi, t_p[-1], np.int8)])).to(device)
    q_dev = torch.from_numpy(q).to(device)
    ks = torch.arange(band, device=device)
    ks_ext = ks.to(torch.float32) * gap_extend           # exact small ints
    open_ks = gap_open + ks_ext
    neg = torch.tensor(NEG_INF, dtype=torch.float32, device=device)
    j0_dev = torch.from_numpy(rows_j0).to(device)

    def row_inputs(r0: int, r1: int):
        """(sub, valid) [r1 - r0, band] for rows r0..r1-1."""
        j = j0_dev[r0:r1, None] + ks[None, :] - half
        tj = t_ext[torch.clamp(j, 0, n_pad - 1) + lo]
        sub = torch.where(tj == q_dev[r0:r1, None],
                          torch.tensor(match, dtype=torch.float32, device=device),
                          torch.tensor(mismatch, dtype=torch.float32, device=device))
        return sub, (j >= 0) & (j < n)

    def padded(x):
        return torch.nn.functional.pad(x, (band, band), value=NEG_INF)

    def shifted(xp, s: int):
        """x[k + s] inside the band, NEG_INF outside (xp: x padded by band)."""
        s = min(max(s, -band), band)
        return xp[band + s : 2 * band + s]

    sub, valid = row_inputs(0, min(m, _ROW_CHUNK))
    h = torch.where(valid[0], sub[0], neg)        # row 0: free leading gap
    hp, ep = padded(h), torch.full((3 * band,), NEG_INF, device=device)
    moves = [torch.zeros(band, dtype=torch.uint8, device=device)]
    for i in range(1, m):
        c = i % _ROW_CHUNK
        if c == 0:
            sub, valid = row_inputs(i, min(m, i + _ROW_CHUNK))
        shift = int(rows_j0[i] - rows_j0[i - 1])
        diag_score = shifted(hp, shift - 1) + sub[c]
        e = torch.maximum(shifted(hp, shift) + gap_open,
                          shifted(ep, shift) + gap_extend)
        h_nf = torch.where(valid[c], torch.maximum(diag_score, e), neg)
        run = torch.cummax(h_nf - ks_ext, dim=0).values
        p_excl = torch.nn.functional.pad(run[:-1], (1, 0), value=NEG_INF)
        h = torch.where(valid[c], torch.maximum(h_nf, open_ks + p_excl), neg)
        moves.append(torch.where(h == diag_score, DIAG,
                                 torch.where(h == e, UP, LEFT)).to(torch.uint8))
        hp, ep = padded(h), padded(e)

    mv = torch.stack(moves).view(m, band // 4, 4).to(torch.int32)
    packed = (mv[..., 0] | (mv[..., 1] << 2) | (mv[..., 2] << 4)
              | (mv[..., 3] << 6)).to(torch.uint8)
    k_end = torch.argmax(h)                      # the first maximum
    score = h[k_end]
    packed, k_end, score = packed.cpu().numpy(), int(k_end), float(score)
    ops, j_start = _traceback_host(packed, m, n, band, k_end, t_lead, t_tail)
    return ops, j_start, score


def _traceback_host(
    packed: np.ndarray, m: int, n: int, band: int, k_end: int,
    t_lead: int = 0, t_tail: int = 0,
) -> tuple[np.ndarray, int]:
    """Walk packed moves from (m-1, k_end); returns (ops fwd order, j_start)."""
    half = band // 2
    j0 = _band_line(m, n, t_lead, t_tail)

    def move_at(i, k):
        byte = packed[i, k >> 2]
        return (byte >> ((k & 3) * 2)) & 3

    ops = []
    i = m - 1
    j = j0(i) + k_end - half
    while i > 0:
        k = j - j0(i) + half
        if k < 0 or k >= band:
            while i > 0:
                ops.append(DIAG)
                i -= 1
                j -= 1
            break
        mv = int(move_at(i, k))
        if mv == DIAG:
            ops.append(DIAG)
            i -= 1
            j -= 1
        elif mv == UP:
            ops.append(UP)
            i -= 1
        else:
            ops.append(LEFT)
            j -= 1
    ops.append(DIAG)  # row 0 consumes (q[0], t[j])
    return np.asarray(ops[::-1], np.int8), j


# ---------------------------------------------------------------- public API


@dataclass
class AlignmentResult:
    read_vals: str
    ref_vals: str
    map_vals: str
    strand: str
    chrom: str
    genome_start: int
    score: float
    start_clipped_bases: int = 0   # read bases clipped, ORIGINAL orientation
    end_clipped_bases: int = 0


DEFAULT_SCORES = dict(match=2.0, mismatch=-3.0, gap_open=-5.0, gap_extend=-2.0)


def align_banded(
    read_seq: str,
    target_seq: str,
    band: int = 512,
    t_lead: int = 0,
    t_tail: int = 0,
    backend: str = "auto",
    device: str | torch.device = "cuda",
    **score_overrides,
) -> tuple[np.ndarray, int, float]:
    """Glocal banded alignment. Returns (ops, j_start, score).

    t_lead/t_tail: expected unaligned target overhangs (the seed margins);
    they centre the band on the true alignment line.

    backend: "auto" and "native" run the port's host library (a failed
    build raises); "torch" runs ``banded_sw_torch`` on ``device`` (used by
    that backend only).
    """
    scores = dict(DEFAULT_SCORES, **score_overrides)
    q = encode_seq(read_seq)
    t = encode_seq(target_seq)
    if backend in ("auto", "native"):
        from .. import native

        return native.banded_sw_native(q, t, band=band, t_lead=t_lead,
                                       t_tail=t_tail, **scores)
    if backend == "torch":
        return banded_sw_torch(q, t, band=band, t_lead=t_lead, t_tail=t_tail,
                               device=device, **scores)
    raise ValueError(f"unknown backend {backend!r}")


def clip_ops(
    ops: np.ndarray,
    read_seq: str,
    target_seq: str,
    j_start: int,
    q_start: int = 0,
    **score_overrides,
) -> tuple[np.ndarray, int, int, int, int]:
    """Soft-clip garbage alignment ends (GraphMap emits S/H clips for
    unalignable read ends like adapters, reference alignutils.py:80-94; a
    glocal DP instead forces them through as noise columns).

    Kadane-style maximal-scoring run over per-column scores: keep the
    contiguous op segment with the highest score sum, drop the rest as
    clips. Returns (ops', j_start', q_start', head_read_clip,
    tail_read_clip) where the clips count READ bases removed.
    """
    if len(ops) == 0:
        return ops, j_start, q_start, 0, 0
    scores = dict(DEFAULT_SCORES, **score_overrides)
    qi, ti = q_start, j_start
    col_scores = np.empty(len(ops), np.float64)
    prev = -1
    for idx, op in enumerate(ops):
        if op == DIAG:
            col_scores[idx] = (
                scores["match"]
                if read_seq[qi] == target_seq[ti]
                else scores["mismatch"]
            )
            qi += 1
            ti += 1
        else:
            col_scores[idx] = (
                scores["gap_extend"] if op == prev else scores["gap_open"]
            )
            qi += op == UP
            ti += op == LEFT
        prev = op

    cum = np.concatenate([[0.0], np.cumsum(col_scores)])
    run_min = np.minimum.accumulate(cum[:-1])
    gains = cum[1:] - run_min
    b = int(np.argmax(gains)) + 1                      # exclusive end
    a = int(np.argmin(cum[:b]))                       # inclusive start
    reads_consumed = (np.asarray(ops) != LEFT).astype(np.int64)
    target_consumed = (np.asarray(ops) != UP).astype(np.int64)
    head_clip = int(reads_consumed[:a].sum())
    tail_clip = int(reads_consumed[b:].sum())
    j_start2 = j_start + int(target_consumed[:a].sum())
    return ops[a:b], j_start2, q_start + head_clip, head_clip, tail_clip


def columns_from_ops(
    ops: np.ndarray, read_seq: str, target_seq: str, t_offset: int,
    q_offset: int = 0,
) -> tuple[str, str, str]:
    """(read_vals, ref_vals, map_vals) columns from move codes."""
    read_parts: list[str] = []
    ref_parts: list[str] = []
    map_parts: list[str] = []
    qi, ti = q_offset, t_offset
    for op in ops:
        if op == DIAG:
            a, b = read_seq[qi], target_seq[ti]
            read_parts.append(a)
            ref_parts.append(b)
            map_parts.append("M" if a == b else "X")
            qi += 1
            ti += 1
        elif op == UP:
            read_parts.append(read_seq[qi])
            ref_parts.append("-")
            map_parts.append("I")
            qi += 1
        else:
            read_parts.append("-")
            ref_parts.append(target_seq[ti])
            map_parts.append("D")
            ti += 1
    return "".join(read_parts), "".join(ref_parts), "".join(map_parts)


def align_read_to_genome(
    read_seq: str,
    index: KmerIndex,
    genome: dict[str, str],
    band: int = 512,
    clip_ends: bool = True,
    **score_overrides,
) -> AlignmentResult | None:
    """Full seed + banded-extend pipeline (the GraphMap-equivalent call).

    Matches the reference's parse_sam_record output conventions
    (input_handeler.py:60-160): columns are in ORIGINAL-read orientation
    (for '-' hits the target is viewed reverse-complemented), and
    unalignable read ends are soft-clipped with the clip counts reported
    (GraphMap S/H clips, reference alignutils.py:80-94) so downstream
    fix_raw_starts_for_clipped_bases can trim the signal correspondingly.
    """
    from .sam import rev_comp

    codes = encode_seq(read_seq)
    hit = index.seed(codes)
    if hit is None:
        return None
    target = genome[hit.chrom][hit.t_start : hit.t_end]
    q_seq = read_seq if hit.strand == "+" else rev_comp(read_seq)
    t_lead = hit.margin_lead if hit.strand == "+" else hit.margin_tail
    t_tail = hit.margin_tail if hit.strand == "+" else hit.margin_lead
    ops, j_start, score = align_banded(
        q_seq, target, band=band, t_lead=t_lead, t_tail=t_tail,
        **score_overrides,
    )
    q_start = 0
    head_clip = tail_clip = 0
    if clip_ends:
        ops, j_start, q_start, head_clip, tail_clip = clip_ops(
            ops, q_seq, target, j_start, **score_overrides
        )
    if len(ops) < 8:
        # all-garbage alignment: clipping left (at most) a token segment —
        # treat the read as unmapped rather than emit meaningless labels
        return None
    read_vals, ref_vals, map_vals = columns_from_ops(
        ops, q_seq, target, j_start, q_offset=q_start
    )
    if hit.strand == "-":
        # reference convention: columns in original-read orientation
        read_vals = rev_comp(read_vals)
        ref_vals = rev_comp(ref_vals)
        map_vals = map_vals[::-1]
        head_clip, tail_clip = tail_clip, head_clip
    return AlignmentResult(
        read_vals=read_vals,
        ref_vals=ref_vals,
        map_vals=map_vals,
        strand=hit.strand,
        chrom=hit.chrom,
        genome_start=hit.t_start + j_start,
        score=score,
        start_clipped_bases=head_clip,
        end_clipped_bases=tail_clip,
    )
