"""Wire format v2: the byte-packed batch upload, and its decode in torch.

The encoding side (tables, ``validate_chain_bounds``, ``encode_read``,
``pack_codes2``, ``pack_read_tables``) is a numpy copy of
``nanoreviser_tpu/infer/wire.py:61-221`` and
``nanoreviser_tpu/ops/window_gather.py:280``: the bytes of a finalized batch
are identical in both packages, so one batch can feed either.

* **signal**: 8-bit zig-zag deltas of the compacted int16 signal with an
  escape table (index, int32 delta) for the rest; decode = scatter +
  integer cumsum, exact by construction.
* **features**: only the 4 underivable f16 columns ship. Base color comes
  from 2-bit base codes via a 4-entry f16 table; duration from the pos0
  deltas via a 256-entry f16 table, with an escape list for rows where the
  compacted delta differs from the true duration.
* **row meta**: pos0 ships as u8 row deltas and is rebuilt by cumsum; vlen
  defaults to 50 with an escape list; read_id comes from the per-read
  first-row offsets.

``decode_wire`` rebuilds, with torch ops on the batch's device, the forward
signal, per-row ``pos0``/``vlen``/``read_id``, the per-read f32
``shift``/``scale`` and the [n_rows, 6] f32 features. It is bit-exact with
the JAX package's decode (which packs the same values into its TPU block
meta).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..signal.host_prep import CompactRead

ESC = 255                    # u8 escape marker (signal stream)
DROP = np.int32(2**30)       # scatter sentinel: always out of range -> dropped
MAX_IN_READ_POS_DELTA = 50   # guaranteed by compaction; validated per read
MAX_BOUNDARY_DELTA = 75      # read-boundary pos0 delta bound (vlen 50 + left
                             # pad 25 for compactor output; the batch's
                             # signal head for the first row)

# Batch geometry shared with the JAX package, so tiers and finalized
# batches are byte-identical in both: rows are counted in blocks of
# ROW_BLOCK, the signal buffer is padded by DMA_LEN and rounded to ALIGN, and
# the per-read tables hold R_CAP entries.
ROW_BLOCK = 128
ALIGN = 1024
DMA_LEN = 8192 + ALIGN
R_CAP = 256

# exact f64 -> f16 single-rounding tables, shared by the host escape checker
# and the device decode: duration feature = f16(f64(d) * 0.1), d in [0, 255];
# color feature = f16(BASE_COLOR_TABLE[base] * (1/300)) for code order AGTC
DUR_TABLE_F16 = (np.arange(256, dtype=np.float64) * 0.1).astype(np.float16)
_CODE_BASES = b"AGTC"
COLOR_TABLE_F16 = (
    np.array([250.0, 180.0, 100.0, 30.0], np.float64) * (1.0 / 300.0)
).astype(np.float16)
CODE_OF_BASE = np.zeros(256, np.uint8)
for _i, _b in enumerate(_CODE_BASES):
    CODE_OF_BASE[_b] = _i
_IS_ACGT = np.zeros(256, bool)
for _b in b"ACGT":
    _IS_ACGT[_b] = True


class WireEncodeError(ValueError):
    """Read violates a wire-format invariant (caller degrades the read)."""


def validate_chain_bounds(pos0_first: int, pos0_last: int, m: int) -> None:
    """Reject reads whose head/tail would impose an illegal boundary delta
    on a batch neighbour, so a bad read degrades itself at encode time.
    Compactor output always satisfies both: pos0[0] = -left0 in [-25, 0];
    m - pos0[-1] = vlen_last + left_last in [26, 75]."""
    if not -25 <= pos0_first <= 0:
        raise WireEncodeError(
            f"pos0[0] = {pos0_first} outside [-25, 0] "
            f"(window head inconsistent with compaction)")
    slack = m - pos0_last
    if not 25 <= slack <= MAX_BOUNDARY_DELTA:
        raise WireEncodeError(
            f"trailing signal slack {slack} outside "
            f"[25, {MAX_BOUNDARY_DELTA}] (signal does not end at the last "
            f"window; block span budget unprovable for a successor read)")


@dataclass
class WireRead:
    """One read, encoded for the batch upload."""

    bases: str
    sig8: np.ndarray           # [M] u8 zig-zag deltas; [0] is ESC (the first
                               #     sample's delta is chained at assembly)
    sig_esc_idx: np.ndarray    # [K] int32 local sample index (excludes 0)
    sig_esc_delta: np.ndarray  # [K] int32 true delta
    posd: np.ndarray           # [N] u8 pos0 row deltas; [0] is a placeholder
    vlen_esc_idx: np.ndarray   # [Kv] int32 local row (vlen != 50)
    vlen_esc_val: np.ndarray   # [Kv] int32
    dur_esc_idx: np.ndarray    # [Kd] int32 local row
    dur_esc_f32: np.ndarray    # [Kd] f32 (exact widening of the f16 feature)
    col_esc_idx: np.ndarray    # [Kc] int32 local row (non-ACGT base -> 0.0)
    codes: np.ndarray          # [N] u8 2-bit base code (packed 4/byte later)
    evf: np.ndarray            # [N, 4] f16: ev_mean/shift, ev_std/scale,
                               #             ab_mean, ab_std
    first_val: int             # csig[0] (assembly chains the first delta)
    last_val: int              # csig[-1] (next read chains against it)
    pos0_first: int            # c.pos0[0] (assembly writes posd[r0])
    pos0_last: int             # c.pos0[-1]
    shift: float
    scale: float

    @property
    def n_bases(self) -> int:
        return len(self.posd)

    @property
    def n_samples(self) -> int:
        return len(self.sig8)


def encode_read(c: CompactRead, out: tuple | None = None) -> WireRead:
    """CompactRead -> WireRead (vectorized numpy).

    ``out``: (sig8, posd, evf, codes) arrays of at least M / N / N / N rows
    to fill in place (a prep slot); the escape arrays are always new."""
    csig = c.csig
    pos0 = c.pos0.astype(np.int64)
    n = c.n_bases
    m = c.n_samples
    validate_chain_bounds(int(pos0[0]), int(pos0[-1]), m)
    if out is not None:
        sig8, posd, evf, codes = out[0][:m], out[1][:n], out[2][:n], out[3][:n]
    else:
        sig8 = np.empty(m, np.uint8)
        posd = np.empty(n, np.uint8)
        evf = np.empty((n, 4), np.float16)
        codes = np.empty(n, np.uint8)

    # --- signal: zig-zag deltas with escapes -------------------------------
    d = np.diff(csig.astype(np.int32))
    z = (d << 1) ^ (d >> 31)
    esc = z >= ESC
    sig8[0] = ESC
    np.copyto(sig8[1:], np.where(esc, ESC, z).astype(np.uint8))
    sig_esc_idx = (np.flatnonzero(esc) + 1).astype(np.int32)
    sig_esc_delta = d[sig_esc_idx - 1].astype(np.int32)

    # --- pos0 row deltas ---------------------------------------------------
    pd = np.diff(pos0)
    if pd.size and (pd.min() < 0 or pd.max() > MAX_IN_READ_POS_DELTA):
        raise WireEncodeError(
            f"pos0 delta outside [0, {MAX_IN_READ_POS_DELTA}] "
            f"(pathological segmentation; span budget unprovable)")
    posd[0] = 0
    np.copyto(posd[1:], pd.astype(np.uint8))

    # --- vlen escapes ------------------------------------------------------
    vmask = c.vlen != 50
    vlen_esc_idx = np.flatnonzero(vmask).astype(np.int32)
    vlen_esc_val = c.vlen[vmask].astype(np.int32)

    # --- features ----------------------------------------------------------
    bcodes = np.frombuffer(c.bases.encode("ascii"), np.uint8)
    np.copyto(codes, CODE_OF_BASE[bcodes])
    col_esc_idx = np.flatnonzero(~_IS_ACGT[bcodes]).astype(np.int32)
    np.copyto(evf, c.feats[:, [1, 2, 4, 5]])
    true_dur = c.feats[:, 3]
    derived = DUR_TABLE_F16[np.clip(pd, 0, 255)]
    mism = np.flatnonzero(derived != true_dur[:-1])
    dur_esc_idx = np.concatenate([mism, [n - 1]]).astype(np.int32)
    dur_esc_f32 = true_dur[dur_esc_idx].astype(np.float32)

    return WireRead(
        bases=c.bases, sig8=sig8,
        sig_esc_idx=sig_esc_idx, sig_esc_delta=sig_esc_delta,
        posd=posd, vlen_esc_idx=vlen_esc_idx, vlen_esc_val=vlen_esc_val,
        dur_esc_idx=dur_esc_idx, dur_esc_f32=dur_esc_f32,
        col_esc_idx=col_esc_idx, codes=codes, evf=evf,
        first_val=int(csig[0]), last_val=int(csig[-1]),
        pos0_first=int(pos0[0]), pos0_last=int(pos0[-1]),
        shift=c.shift, scale=c.scale,
    )


def pack_codes2(codes: np.ndarray) -> np.ndarray:
    """u8 per-row 2-bit codes -> 4-per-byte packed u8 (len must be %4)."""
    c = codes.reshape(-1, 4).astype(np.uint16)
    return (c[:, 0] | (c[:, 1] << 2) | (c[:, 2] << 4) | (c[:, 3] << 6)).astype(
        np.uint8)


def _f32_to_bf16_bits(x: np.ndarray) -> np.ndarray:
    """Round f32 to bf16 (nearest, ties to even) -> uint16 bit patterns.

    The values here are finite, so no NaN handling is needed."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32).astype(np.uint64)
    u = u + 0x7FFF + ((u >> 16) & 1)
    return (u >> 16).astype(np.uint16)


def _bf16_bits_to_f32(b: np.ndarray) -> np.ndarray:
    return (b.astype(np.uint32) << 16).view(np.float32)


def pack_read_tables(shifts, scales) -> np.ndarray:
    """[6, R_CAP] bf16 bit patterns (uint16): a 3-term split of the per-read
    f32 shift/scale values.

    Rows 0..2 sum (exactly, in f32, as (t0 + t1) + t2) to shift, rows 3..5
    to scale: an f32 mantissa is three bf16 mantissas and each residual is
    exactly representable. Unused lanes read shift 0 / scale 1. The bytes
    equal the JAX package's bfloat16 table."""
    out = np.zeros((6, R_CAP), np.uint16)
    vals = np.zeros((2, R_CAP), np.float32)
    vals[1] = 1.0
    n = len(shifts)
    if n > R_CAP or len(scales) != n:
        raise ValueError(f"{n} reads do not fit the {R_CAP}-entry read table")
    vals[0, :n] = np.asarray(shifts, np.float32)
    vals[1, :n] = np.asarray(scales, np.float32)
    for k, row in enumerate(vals):
        a = _f32_to_bf16_bits(row)
        r1 = row - _bf16_bits_to_f32(a)
        b = _f32_to_bf16_bits(r1)
        c = _f32_to_bf16_bits(r1 - _bf16_bits_to_f32(b))
        out[3 * k + 0] = a
        out[3 * k + 1] = b
        out[3 * k + 2] = c
    return out


# ------------------------------------------------------------ device decode


@dataclass
class DecodedBatch:
    """One batch decoded on its device (all torch tensors)."""

    sig: object        # int16 [s_cap] forward compacted signal
    pos0: object       # int32 [n_rows_g] window gather start per row
    vlen: object       # int32 [n_rows_g] valid window length per row
    read_id: object    # int32 [n_rows_g] index into shift/scale
    shift: object      # f32 [R_CAP] per-read median
    scale: object      # f32 [R_CAP] per-read MAD
    feats: object      # f32 [n_rows, 6] per-row features


def torch_dtype(arr: np.ndarray):
    """The torch dtype ``decode_wire`` reads a finalized array as (the
    uint16 read tables carry bf16 bit patterns)."""
    import torch

    return {np.dtype(np.uint8): torch.uint8, np.dtype(np.uint16): torch.bfloat16,
            np.dtype(np.int32): torch.int32, np.dtype(np.float32): torch.float32,
            np.dtype(np.float16): torch.float16}[arr.dtype]


def wire_to_tensors(packed: dict, device="cpu") -> dict:
    """A finalized batch (numpy arrays) -> tensors on ``device`` as
    ``decode_wire`` takes them."""
    import torch

    return {k: torch.from_numpy(np.ascontiguousarray(a).reshape(-1).view(np.uint8))
            .view(torch_dtype(a)).view(a.shape).to(device)
            for k, a in packed.items()}


def _scatter_drop(dst, idx, val):
    """``dst[idx] = val`` with out-of-range indices dropped (the JAX
    ``.at[].set(mode="drop")``; pad entries hold DROP). Dropped entries
    land in a scratch slot past the end, so no mask is compacted and the
    host never waits for the device (indexed assignment would: on CUDA it
    synchronizes)."""
    import torch

    n = dst.shape[0]
    keep = (idx >= 0) & (idx < n)
    ext = torch.cat([dst, dst.new_zeros(1)])
    ext.scatter_(0, torch.where(keep, idx, n).long(), val)
    return ext[:n]


def wire_tables(device) -> tuple:
    """The f16 color and duration tables, widened to f32, on ``device``.
    A caller that decodes many batches makes them once and passes them to
    ``decode_wire``, which then copies nothing from the host."""
    import torch

    return (torch.from_numpy(COLOR_TABLE_F16.astype(np.float32)).to(device),
            torch.from_numpy(DUR_TABLE_F16.astype(np.float32)).to(device))


def decode_wire(v: dict, *, s_cap: int, n_rows: int, n_rows_g: int,
                tables: tuple | None = None) -> DecodedBatch:
    """Wire buffers (torch tensors on one device) -> DecodedBatch.

    Bit-exact with ``nanoreviser_tpu.infer.wire.decode_wire``: integer
    scatter + cumsum rebuilds the signal and row positions exactly, and the
    f16 table lookups widen to f32 exactly. ``tables`` is ``wire_tables``
    of the batch's device (made here when not given). No operation waits
    for the device."""
    import torch

    dev = v["sig8"].device
    ctab, dtab = tables if tables is not None else wire_tables(dev)
    i32 = torch.int32

    # signal: zig-zag decode + escape scatter + integer cumsum
    z = v["sig8"].to(i32)
    d = (z >> 1) ^ -(z & 1)
    d = torch.where(z == ESC, torch.zeros_like(d), d)
    d = _scatter_drop(d, v["sig_esc_idx"], v["sig_esc_delta"])
    sig = torch.cumsum(d, 0, dtype=i32).to(torch.int16)

    # row positions, valid lengths, read ids
    pos0 = torch.cumsum(v["posd"].to(i32), 0, dtype=i32)
    vlen = torch.full((n_rows_g,), 50, dtype=i32, device=dev)
    vlen = _scatter_drop(vlen, v["vlen_esc_idx"], v["vlen_esc_val"])
    rows = torch.arange(n_rows_g, dtype=i32, device=dev)
    # read_r0 is ascending (pad lanes hold DROP): the number of reads whose
    # first row is <= row, minus one
    read_id = torch.searchsorted(v["read_r0"], rows, right=True).to(i32) - 1
    read_id = read_id.clamp(0, R_CAP - 1)

    # per-read normalizers: (t0 + t1) + t2 of the bf16 split, in f32
    tabs = v["tabs"].to(torch.float32)              # bf16 [6, R_CAP]
    shift = (tabs[0] + tabs[1]) + tabs[2]
    scale = (tabs[3] + tabs[4]) + tabs[5]

    # features: color/duration from exact f16 tables + escapes
    c2 = v["codes2"].to(i32)
    codes = torch.stack(
        [c2 & 3, (c2 >> 2) & 3, (c2 >> 4) & 3, (c2 >> 6) & 3], dim=1
    ).reshape(-1)[:n_rows]
    color = ctab[codes.long()]
    color = _scatter_drop(color, v["col_esc_idx"], 0.0)
    pos0_ext = torch.cat([pos0, pos0[-1:]])
    dnext = (pos0_ext[1 : n_rows + 1] - pos0_ext[:n_rows]).clamp(0, 255)
    dur = dtab[dnext.long()]
    dur = _scatter_drop(dur, v["dur_esc_idx"], v["dur_esc_f32"])
    evf = v["evf"].to(torch.float32)
    feats = torch.stack(
        [color, evf[:, 0], evf[:, 1], dur, evf[:, 2], evf[:, 3]], dim=1)
    return DecodedBatch(sig=sig, pos0=pos0, vlen=vlen, read_id=read_id,
                        shift=shift, scale=scale, feats=feats)
