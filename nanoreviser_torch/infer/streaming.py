"""Streaming reviser engine on one GPU (or, when asked, on the CPU).

Counterpart of ``nanoreviser_tpu/infer/streaming.py``. Reads are
wire-encoded on the host (``infer.wire``), packed into fixed-shape size
tiers, uploaded as one contiguous buffer per batch, and revised by one
device step per batch:

    decode_wire (torch ops)  -> window gather kernel (ops.window_gather)
    -> reviser stack kernel (ops.reviser_kernel: stack_full)
    -> argmax packed as y1*8 + y2 (+ phred qualities of the max prob)

then merged with the original bases on the host (``infer.merge``).

Batch assembly (``_add_read``, ``_pick_tier``, ``_finalize`` and the tier
geometry) is the JAX package's, so a finalized batch is byte-identical in
both packages. The upload/fetch thread pools of the JAX engine become
pinned host buffers, a copy stream and CUDA events: up to
``max_in_flight`` batches overlap packing, upload, compute and download.
The device step only queues work: nothing in it makes the host wait for
the card (``tests/test_torch_cuda.py`` checks it on the card).

``device="cuda"`` (the default) runs the CUDA kernels and raises if there
is no card. ``device="cpu"`` runs the plain f32 versions of the gather and
the stack, the counterpart of the JAX engine's ``use_pallas=False`` path.

Traced (``utils.trace``), on the thread that drives ``revise_stream``:
spans ``engine.add_read``, ``engine.new_batch``, ``engine.submit`` (with
``engine.slot_wait``, blocked on the card for a free upload slot, inside
it), ``engine.fetch_wait`` (blocked on a batch's outputs, and their copy
off the slot), ``engine.unpack`` (a read's labels sliced from its batch),
``engine.calibrate`` and ``engine.merge``. No span is open while the
generator yields.

Failure contract: a bad read (too short, no signal, a wire-format
violation, too large for a batch, a merge error) degrades to its original
bases and is recorded in ``errors``; a device or kernel fault raises.
"""

from __future__ import annotations

import collections
import logging
from dataclasses import dataclass, field

import numpy as np
import torch

from ..io.fast5 import ReadData
from ..models import load_keras_weights
from ..models.fused import fold_inference_params
from ..ops.reviser_kernel import (
    kernel_weights,
    pack_stack_weights,
    stack_logits_full,
    stack_logits_plain,
    stack_models,
    weights_to_device,
)
from ..ops.window_gather import Q, window_gather, window_gather_plain
from ..signal.host_prep import CompactRead, compact_read_numpy
from ..utils import trace
from .merge import (
    calibrate_center_offset,
    merge_revision,
    merge_revision_with_quality,
)
from .wire import (
    ALIGN,
    DMA_LEN,
    DROP,
    MAX_BOUNDARY_DELTA,
    R_CAP,
    ROW_BLOCK,
    WireRead,
    decode_wire,
    encode_read,
    pack_codes2,
    pack_read_tables,
    torch_dtype,
    wire_tables,
    wire_to_tensors,
)

log = logging.getLogger("nanoreviser_torch")

DEFAULT_BLOCK = 256
DEFAULT_BATCH_WINDOWS = 196608      # windows per device batch (~20 reads)
CPU_BATCH_WINDOWS = 16384           # the JAX engine's CPU default
DEFAULT_R_MAX = 144                 # max reads per batch
SAMPLES_PER_ROW = 11                # signal budget per base row
SIG_HEAD = 64                       # slack before the first read's signal
VE_CAP = 4096                       # vlen-escape rows per batch
CE_CAP = 1024                       # non-ACGT color-escape rows per batch
_UPLOAD_ALIGN = 256                 # byte alignment of arrays in the upload


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclass(frozen=True)
class _Tier:
    """One fixed batch geometry."""

    w_max: int          # windows
    n_rows: int         # base rows the model consumes (w_max + window)
    n_rows_g: int       # gather rows (n_rows rounded up to ROW_BLOCK)
    s_cap: int          # signal samples in the (u8 delta-coded) buffer
    e_cap: int          # signal-escape entries
    de_cap: int         # duration-escape rows


@dataclass
class _Batch:
    arrays: dict                               # host-side packing arrays
    meta: list = field(default_factory=list)   # (fast5_name, read_obj, row_off)
    shifts: list = field(default_factory=list)   # per-read normalizers, in
    scales: list = field(default_factory=list)   # read_id order
    rows: int = 0
    sig_used: int = SIG_HEAD                   # cursor in forward sample space
    nse: int = 0                               # signal-escape entries used
    nve: int = 0                               # vlen-escape entries used
    nde: int = 0                               # duration-escape entries used
    nce: int = 0                               # color-escape entries used
    prev_last_val: int = 0                     # last signal value (delta chain)
    last_pos: int = 0                          # abs pos0 of the last row added


@dataclass
class _Slot:
    """Pinned host staging + device buffers of one in-flight batch."""

    host: torch.Tensor          # pinned uint8 upload staging
    dev: torch.Tensor           # device uint8 upload buffer
    out_labels: torch.Tensor    # pinned uint8 [w_max]
    out_q: torch.Tensor         # pinned uint8 [2, w_max]
    uploaded: torch.cuda.Event
    done: torch.cuda.Event
    busy: bool = False


@dataclass
class _Pending:
    meta: list
    n_windows: int
    slot: _Slot | None = None
    labels: np.ndarray | None = None   # filled when the batch is fetched
    q: np.ndarray | None = None


class StreamingReviser:
    """Revises a stream of reads through the device in fixed-shape batches."""

    def __init__(
        self,
        model1_path: str,
        model2_path: str,
        *,
        block: int = DEFAULT_BLOCK,
        align: str = "auto",
        batch_windows: int | None = None,
        r_max: int = DEFAULT_R_MAX,
        emit_quality: bool = False,
        max_in_flight: int = 4,
        device: str | torch.device = "cuda",
    ):
        self.device = torch.device(device)
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "device='cuda' but no CUDA device is available; pass "
                    "device='cpu' to run the plain versions on the CPU")
            if self.device.index is None:
                self.device = torch.device("cuda", torch.cuda.current_device())
        elif self.device.type != "cpu":
            raise ValueError(f"unsupported device {self.device}")
        self._cuda = self.device.type == "cuda"

        p1, win1, nc1 = load_keras_weights(model1_path)
        p2, win2, nc2 = load_keras_weights(model2_path)
        if win1 != win2:
            raise ValueError(f"model window mismatch: {win1} vs {win2}")
        self.window = win1
        self.n_classes = (nc1, nc2)
        self.block = block
        self.align = align
        # "auto": the window-center offset is a property of the weights, so
        # it is calibrated from the first revised read long enough
        self._center_offset: int | None = (
            None if align == "auto" else (win1 - 1) // 2)
        self.emit_quality = emit_quality
        self.max_in_flight = max_in_flight

        if batch_windows is None:
            # the CPU runs the plain f32 path: keep its top tier small
            batch_windows = DEFAULT_BATCH_WINDOWS if self._cuda else CPU_BATCH_WINDOWS
        if batch_windows % block:
            raise ValueError(f"batch_windows={batch_windows} is not a "
                             f"multiple of block={block}")
        if r_max >= R_CAP:
            raise ValueError(f"r_max={r_max} exceeds the read-table "
                             f"capacity {R_CAP - 1}")
        self.w_max = batch_windows
        self.r_max = r_max

        # size tiers 1/8, 1/4, 1/2 and full: small inputs and tail batches
        # run at the smallest tier that fits
        tiers_w = [batch_windows]
        for div in (2, 4, 8):
            w = _round_up(batch_windows // div, block)
            if block <= w < tiers_w[0]:
                tiers_w.insert(0, w)
        self.tiers = [self._mk_tier(w) for w in tiers_w]
        self.top = self.tiers[-1]
        self.n_rows = self.top.n_rows

        ws = stack_models([
            pack_stack_weights(fold_inference_params(p1), win1),
            pack_stack_weights(fold_inference_params(p2), win2),
        ])
        # the kernel takes bf16 matrices, its products packed in fragment
        # order once here; the CPU path is the f32 model
        self._ws = (kernel_weights(ws, self.device) if self._cuda
                    else weights_to_device(ws, self.device, torch.float32))
        self._wire_tables = wire_tables(self.device)
        self._copy_stream = (torch.cuda.Stream(self.device) if self._cuda
                             else None)
        self._slots = self._make_slots() if self._cuda else []
        self.stats = {"batches": 0, "windows": 0, "reads": 0}

    @property
    def read_caps(self) -> tuple[int, int]:
        """(bases, compacted samples) of the largest read a batch holds."""
        return self.top.n_rows, self.top.s_cap - DMA_LEN - 64 - SIG_HEAD

    def _mk_tier(self, w: int) -> _Tier:
        n_rows = w + self.window
        n_rows_g = _round_up(n_rows, ROW_BLOCK)
        s_cap = _round_up(
            n_rows_g * SAMPLES_PER_ROW + DMA_LEN + SIG_HEAD + 64, ALIGN)
        # escape capacities: the floors keep one stall-heavy read admissible
        # even in the smallest tier
        return _Tier(w_max=w, n_rows=n_rows, n_rows_g=n_rows_g, s_cap=s_cap,
                     e_cap=max(s_cap // 96, 8192),
                     de_cap=max(n_rows_g // 32, 4096))

    # ----------------------------------------------------------- device side

    def _device_step(self, v: dict, tier: _Tier, w_valid: int, nv: int):
        """One batch on the device: -> (labels u8 [W], q u8 [2, W] or None)."""
        t = self.window
        d = decode_wire(v, s_cap=tier.s_cap, n_rows=tier.n_rows,
                        n_rows_g=tier.n_rows_g, tables=self._wire_tables)
        rows_valid = nv * ROW_BLOCK
        if self._cuda:
            sig = window_gather(d.sig, d.pos0, d.vlen, d.read_id, d.shift,
                                d.scale, rows_valid)
            logits, probs = stack_logits_full(
                self._ws, sig, d.feats, t_len=t, w_valid=w_valid,
                want_probs=self.emit_quality, n_windows=tier.w_max)
        else:
            sig = window_gather_plain(d.sig, d.pos0, d.vlen, d.read_id,
                                      d.shift, d.scale, rows_valid,
                                      out_dtype=torch.float32, width=Q)
            logits, probs = stack_logits_plain(
                self._ws, sig, d.feats, t_len=t, w_valid=w_valid,
                n_windows=tier.w_max, want_probs=self.emit_quality,
                bf16=False)
        y1 = torch.argmax(logits[0], dim=-1).to(torch.uint8)
        y2 = torch.argmax(logits[1], dim=-1).to(torch.uint8)
        labels = y1 * 8 + y2
        if probs is None:
            return labels, None
        # phred-scaled confidence of the argmax class
        err = torch.clamp(1.0 - probs, 1e-4, 1.0)
        q = torch.clamp(-10.0 * torch.log10(err), 0.0, 93.0).to(torch.uint8)
        return labels, q

    def _layout(self, packed: dict):
        """Byte offsets of the finalized arrays in one upload buffer."""
        offs, pos = {}, 0
        for k, arr in packed.items():
            offs[k] = pos
            pos = _round_up(pos + arr.nbytes, _UPLOAD_ALIGN)
        return offs, pos

    def _views(self, buf: torch.Tensor, packed: dict, offs: dict) -> dict:
        return {
            k: buf[offs[k] : offs[k] + arr.nbytes].view(torch_dtype(arr))
            .view(arr.shape)
            for k, arr in packed.items()
        }

    def _make_slots(self) -> list[_Slot]:
        """The upload/download buffers of every batch that can be in flight
        (``max_in_flight`` + 1). They are allocated here, before any device
        work: a buffer allocated later could reuse memory that kernels of
        an earlier batch, freed on the compute stream but still running,
        are using, and the copy stream would overwrite it."""
        _, cap = self._layout(self._finalize(self._new_batch(), self.top))
        w = self.top.w_max
        return [_Slot(
            host=torch.empty(cap, dtype=torch.uint8, pin_memory=True),
            dev=torch.empty(cap, dtype=torch.uint8, device=self.device),
            out_labels=torch.empty(w, dtype=torch.uint8, pin_memory=True),
            out_q=torch.empty((2, w), dtype=torch.uint8, pin_memory=True),
            uploaded=torch.cuda.Event(), done=torch.cuda.Event())
            for _ in range(self.max_in_flight + 1)]

    def _acquire_slot(self) -> _Slot:
        for s in self._slots:
            if not s.busy:
                with trace.span("engine.slot_wait"):
                    s.done.synchronize()
                s.busy = True
                return s
        raise RuntimeError("more batches in flight than upload slots")

    def _submit(self, batch: _Batch) -> _Pending:
        tier = self._pick_tier([batch])
        packed = self._finalize(batch, tier)
        w_valid = int(packed["wvalid"][0])
        nv = int(packed["nv"][0])
        self.stats["batches"] += 1
        self.stats["windows"] += w_valid
        self.stats["reads"] += len(batch.meta)
        if not self._cuda:
            labels, q = self._device_step(wire_to_tensors(packed), tier,
                                          w_valid, nv)
            return _Pending(batch.meta, tier.w_max, labels=labels.numpy(),
                            q=None if q is None else q.numpy())
        offs, total = self._layout(packed)
        slot = self._acquire_slot()
        self._fill(slot.host.numpy(), packed, offs)
        with torch.cuda.stream(self._copy_stream):
            slot.dev[:total].copy_(slot.host[:total], non_blocking=True)
            slot.uploaded.record(self._copy_stream)
        compute = torch.cuda.current_stream(self.device)
        compute.wait_event(slot.uploaded)
        labels, q = self._device_step(self._views(slot.dev, packed, offs),
                                      tier, w_valid, nv)
        w = tier.w_max
        slot.out_labels[:w].copy_(labels, non_blocking=True)
        if q is not None:
            slot.out_q[:, :w].copy_(q, non_blocking=True)
        slot.done.record(compute)
        return _Pending(batch.meta, w, slot=slot)

    @staticmethod
    def _fill(host: np.ndarray, packed: dict, offs: dict) -> None:
        for k, arr in packed.items():
            host[offs[k] : offs[k] + arr.nbytes] = np.ascontiguousarray(
                arr).reshape(-1).view(np.uint8)

    def _fetch(self, p: _Pending) -> None:
        """Wait for a batch and copy its outputs off the slot."""
        if p.slot is None:
            return
        with trace.span("engine.fetch_wait"):
            p.slot.done.synchronize()
            p.labels = p.slot.out_labels[: p.n_windows].numpy().copy()
            if self.emit_quality:
                p.q = p.slot.out_q[:, : p.n_windows].numpy().copy()
        p.slot.busy = False
        p.slot = None

    # ------------------------------------------------------------- host side

    def _new_batch(self) -> _Batch:
        """Host packing arrays, allocated at the top tier (submit slices)."""
        top = self.top
        return _Batch(arrays={
            "sig8": np.zeros(top.s_cap, np.uint8),
            "sig_esc_idx": np.full(top.e_cap, DROP, np.int32),
            "sig_esc_delta": np.zeros(top.e_cap, np.int32),
            "posd": np.zeros(top.n_rows_g, np.uint8),
            "vlen_esc_idx": np.full(VE_CAP, DROP, np.int32),
            "vlen_esc_val": np.zeros(VE_CAP, np.int32),
            "dur_esc_idx": np.full(top.de_cap, DROP, np.int32),
            "dur_esc_f32": np.zeros(top.de_cap, np.float32),
            "col_esc_idx": np.full(CE_CAP, DROP, np.int32),
            "codes": np.zeros(top.n_rows_g, np.uint8),
            "evf": np.zeros((top.n_rows, 4), np.float16),
            "read_r0": np.full(R_CAP, DROP, np.int32),
        })

    def _add_read(self, batch: _Batch, name: str, read, w: WireRead) -> bool:
        """Try to append a wire-encoded read to the batch; False if it won't
        fit (rows, signal, read-table, or any escape budget).

        ``read`` is the caller's original object (ReadData, CompactRead or
        WireRead), carried through to the output tuples; ``w`` holds the
        encoded arrays.
        """
        n = w.n_bases
        m = w.n_samples
        top = self.top
        sig_limit = top.s_cap - DMA_LEN - 64
        if (batch.rows + n > top.n_rows
                or batch.sig_used + m > sig_limit
                or len(batch.meta) >= self.r_max
                or batch.nse + len(w.sig_esc_idx) + 1 > top.e_cap
                or batch.nde + len(w.dur_esc_idx) > top.de_cap
                or batch.nve + len(w.vlen_esc_idx) > VE_CAP
                or batch.nce + len(w.col_esc_idx) > CE_CAP):
            return False
        vw = batch.arrays
        r0 = batch.rows
        g = batch.sig_used
        # the first row's pos0 delta chains from the previous read's last
        # row (or from 0 at the head); encode-time chain-bounds validation
        # guarantees it for valid reads, so this is a backstop
        row_delta = (g + w.pos0_first) - (batch.last_pos if r0 else 0)
        if not 0 <= row_delta <= MAX_BOUNDARY_DELTA:
            raise ValueError(
                f"read-boundary pos0 delta {row_delta} outside "
                f"[0, {MAX_BOUNDARY_DELTA}] (chain-bounds validation "
                f"should have caught this)")
        # forward placement: sample p of the batch lives at sig8[p]
        vw["sig8"][g : g + m] = w.sig8
        e0 = batch.nse
        ne = len(w.sig_esc_idx)
        vw["sig_esc_idx"][e0] = g                   # chained first delta
        vw["sig_esc_delta"][e0] = w.first_val - batch.prev_last_val
        vw["sig_esc_idx"][e0 + 1 : e0 + 1 + ne] = g + w.sig_esc_idx
        vw["sig_esc_delta"][e0 + 1 : e0 + 1 + ne] = w.sig_esc_delta
        batch.nse = e0 + 1 + ne
        vw["posd"][r0] = row_delta
        vw["posd"][r0 + 1 : r0 + n] = w.posd[1:]
        nv_ = len(w.vlen_esc_idx)
        vw["vlen_esc_idx"][batch.nve : batch.nve + nv_] = r0 + w.vlen_esc_idx
        vw["vlen_esc_val"][batch.nve : batch.nve + nv_] = w.vlen_esc_val
        batch.nve += nv_
        nd = len(w.dur_esc_idx)
        vw["dur_esc_idx"][batch.nde : batch.nde + nd] = r0 + w.dur_esc_idx
        vw["dur_esc_f32"][batch.nde : batch.nde + nd] = w.dur_esc_f32
        batch.nde += nd
        nc = len(w.col_esc_idx)
        vw["col_esc_idx"][batch.nce : batch.nce + nc] = r0 + w.col_esc_idx
        batch.nce += nc
        vw["codes"][r0 : r0 + n] = w.codes
        vw["evf"][r0 : r0 + n] = w.evf
        vw["read_r0"][len(batch.meta)] = r0
        batch.shifts.append(w.shift)
        batch.scales.append(w.scale)
        batch.meta.append((name, read, r0))
        batch.rows = r0 + n
        batch.sig_used = g + m
        batch.prev_last_val = w.last_val
        batch.last_pos = g + w.pos0_last
        return True

    def _pick_tier(self, batches: list[_Batch]) -> _Tier:
        rows = max(b.rows for b in batches)
        sig = max(b.sig_used for b in batches)
        nse = max(b.nse for b in batches)
        nde = max(b.nde for b in batches)
        for tier in self.tiers:
            if (rows <= tier.n_rows and sig <= tier.s_cap - DMA_LEN - 64
                    and nse <= tier.e_cap and nde <= tier.de_cap):
                return tier
        return self.top

    def _finalize(self, batch: _Batch, tier: _Tier) -> dict:
        """Slice one batch's host arrays into tier-shaped upload arrays.

        Pad rows need no special handling: their posd is 0, so the decoded
        pos0 repeats the last real row, and their vlen defaults to 50 /
        read_id to the last read; those rows feed only windows past
        w_valid, which the kernels skip and the host never reads.
        """
        vw = batch.arrays
        rows = batch.rows
        tabs = pack_read_tables(batch.shifts, batch.scales)
        w_needed = max(rows - self.window, 0)
        w_valid = min(-(-w_needed // self.block) * self.block, tier.w_max)
        if w_valid:
            nv = -(-(min(w_valid + self.window, tier.n_rows_g)) // ROW_BLOCK)
        else:
            nv = 0
        return {
            "sig8": vw["sig8"][: tier.s_cap],
            "sig_esc_idx": vw["sig_esc_idx"][: tier.e_cap],
            "sig_esc_delta": vw["sig_esc_delta"][: tier.e_cap],
            "posd": vw["posd"][: tier.n_rows_g],
            "vlen_esc_idx": vw["vlen_esc_idx"],
            "vlen_esc_val": vw["vlen_esc_val"],
            "dur_esc_idx": vw["dur_esc_idx"][: tier.de_cap],
            "dur_esc_f32": vw["dur_esc_f32"][: tier.de_cap],
            "col_esc_idx": vw["col_esc_idx"],
            "codes2": pack_codes2(vw["codes"][: tier.n_rows_g]),
            "evf": vw["evf"][: tier.n_rows],
            "read_r0": vw["read_r0"],
            "tabs": tabs,
            "nv": np.array([nv], np.int32),
            "wvalid": np.array([w_valid], np.int32),
        }

    def pack_batch(self, items) -> tuple[dict, _Tier, int]:
        """Pack (name, WireRead) items into one batch until it is full.

        Returns (finalized arrays, tier, number of items packed): the batch
        the engine would upload, for tests and measurements."""
        batch = self._new_batch()
        n = 0
        for name, w in items:
            if not self._add_read(batch, name, w, w):
                break
            n += 1
        tier = self._pick_tier([batch])
        return self._finalize(batch, tier), tier, n

    def _merge_mode(self) -> str:
        return "reference" if self.align == "reference" else "center"

    def _calibrate(self, bases: str, y1: np.ndarray) -> None:
        """Lazy per-weights center-offset calibration (align="auto")."""
        with trace.span("engine.calibrate"):
            off, agree = calibrate_center_offset(bases, y1, self.window)
        self._center_offset = off
        log.info("center offset calibrated: %d (model1 agreement %.3f)",
                 off, agree)
        if agree < 0.5:
            log.warning(
                "center-offset calibration found no confident alignment "
                "(best agreement %.3f) — model may be degenerate; using "
                "the default center %d", agree, off)

    def _merge_one(self, name, read, y1, y2, q1, q2):
        t = self.window
        if q1 is not None:
            seq, qual = merge_revision_with_quality(
                read.bases, y1, y2, q1, q2,
                align=self._merge_mode(), window=t,
                center_offset=self._center_offset,
            )
            return name, read, seq, qual
        seq = merge_revision(
            read.bases, y1, y2, align=self._merge_mode(),
            window=t, center_offset=self._center_offset,
        )
        return name, read, seq, None

    def _fallback(self, name, read, emit, errors, exc):
        if errors is not None:
            errors.append((name, exc))
        return (name, read) + ((None, None) if emit == "labels"
                               else (read.bases, None))

    def _finish(self, pending: _Pending, emit: str, precal: list, errors):
        """Yield the reads of one fetched batch. Device faults raise; a read
        whose merge fails degrades alone."""
        self._fetch(pending)
        packed, q = pending.labels, pending.q
        t = self.window
        for name, read, r0 in pending.meta:
            wr = max(read.n_bases - t, 0)
            if wr == 0:
                yield (name, read, None, None) if emit == "labels" else (
                    name, read, read.bases, None)
                continue
            with trace.span("engine.unpack"):
                pk = packed[r0 : r0 + wr]
                y1 = (pk >> 3).astype(np.int32)
                y2 = (pk & 7).astype(np.int32)
                q1 = q[0, r0 : r0 + wr] if q is not None else None
                q2 = q[1, r0 : r0 + wr] if q is not None else None
            if emit == "labels":
                yield name, read, y1, y2
                continue
            if self._center_offset is None:
                if wr >= 64:
                    self._calibrate(read.bases, y1)
                    yield from self._flush_precal(precal, errors)
                else:
                    # too short to calibrate confidently: defer the merge
                    # until an offset is established (or the stream ends).
                    # The stash is stream-local, so an abandoned generator
                    # cannot leak deferred reads into a later stream.
                    precal.append((name, read, y1, y2, q1, q2))
                    continue
            yield self._merge_safe(name, read, y1, y2, q1, q2, errors)

    def _merge_safe(self, name, read, y1, y2, q1, q2, errors):
        try:
            with trace.span("engine.merge"):
                return self._merge_one(name, read, y1, y2, q1, q2)
        except Exception as exc:  # noqa: BLE001 — per-read degradation
            return self._fallback(name, read, "seq", errors, exc)

    def _flush_precal(self, precal: list, errors):
        """Merge + yield reads deferred while the center offset was unknown."""
        stash, precal[:] = list(precal), []
        for item in stash:
            yield self._merge_safe(*item, errors)

    def revise_stream(self, items, errors: list | None = None,
                      emit: str = "seq"):
        """items: iterable of (fast5_name, ReadData | CompactRead | WireRead).

        Yields (name, read, revised_seq, qual_or_None); with emit="labels"
        yields (name, read, y1, y2) per-window class labels instead
        (degraded reads yield y1 = y2 = None). Degraded reads are emitted at
        input time, ahead of in-flight reads; with align="auto" reads too
        short to calibrate the center offset are deferred until calibration.

        Per-read failures degrade to the original bases (the reference's
        fallback contract, NanoReviser.py:146-154); pass ``errors`` to
        collect (name, exception) pairs.
        """
        pending: collections.deque[_Pending] = collections.deque()
        with trace.span("engine.new_batch"):
            batch = self._new_batch()
        precal: list = []          # stream-local pre-calibration stash
        for s in self._slots:      # batches of an abandoned stream
            s.done.synchronize()
            s.busy = False

        for name, read in items:
            bad = read.n_bases < 2 or (
                isinstance(read, ReadData)
                and read.read_start_rel_to_raw >= len(read.signal)
            )
            if bad:
                exc = ValueError(
                    f"read has too few bases ({read.n_bases}) or no signal")
                yield self._fallback(name, read, emit, errors, exc)
                continue
            try:
                if isinstance(read, WireRead):
                    prepped = read
                elif isinstance(read, CompactRead):
                    prepped = encode_read(read)
                else:
                    prepped = encode_read(compact_read_numpy(read))
                with trace.span("engine.add_read"):
                    added = self._add_read(batch, name, read, prepped)
            except Exception as exc:  # noqa: BLE001 — host prep of one read
                yield self._fallback(name, read, emit, errors, exc)
                continue
            if not added and batch.meta:
                # device faults in the batch propagate: no degradation here
                with trace.span("engine.submit"):
                    pending.append(self._submit(batch))
                with trace.span("engine.new_batch"):
                    batch = self._new_batch()
                try:
                    with trace.span("engine.add_read"):
                        added = self._add_read(batch, name, read, prepped)
                except ValueError as exc:
                    yield self._fallback(name, read, emit, errors, exc)
                    continue
            if not added:
                exc = ValueError(
                    f"read too large for batch: {read.n_bases} bases / "
                    f"{prepped.n_samples} samples")
                yield self._fallback(name, read, emit, errors, exc)
                continue
            if len(pending) > self.max_in_flight:
                yield from self._finish(pending.popleft(), emit, precal, errors)
        if batch.meta:
            with trace.span("engine.submit"):
                pending.append(self._submit(batch))
        while pending:
            yield from self._finish(pending.popleft(), emit, precal, errors)
        if precal:
            # every read so far was too short for a confident calibration:
            # calibrate from the longest one with the sample floor lowered
            longest = max(precal, key=lambda it: len(it[2]))
            with trace.span("engine.calibrate"):
                off, agree = calibrate_center_offset(
                    longest[1].bases, longest[2], self.window, min_n=8)
            self._center_offset = off
            log.warning(
                "stream ended before a read long enough for confident "
                "center-offset calibration; calibrated from a %d-window "
                "read: offset %d (agreement %.3f)",
                len(longest[2]), off, agree)
            yield from self._flush_precal(precal, errors)

    def revise_read(self, read: ReadData) -> str:
        for _, _, seq, _ in self.revise_stream([("", read)]):
            return seq
        return read.bases
