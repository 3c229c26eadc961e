"""The basecaller engine: Bonito's CRF-CTC model (``models.crf``) over
whole reads, on the card, in this process.

    engine = Basecaller(model_dir, device="cuda", emit_quality=True)
    for name, seq, qual in engine.basecall_stream(items, errors=failed):
        ...

``items`` are (name, ``signal.host_prep.SignalRead``) pairs, as
``infer.hostpipe.PrepPool.stream_signals`` yields them: each read's whole
int16 signal and its median and MAD. Per read, on the calling thread:

* chunking (Bonito's ``chunk``): a read of fewer samples than
  ``chunksize`` is one chunk, padded with zeros on the left; a longer one
  is cut into chunks ``chunksize - overlap`` apart that end at the read's
  end, plus a first chunk at its start where those leave a stub there.
  Each chunk's int16 samples and the read's shift, scale and padding go to
  a row of a pinned batch of ``batch_chunks`` rows;
* a full batch goes to the card (``(x - shift) / scale``, zero in the
  padding, the encoder in fp16 with f32 accumulation, its LSTMs by the
  route ``ops.lstm.lstm_route`` picks from ``features`` when the engine is
  made: the hand-written kernel ``ops.lstm`` where its layout holds the
  width, else cuDNN, and ``nn.LSTM`` on the CPU; ``ops.crf_decode`` in
  f32; on the card as replays of CUDA graphs captured when the engine is
  made), and only each step's label (and, for fastq, its quality
  character) comes back. Batches always have ``batch_chunks`` rows (the
  last one's unused rows hold old samples and are ignored), so a chunk's
  labels depend on its own samples only;
* stitching (Bonito's ``stitch``): each chunk keeps its steps from
  ``(overlap // 2) // stride`` to ``(chunksize - overlap // 2) // stride``,
  the first chunk from 0 (to where the next chunk's kept part starts), the
  last to its end; a read of one chunk keeps all of it;
* the bases of the moves (``N A C G T`` by label, 0 emits nothing), trimmed
  as the basecaller mode trims a harvested fastq line, ``[13:-12]``.

A read with no signal, or whose trimmed read is empty, degrades: it is
recorded in ``errors`` and yielded with ``seq`` None at once, ahead of the
reads in flight. Reads are yielded in input order otherwise.

Traced (``utils.trace``): spans ``basecall.chunk`` (a read's chunks into
the batch), ``basecall.submit`` (a batch to the card; inside it
``basecall.lstm``, the five LSTMs' launches), ``basecall.fetch_wait`` (a
batch's labels), ``basecall.stitch`` (a read's labels into its bases);
counters ``basecall.samples``, ``basecall.chunks``, ``basecall.batches``,
``basecall.lstm_kernel_layers`` (the layers a batch ran in the LSTM
kernel).
"""

from __future__ import annotations

import collections
from dataclasses import dataclass

import numpy as np
import torch

from ..models.crf import load_bonito_model
from ..ops import build, lstm
from ..ops.crf_decode import CRF_DECODE, crf_decode
from ..utils import trace

BASES = np.frombuffer(b"NACGT", np.uint8)
TRIM_HEAD, TRIM_TAIL = 13, 12
MAX_IN_FLIGHT = 2          # batches on the card while the host fills the next
WARMUP_BATCHES = 2         # eager batches on a side stream before the capture


def chunk_starts(n: int, chunk: int, overlap: int) -> tuple[list, int, int]:
    """(chunk starts, left padding, stub) of a read of ``n`` samples."""
    if n < chunk:
        return [0], chunk - n, 0
    step = chunk - overlap
    stub = (n - overlap) % step
    starts = list(range(stub, n - chunk + 1, step))
    return ([0] + starts if stub > 0 else starts), 0, stub


def keep_ranges(n_chunks: int, stub: int, steps: int, chunk: int,
                overlap: int, stride: int) -> list:
    """The [lo, hi) steps each chunk of a read keeps."""
    if n_chunks == 1:
        return [(0, steps)]
    semi = overlap // 2
    start, end = semi // stride, (chunk - semi) // stride
    first_end = (stub + semi) // stride if stub > 0 else end
    return [(0, first_end)] + [(start, end)] * (n_chunks - 2) + [(start, steps)]


@dataclass
class _Slot:
    host_sig: torch.Tensor      # [B, chunk] int16, pinned on the card
    host_meta: torch.Tensor     # [3, B] f32: shift, scale, left padding
    out_labels: torch.Tensor    # [B, steps] u8
    out_quals: torch.Tensor | None
    done: object = None         # torch.cuda.Event
    busy: bool = False


class Basecaller:
    """Bonito's CRF-CTC basecaller over whole reads on ``device``."""

    def __init__(self, model_dir: str, device: str = "cuda",
                 emit_quality: bool = False, batch_chunks: int | None = None):
        module = load_bonito_model(model_dir)
        self.cfg = cfg = module.cfg
        self.device = torch.device(device)
        self._cuda = self.device.type == "cuda"
        self.emit_quality = emit_quality
        self.batch = int(batch_chunks or (1024 if self._cuda else 32))
        self.steps = cfg.steps(cfg.chunksize)
        self.model = module.to(self.device,
                               torch.float16 if self._cuda else torch.float32)
        self.lstm_route = lstm.lstm_route(cfg.features, self.device)
        self._packed = ([lstm.pack_lstm(rnn) for rnn in self.model.rnns]
                        if self.lstm_route == "kernel" else [])
        if self._cuda:      # the first batch's kernels, in one parallel build
            build.build_all((CRF_DECODE.source,)
                            + ((lstm.LSTM_LAYER.source,) if self._packed else ()))
        self._cols = torch.arange(cfg.chunksize, device=self.device)
        self._slots = [self._make_slot() for _ in range(MAX_IN_FLIGHT + 1)]
        self._graph = self._capture() if self._cuda else None

    def _make_slot(self) -> _Slot:
        pin = self._cuda
        b, c, t = self.batch, self.cfg.chunksize, self.steps
        meta = torch.zeros((3, b), dtype=torch.float32, pin_memory=pin)
        meta[1] = 1.0
        return _Slot(
            host_sig=torch.zeros((b, c), dtype=torch.int16, pin_memory=pin),
            host_meta=meta,
            out_labels=torch.empty((b, t), dtype=torch.uint8, pin_memory=pin),
            out_quals=(torch.empty((b, t), dtype=torch.uint8, pin_memory=pin)
                       if self.emit_quality else None),
            done=torch.cuda.Event() if self._cuda else None)

    # ------------------------------------------------------------ device side

    @torch.inference_mode()
    def _stem(self, sig: torch.Tensor, meta: torch.Tensor) -> torch.Tensor:
        x = (sig.float() - meta[0][:, None]) / meta[1][:, None]
        x = torch.where(self._cols[None, :] < meta[2][:, None], 0.0, x)
        dtype = next(self.model.parameters()).dtype
        return self.model.stem(x.to(dtype)[:, None, :])

    @torch.inference_mode()
    def _lstms(self, h: torch.Tensor) -> torch.Tensor:
        if not self._packed:
            return self.model.lstms(h)
        for i, p in enumerate(self._packed):
            h = lstm.lstm_layer(h, p, self.cfg.reverse(i))
        return h

    @torch.inference_mode()
    def _head(self, h: torch.Tensor):
        scores = self.model.head(h).contiguous()
        return crf_decode(scores, self.cfg.blank_score, self.cfg.state_len,
                          self.emit_quality)

    def _device_step(self, sig: torch.Tensor, meta: torch.Tensor):
        """int16 [B, chunk] and [3, B] -> labels, quals [B, steps]."""
        h = self._stem(sig, meta)
        with trace.span("basecall.lstm"):
            h = self._lstms(h)
        return self._head(h)

    def _capture(self):
        """One batch as three CUDA graphs on static buffers (the stem, the
        LSTMs, the head with the decode; three, so that the profiler can
        tell the LSTMs' kernels by their launch), after two eager batches
        on a side stream. On the cuDNN route the LSTMs launch ~16k kernels
        a batch, most of them per step: a replay launches them from the
        card. On the kernel route they are five products and five kernel
        launches."""
        b, c = self.batch, self.cfg.chunksize
        sig = torch.zeros((b, c), dtype=torch.int16, device=self.device)
        meta = torch.zeros((3, b), dtype=torch.float32, device=self.device)
        meta[1] = 1.0
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            for _ in range(WARMUP_BATCHES):
                self._device_step(sig, meta)
        torch.cuda.current_stream(self.device).wait_stream(side)
        graphs = [torch.cuda.CUDAGraph() for _ in range(3)]
        with torch.cuda.graph(graphs[0]):
            h = self._stem(sig, meta)
        with torch.cuda.graph(graphs[1], pool=graphs[0].pool()):
            h = self._lstms(h)
        with torch.cuda.graph(graphs[2], pool=graphs[0].pool()):
            out = self._head(h)
        return sig, meta, graphs, out

    def _acquire(self) -> _Slot:
        for s in self._slots:
            if not s.busy:
                if s.done is not None:
                    s.done.synchronize()
                s.busy = True
                return s
        raise RuntimeError("more batches in flight than slots")

    def _submit(self, slot: _Slot) -> None:
        trace.count("basecall.batches")
        trace.count("basecall.lstm_kernel_layers", len(self._packed))
        if not self._cuda:
            labels, quals = self._device_step(slot.host_sig, slot.host_meta)
            slot.out_labels.copy_(labels)
            if quals is not None:
                slot.out_quals.copy_(quals)
            return
        sig, meta, (stem, lstms, head), (labels, quals) = self._graph
        sig.copy_(slot.host_sig, non_blocking=True)
        meta.copy_(slot.host_meta, non_blocking=True)
        stem.replay()
        with trace.span("basecall.lstm"):
            lstms.replay()
        head.replay()
        slot.out_labels.copy_(labels, non_blocking=True)
        if quals is not None:
            slot.out_quals.copy_(quals, non_blocking=True)
        slot.done.record()

    def _fetch(self, slot: _Slot) -> tuple:
        with trace.span("basecall.fetch_wait"):
            if slot.done is not None:
                slot.done.synchronize()
            out = (slot.out_labels.numpy().copy(),
                   None if slot.out_quals is None
                   else slot.out_quals.numpy().copy())
        slot.busy = False
        return out

    # -------------------------------------------------------------- host side

    def _stitch(self, results: dict, g0: int, n_chunks: int, stub: int):
        """A read's (seq, qual or None) from its chunks' labels."""
        b0, r0 = divmod(g0, self.batch)
        rows, quals, left, b = [], [], n_chunks, b0
        while left:
            take = min(left, self.batch - r0)
            lab, q = results[b]
            rows.append(lab[r0 : r0 + take])
            if q is not None:
                quals.append(q[r0 : r0 + take])
            left -= take
            b, r0 = b + 1, 0
        cfg = self.cfg
        keep = keep_ranges(n_chunks, stub, self.steps, cfg.chunksize,
                           cfg.overlap, cfg.stride)

        (_, first_end), (start, _) = keep[0], keep[-1]
        end = keep[1][1] if n_chunks > 2 else start

        def stitched(parts):
            m = parts[0] if len(parts) == 1 else np.concatenate(parts)
            if n_chunks == 1:
                return m[0]
            return np.concatenate([m[0, :first_end],
                                   m[1:-1, start:end].reshape(-1),
                                   m[-1, start:]])

        labels = stitched(rows)
        moves = np.flatnonzero(labels)
        seq = BASES[labels[moves]].tobytes().decode()[TRIM_HEAD:-TRIM_TAIL]
        qual = None
        if quals:
            qual = stitched(quals)[moves].tobytes().decode()[TRIM_HEAD:-TRIM_TAIL]
        return seq, qual

    def basecall_stream(self, items, errors: list | None = None):
        """items: (name, SignalRead). Yields (name, seq, qual or None);
        ``seq`` None for a degraded read (recorded in ``errors``)."""
        for s in self._slots:          # batches of an abandoned stream
            if s.busy and s.done is not None:
                s.done.synchronize()
            s.busy = False
        b, c = self.batch, self.cfg.chunksize
        results: dict = {}             # batch -> (labels, quals) fetched
        in_flight: collections.deque = collections.deque()   # (batch, slot)
        waiting: collections.deque = collections.deque()     # reads to stitch
        n_batches = 0
        slot, used = None, 0

        def degrade(name, why):
            if errors is not None:
                errors.append((name, why))
            return name, None, None

        def finish(upto_batch: int):
            """Fetch batches through ``upto_batch``; yield the reads they
            complete."""
            while in_flight and in_flight[0][0] <= upto_batch:
                k, s = in_flight.popleft()
                results[k] = self._fetch(s)
            done_through = (in_flight[0][0] if in_flight else n_batches) * b
            while waiting and waiting[0][1] + waiting[0][2] <= done_through:
                name, g0, nc, stub = waiting.popleft()
                with trace.span("basecall.stitch"):
                    seq, qual = self._stitch(results, g0, nc, stub)
                if seq:
                    yield name, seq, qual
                else:
                    yield degrade(name, "the basecaller wrote no bases")
            first = (waiting[0][1] // b) if waiting else n_batches
            for k in [k for k in results if k < first]:
                del results[k]

        def submit():
            nonlocal slot, used, n_batches
            with trace.span("basecall.submit"):
                self._submit(slot)
            in_flight.append((n_batches, slot))
            n_batches += 1
            slot, used = None, 0

        g = 0
        for name, read in items:
            n = 0 if read is None else read.n_samples
            if n == 0:
                yield degrade(name, "read has no signal")
                continue
            starts, pad, stub = chunk_starts(n, c, self.cfg.overlap)
            sig = read.signal
            windows = (np.lib.stride_tricks.sliding_window_view(sig, c)
                       if pad == 0 else None)
            waiting.append((name, g, len(starts), stub))
            trace.count("basecall.samples", n)
            trace.count("basecall.chunks", len(starts))
            k = 0
            while k < len(starts):
                if slot is None:
                    slot = self._acquire()
                take = min(b - used, len(starts) - k)
                with trace.span("basecall.chunk"):
                    host = slot.host_sig.numpy()
                    meta = slot.host_meta.numpy()
                    if windows is not None:     # gathers only these rows
                        host[used : used + take] = windows[starts[k : k + take]]
                    else:
                        host[used, pad:] = sig
                    meta[0, used : used + take] = read.shift
                    meta[1, used : used + take] = read.scale
                    meta[2, used : used + take] = pad
                used += take
                k += take
                g += take
                if used == b:
                    submit()
                    if len(in_flight) > MAX_IN_FLIGHT:
                        yield from finish(in_flight[0][0])
        if used:
            submit()
        yield from finish(n_batches)
