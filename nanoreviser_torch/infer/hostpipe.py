"""Host ingestion pipeline: fast5 decode, compaction and wire encode on
worker processes (counterpart of ``nanoreviser_tpu/infer/hostpipe.py``).

Decode is Python and numpy work that holds the GIL, so threads do not scale
it; worker processes do. Each worker runs ``signal.host_prep``'s entry
points: ``io.fast5.get_read_data`` -> ``compact_read`` -> the host
library's wire encode, written into one of a ring of ``/dev/shm`` slots,
so that only the small fields of a read (its bases, normalizers, chain
values and escape counts) travel back through the pool's result pipe, with
the worker's own seconds over the chunk.

``stream_signals`` runs the basecaller's job on the same workers and
slots instead (``signal.host_prep._pool_signal_one``): a read's whole raw
int16 signal goes into the slot and its median and MAD x 1.4826 travel
back, as a ``SignalRead``.

Slot lifetime: ``stream`` yields a ``WireRead`` whose arrays view a slot;
the view is valid until the caller asks for the next item, when the slot is
recycled. ``StreamingReviser`` copies each read into its batch at once.

Workers are started with ``spawn``: the parent holds a CUDA context, which
does not survive ``fork``. Their entry points live in ``signal.host_prep``,
whose imports stay free of torch. Slots are plain files under ``/dev/shm``
named ``nanorev_torch_prep_<pid>_<pool>_<slot>``; ``_gc_stale_slots``
removes those of processes that died before ``close``. Submission is
bounded (``prefetch``), and results come back in input order as
(name, WireRead or None, error text or None).

Traced (``utils.trace``): spans ``pool.submit`` (a chunk handed to the
pool), ``pool.wait`` (blocked on a chunk's results) and ``pool.unpack``
(a read's views of its slot); counters ``pool.worker_s`` and
``pool.worker_reads``, the prep's own seconds in the workers and the reads
they prepped.
"""

from __future__ import annotations

import collections
import glob
import itertools
import multiprocessing as mp
import os
import time

import numpy as np

from .. import native
from ..signal.host_prep import (
    SignalRead,
    _pool_chunk,
    _pool_init,
    _pool_prep_one,
    _pool_signal_one,
    _slot_views,
    slot_layout,
)
from ..utils import trace
from .wire import WireRead

# The largest read the default engine's top tier holds on the card (196,608
# windows at T = 11: StreamingReviser.read_caps); a larger read travels
# pickled, and the engine degrades it as too large for a batch.
DEFAULT_SLOT_BASES = 196_619
DEFAULT_SLOT_SAMPLES = 2_164_608
SLOT_DIR = "/dev/shm"
SLOT_PREFIX = "nanorev_torch_prep_"
_instance_counter = itertools.count()


def _gc_stale_slots() -> None:
    """Remove slots left by processes that died before ``close`` (SIGKILL,
    OOM, a test's time limit): a slot's name holds its creator's PID."""
    for path in glob.glob(os.path.join(SLOT_DIR, SLOT_PREFIX + "*")):
        try:
            pid = int(os.path.basename(path)[len(SLOT_PREFIX):].split("_")[0])
        except ValueError:
            continue
        if pid == os.getpid():
            continue
        try:
            os.kill(pid, 0)
        except ProcessLookupError:
            try:
                os.unlink(path)
            except OSError:
                pass
        except PermissionError:
            pass                       # someone else's live process


def _wire_from_slot(buf, layout: dict, small: tuple) -> WireRead:
    (n, m, shift, scale, bases, first_val, last_val, pos0_first, pos0_last,
     ne, nd, nv, nc) = small
    v = _slot_views(buf, layout, n, m, counts=(ne, nd, nv, nc))
    return WireRead(bases=bases, first_val=first_val, last_val=last_val,
                    pos0_first=pos0_first, pos0_last=pos0_last,
                    shift=shift, scale=scale, **v)


def _signal_from_slot(buf, small: tuple) -> SignalRead:
    n, shift, scale = small
    return SignalRead(signal=np.frombuffer(buf, np.int16, n), shift=shift,
                      scale=scale)


class PrepPool:
    """Ordered, bounded fan-out of the per-read host prep over worker
    processes. ``n_workers=0`` preps inline on the calling thread.

    ``native_fallbacks`` counts the reads the workers ran again on the
    numpy path after the host library refused them."""

    def __init__(
        self,
        n_workers: int,
        basecall_group: str = "Basecall_1D_000",
        basecall_subgroup: str = "BaseCalled_template",
        slot_bases: int = DEFAULT_SLOT_BASES,
        slot_samples: int = DEFAULT_SLOT_SAMPLES,
        n_slots: int = 16,
        chunk: int = 2,
    ):
        self._t0 = time.perf_counter()
        native.load()           # build before any worker needs it
        self.n_workers = n_workers
        self.group = basecall_group
        self.subgroup = basecall_subgroup
        self.slot_bases = slot_bases
        self.slot_samples = slot_samples
        self.chunk = chunk
        self.native_fallbacks = 0
        self._layout = slot_layout(slot_bases, slot_samples)
        self._pool = None
        self._ready = None
        self._ready_s: float | None = None
        self._slot_paths: list[str] = []
        self._slot_maps: list[np.memmap] = []
        self._inline_buf = None
        if n_workers == 0:
            self._inline_buf = np.empty(self._layout["total"], np.uint8)
            return
        _gc_stale_slots()
        self._make_slots(n_slots)
        try:
            self._start_workers(n_workers)
        except BaseException:
            self.close()
            raise

    def _start_workers(self, n_workers: int) -> None:
        # one thread each for the workers' BLAS/OpenMP pools: read when a
        # worker first imports numpy, so set in the parent before spawn
        env_keys = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")
        saved = {k: os.environ.get(k) for k in env_keys}
        os.environ.update({k: "1" for k in env_keys})
        try:
            ctx = mp.get_context("spawn")
            self._ready = ctx.Semaphore(0)
            self._pool = ctx.Pool(
                n_workers, initializer=_pool_init,
                initargs=(self._ready,))
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v

    def _make_slots(self, n_slots: int) -> None:
        """Create the slot files, after checking that /dev/shm holds them:
        a write past a full tmpfs is a SIGBUS in the worker, not an error."""
        size = self._layout["total"]
        st = os.statvfs(SLOT_DIR)
        free = st.f_bavail * st.f_frsize
        if n_slots * size > free:
            raise OSError(
                f"{n_slots} prep slots of {size} bytes need {n_slots * size} "
                f"bytes of {SLOT_DIR}, which has {free} free; lower n_slots "
                f"or the slot caps, or enlarge {SLOT_DIR}")
        token = next(_instance_counter)
        try:
            for i in range(n_slots):
                path = os.path.join(
                    SLOT_DIR, f"{SLOT_PREFIX}{os.getpid()}_{token}_{i}")
                with open(path, "xb") as fp:    # sparse: a read touches
                    self._slot_paths.append(path)  # only the pages it fills
                    fp.truncate(size)
                self._slot_maps.append(np.memmap(path, dtype=np.uint8, mode="r+"))
        except BaseException:
            self.close()
            raise

    def ready(self, timeout: float = 300.0) -> float:
        """Wait until every worker has imported its modules; returns the
        seconds from the pool's construction to then (0 inline)."""
        if self._ready_s is None:
            deadline = time.monotonic() + timeout
            for _ in range(self.n_workers):
                if not self._ready.acquire(timeout=max(deadline - time.monotonic(), 0)):
                    raise TimeoutError(f"prep workers not ready after {timeout} s")
            self._ready_s = time.perf_counter() - self._t0 if self.n_workers else 0.0
        return self._ready_s

    def stream(self, base_dir: str, fns, prefetch: int = 24):
        """Yields (fn, WireRead or None, error text or None) in input order.

        A yielded WireRead may view a slot that is recycled when the next
        item is asked for: copy it before advancing."""
        spec = (self.group, self.subgroup, self.slot_bases, self.slot_samples)
        return self._stream(base_dir, fns, prefetch, _pool_prep_one, spec,
                            lambda buf, small: _wire_from_slot(
                                buf, self._layout, small))

    def stream_signals(self, base_dir: str, fns, prefetch: int = 24):
        """Yields (fn, SignalRead or None, error text or None) in input
        order: each read's whole raw signal and its normalisers
        (``signal.host_prep._pool_signal_one``), for the basecaller.

        A yielded signal may view a slot that is recycled when the next
        item is asked for: copy it before advancing."""
        return self._stream(base_dir, fns, prefetch, _pool_signal_one, (),
                            _signal_from_slot)

    def _stream(self, base_dir: str, fns, prefetch: int, job, spec: tuple,
                unpack):
        """The ordered, bounded fan-out of ``job(path, buf, *spec)``, inline
        or on the workers (``_pool_chunk``); ``unpack(buf, payload)`` turns
        a payload left in a slot into the read."""
        if self._pool is None:
            for fn in fns:
                payload, err, fb = job(os.path.join(base_dir, fn),
                                       self._inline_buf, *spec)
                self.native_fallbacks += fb
                if isinstance(payload, tuple):
                    with trace.span("pool.unpack"):
                        payload = unpack(self._inline_buf, payload)
                yield fn, payload, err
            return
        free = collections.deque(range(len(self._slot_paths)))
        queue: collections.deque = collections.deque()

        def submit(chunk_fns):
            with trace.span("pool.submit"):
                slots = [free.popleft() if free else -1 for _ in chunk_fns]
                fut = self._pool.apply_async(_pool_chunk, (
                    job, [os.path.join(base_dir, fn) for fn in chunk_fns],
                    [self._slot_paths[s] if s >= 0 else None for s in slots],
                    *spec))
                queue.append((chunk_fns, slots, fut))

        def emit(chunk_fns, slots, fut):
            with trace.span("pool.wait"):
                results, worker_s = fut.get()
            trace.count("pool.worker_s", worker_s)
            trace.count("pool.worker_reads", len(results))
            for fn, slot, (payload, err, fb) in zip(chunk_fns, slots, results):
                self.native_fallbacks += fb
                if isinstance(payload, tuple):
                    with trace.span("pool.unpack"):
                        payload = unpack(self._slot_maps[slot], payload)
                yield fn, payload, err
                if slot >= 0:
                    free.append(slot)      # recycled once the caller advances

        pending: list = []
        max_chunks = max(2, prefetch // max(self.chunk, 1))
        for fn in fns:
            pending.append(fn)
            if len(pending) >= self.chunk:
                submit(pending)
                pending = []
            if queue and (len(queue) >= max_chunks or len(free) < self.chunk):
                yield from emit(*queue.popleft())
        if pending:
            submit(pending)
        while queue:
            yield from emit(*queue.popleft())

    def close(self) -> None:
        if self._pool is not None:
            self._pool.terminate()
            self._pool.join()
            self._pool = None
        self._slot_maps = []
        for path in self._slot_paths:
            try:
                os.unlink(path)
            except OSError:
                pass
        self._slot_paths = []

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
