"""Bit-exact fasta/fastq emission.

The reference has two distinct fasta writers with different quirks; both are
reproduced here because the unitest goldens are byte-exact against them:

* Inference output (reference output_handeler.py:26-45): header is the fast5
  *basename* with spaces replaced by ``|||``; NO trailing newline after the
  sequence.
* Training tmp fasta (reference nanorevtrainutils.py:36-53): header is the
  FULL fast5 path (spaces -> ``|||``); WITH a trailing newline.
* Fastq (reference output_handeler.py:48-62): ``@name\\nseq+\\nqual`` — note
  the missing newline between the sequence and the ``+`` separator, faithfully
  reproduced.

``write_read_fasta`` / ``write_read_fastq`` write one file at once; the
CLI hands its files' texts to a :class:`FileWriter` instead, whose thread
writes them with the same bytes, mode and errors.
"""

from __future__ import annotations

import collections
import locale
import os
import threading
import time

from ..utils import trace

BURST_FILES = 256           # the most files one burst writes
BURST_BYTES = 32 << 20      # ... and the most bytes, unless one file has more
QUEUE_BYTES = 64 << 20      # bytes handed over and not yet written, past
                            # which ``put`` waits


def format_read_fasta(fast5_fn: str, bases: str) -> str:
    name = str(fast5_fn).split("/")[-1].replace(" ", "|||")
    return ">" + name + "\n" + bases


def format_read_fastq(fast5_fn: str, bases: str, qual: str) -> str:
    name = str(fast5_fn).split("/")[-1].replace(" ", "|||")
    return "@" + name + "\n" + bases + "+\n" + qual


def format_train_fasta(fast5_fn: str, bases: str) -> str:
    return ">" + str(fast5_fn).replace(" ", "|||") + "\n" + bases + "\n"


def _write(path: str | os.PathLike, text: str) -> None:
    parent = os.path.dirname(str(path))
    if parent:
        os.makedirs(parent, exist_ok=True)
    with open(path, "w") as fp:
        fp.write(text)


def write_read_fasta(fast5_fn: str, out_fn: str | os.PathLike, bases: str) -> None:
    _write(out_fn, format_read_fasta(fast5_fn, bases))


def write_read_fastq(
    fast5_fn: str, out_fn: str | os.PathLike, bases: str, qual: str
) -> None:
    _write(out_fn, format_read_fastq(fast5_fn, bases, qual))


class FileWriter:
    """Writes files on one thread of its own, in the order they are handed
    over and in bursts: whatever has queued up, at most ``BURST_FILES``
    files and ``BURST_BYTES`` bytes, in one call of the host library's
    ``nr_write_files``, which holds no GIL while the filesystem works.
    Where the library cannot be loaded, the thread writes with Python's
    ``open`` instead. The parent directory of every file must exist.

    * ``put(path, text)`` encodes the text as ``open(path, "w")`` would on
      Linux (its encoding, no newline translation) and queues it. While
      ``QUEUE_BYTES`` are queued it waits (span ``cli.write_wait``), so a
      slow filesystem holds the caller back instead of filling memory.
    * ``finished()``: each file written since its last call, in order, as
      None or the ``OSError`` that ``open(path, "w")`` would have raised.
    * ``close()`` waits for every file and ends the thread.

    The thread starts at the first ``put`` and waits on a condition, never
    on a timer. ``files``, ``bursts`` and ``busy_s`` (its seconds in the
    writes) are its totals; read them after ``close``."""

    def __init__(self):
        self._encoding = locale.getpreferredencoding(False)   # open()'s default
        self.files = self.bursts = 0
        self.busy_s = 0.0
        self._cond = threading.Condition()
        self._queue: collections.deque = collections.deque()  # (path, bytes)
        self._queued = 0        # bytes queued or in the burst being written
        self._done: list = []
        self._closing = False
        self._thread = None

    def put(self, path: str | os.PathLike, text: str) -> None:
        path = os.fspath(path)
        if "\0" in path:
            raise ValueError("embedded null byte")      # what open() raises
        data = text.encode(self._encoding)
        with self._cond:
            if self._thread is None:
                self._thread = threading.Thread(target=self._run, daemon=True,
                                                name="nanorev-writer")
                self._thread.start()
            if self._queued and self._queued + len(data) > QUEUE_BYTES:
                with trace.span("cli.write_wait"):
                    while self._queued and self._queued + len(data) > QUEUE_BYTES:
                        self._cond.wait()
            self._queue.append((path, data))
            self._queued += len(data)
            self._cond.notify_all()

    def finished(self) -> list:
        with self._cond:
            out, self._done = self._done, []
        return out

    def close(self) -> None:
        with self._cond:
            self._closing = True
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join()

    def _run(self) -> None:
        try:
            from .. import native

            native.load()
            write = native.write_files_native
        except (RuntimeError, OSError):   # no compiler or library: Python's open
            write = None
        while True:
            with self._cond:
                while not self._queue and not self._closing:
                    self._cond.wait()
                if not self._queue:
                    return
                burst = [self._queue.popleft()]
                size = len(burst[0][1])
                while (self._queue and len(burst) < BURST_FILES
                       and size + len(self._queue[0][1]) <= BURST_BYTES):
                    burst.append(self._queue.popleft())
                    size += len(burst[-1][1])
            t = time.perf_counter()
            try:
                errs = _write_burst(write, burst)
            except Exception as exc:  # noqa: BLE001 — each file reports it
                errs = [exc] * len(burst)
            dt = time.perf_counter() - t
            with self._cond:
                self._done.extend(errs)
                self._queued -= size
                self.files += len(burst)
                self.bursts += 1
                self.busy_s += dt
                self._cond.notify_all()


def _write_burst(write, burst: list) -> list:
    """Each file's None or OSError, written by ``write`` (the library's
    ``write_files_native``) or, where it is None, by Python's ``open``."""
    if write is not None:
        paths = [p for p, _ in burst]
        codes = write(paths, [d for _, d in burst])
        return [OSError(e, os.strerror(e), p) if e else None
                for p, e in zip(paths, codes)]
    errs = []
    for path, data in burst:
        try:
            with open(path, "wb") as fp:
                fp.write(data)
            errs.append(None)
        except OSError as exc:
            errs.append(exc)
    return errs
