"""The CLI's writer thread (``io.writers.FileWriter``) and the host
library's burst write (``nr_write_files``), on the CPU.

* A writer's files equal ``write_read_fasta`` / ``write_read_fastq``'s byte
  for byte: no, one and many records, the burst cap and one more, names
  with spaces and with non-ASCII characters, a longer file truncated, and
  the file mode under a set umask. No burst exceeds its caps, and a full
  queue holds ``put`` back without losing a file.
* A failed write leaves the burst's other files written, and reads as
  Python's ``open`` error for that path. Where the library cannot be
  loaded, the writer's Python ``open`` gives the same bytes and errors.
* No writer thread starts at import or before the first record, and none
  is left after ``close``.
* The CLI (passthrough and model mode on the CPU, fasta and fastq, with
  ``--merged_output``, a file that is not HDF5 and an output path that is a
  directory) writes the same files, merged file and printed lines as with
  a writer that writes each file at its hand-off on the CLI's thread, as
  the CLI did before; its ``-e`` file holds the same lines, the failed
  write's possibly later. With ``--trace_json`` the writer's counters say
  it wrote every read.
"""

import contextlib
import io
import json
import math
import os
import sys
import threading
import time

import pytest
import torch

from nanoreviser_torch import native
from nanoreviser_torch.io import writers
from nanoreviser_torch.io.synthetic import write_synthetic_dir
from nanoreviser_torch.io.writers import (
    BURST_FILES,
    FileWriter,
    format_read_fasta,
    format_read_fastq,
    write_read_fasta,
    write_read_fastq,
)
from nanoreviser_torch.models import ReviserConfig, init_reviser_params, save_keras_weights
from nanoreviser_torch.models.reviser import randomize_inference_stats
from nanoreviser_torch.native.build import NativeBuildError
from tests.torch_threads import one_torch_thread  # noqa: F401 (fixture)

NAMES = {
    "empty": [],
    "one": ["read_0000.fast5"],
    "many": [f"read_{k:04d}.fast5" for k in range(40)],
    "cap": [f"r{k}.fast5" for k in range(BURST_FILES)],
    "cap_plus_1": [f"r{k}.fast5" for k in range(BURST_FILES + 1)],
    "spaces": ["a read with spaces.fast5", "two  spaces .fast5"],
    "non_ascii": ["réad_ü_0.fast5", "読み取り 1.fast5"],
}


def _record(k: int, fmt: str, n: int = 0):
    """(bases, qual) of record k: lengths 0 to a few thousand."""
    n = n or (k * 997) % 3001
    bases = "".join("ACGT"[(k + 3 * i) % 4] for i in range(n))
    return bases, "".join(chr(33 + (k + i) % 40) for i in range(n)) if fmt == "fastq" else None


def _write_all(out, names, fmt, writer=None):
    """Each record by ``write_read_fasta`` / ``write_read_fastq``, or its
    text handed to ``writer`` as the CLI hands it."""
    os.makedirs(out, exist_ok=True)
    for k, fn in enumerate(names):
        bases, qual = _record(k, fmt)
        path = os.path.join(out, fn.split(".")[0] + "_out." + fmt)
        if writer is not None:
            writer.put(path, format_read_fasta(fn, bases) if fmt == "fasta"
                       else format_read_fastq(fn, bases, qual))
        elif fmt == "fasta":
            write_read_fasta(fn, path, bases)
        else:
            write_read_fastq(fn, path, bases, qual)


def _tree(out) -> dict:
    return {f: open(os.path.join(out, f), "rb").read() for f in sorted(os.listdir(out))}


def _writer_threads() -> list:
    return [t for t in threading.enumerate() if t.name == "nanorev-writer"]


@pytest.mark.parametrize("fmt", ["fasta", "fastq"])
@pytest.mark.parametrize("case", list(NAMES))
def test_writer_matches_write_read(tmp_path, case, fmt):
    names = NAMES[case]
    _write_all(tmp_path / "sync", names, fmt)
    w = FileWriter()
    _write_all(tmp_path / "burst", names, fmt, writer=w)
    w.close()
    assert w.finished() == [None] * len(names)
    assert _tree(tmp_path / "burst") == _tree(tmp_path / "sync")
    assert len(_tree(tmp_path / "burst")) == len(names)
    assert w.files == len(names)
    assert math.ceil(len(names) / BURST_FILES) <= w.bursts <= len(names)


@pytest.mark.parametrize("fmt", ["fasta", "fastq"])
def test_writer_truncates_a_longer_file(tmp_path, fmt):
    for sub in ("sync", "burst"):
        os.makedirs(tmp_path / sub)
        (tmp_path / sub / f"read_0000_out.{fmt}").write_bytes(b"X" * 100_000)
    _write_all(tmp_path / "sync", NAMES["one"], fmt)
    w = FileWriter()
    _write_all(tmp_path / "burst", NAMES["one"], fmt, writer=w)
    w.close()
    got = _tree(tmp_path / "burst")
    assert got == _tree(tmp_path / "sync") and b"X" not in got[f"read_0000_out.{fmt}"]


@pytest.mark.parametrize("umask", [0o022, 0o027, 0o077, 0o000])
def test_writer_file_mode_under_umask(tmp_path, umask):
    old = os.umask(umask)
    try:
        _write_all(tmp_path / "sync", NAMES["many"][:3], "fasta")
        w = FileWriter()
        _write_all(tmp_path / "burst", NAMES["many"][:3], "fasta", writer=w)
        w.close()
    finally:
        os.umask(old)
    for f in os.listdir(tmp_path / "sync"):
        want = os.stat(tmp_path / "sync" / f).st_mode
        assert os.stat(tmp_path / "burst" / f).st_mode == want == (0o100666 & ~umask)


def _open_error(path) -> str:
    try:
        with open(path, "w") as fp:
            fp.write("x")
    except OSError as exc:
        return str(exc)
    raise AssertionError(f"{path} could be written")


@pytest.fixture(params=["library", "python"])
def engine(request, monkeypatch):
    """The writer's two ways to write: the library, or Python's ``open``
    where the library cannot be loaded."""
    if request.param == "python":
        def unloadable():
            raise NativeBuildError("no library here")

        def unused(*args):
            raise AssertionError("the library was called")

        monkeypatch.setattr(native, "load", unloadable)
        monkeypatch.setattr(native, "write_files_native", unused)
    return request.param


def test_failed_write_spares_the_rest(tmp_path, engine):
    (tmp_path / "a_dir").mkdir()
    paths = [tmp_path / "ok0", tmp_path / "no_such_dir" / "x", tmp_path / "ok1",
             tmp_path / "a_dir", tmp_path / "ok2"]
    bad = {1, 3}
    w = FileWriter()
    for k, p in enumerate(paths):
        w.put(str(p), f">r{k}\nACGT")
    w.close()
    errs = w.finished()
    assert len(errs) == len(paths)
    for k, (p, err) in enumerate(zip(paths, errs)):
        if k in bad:
            assert isinstance(err, OSError)
            assert str(err) == _open_error(str(p))
        else:
            assert err is None and p.read_bytes() == f">r{k}\nACGT".encode()


@pytest.mark.parametrize("fmt", ["fasta", "fastq"])
def test_python_open_gives_the_same_bytes(tmp_path, engine, fmt):
    names = NAMES["many"] + NAMES["spaces"] + NAMES["non_ascii"]
    _write_all(tmp_path / "sync", names, fmt)
    w = FileWriter()
    _write_all(tmp_path / "burst", names, fmt, writer=w)
    w.close()
    assert w.finished() == [None] * len(names)
    assert _tree(tmp_path / "burst") == _tree(tmp_path / "sync")


def test_caps_and_backpressure(tmp_path, monkeypatch):
    """Bursts of at most two 10 kB files and a queue of 30 kB: every file
    written, in as many bursts as the cap needs at least."""
    size, n = 10_000, 60
    monkeypatch.setattr(writers, "BURST_BYTES", int(2.5 * size))
    monkeypatch.setattr(writers, "QUEUE_BYTES", 3 * size)
    w = FileWriter()
    for k in range(n):
        w.put(str(tmp_path / f"f{k}"), chr(65 + k % 26) * size)
    w.close()
    assert w.finished() == [None] * n
    assert w.files == n and w.bursts >= n // 2 and w.busy_s > 0.0
    for k in range(n):
        assert (tmp_path / f"f{k}").read_bytes() == chr(65 + k % 26).encode() * size


def test_stress_many_writers_short_switch_interval(tmp_path, monkeypatch):
    """More writers than cores, each fed by a thread of its own, bursts of
    at most 3 files and a queue of 2 kB, with the interpreter switching
    threads every microsecond: every file written once, in order, and no
    byte left counted as queued."""
    monkeypatch.setattr(writers, "BURST_FILES", 3)
    monkeypatch.setattr(writers, "QUEUE_BYTES", 2_000)
    n_writers, n = len(os.sched_getaffinity(0)) + 2, 150
    ws = [FileWriter() for _ in range(n_writers)]

    def feed(j, w):
        for k in range(n):
            w.put(str(tmp_path / f"w{j}_{k}"), f">{j} {k}\n" + "ACGT" * (k % 50))
        w.close()

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        feeders = [threading.Thread(target=feed, args=(j, w)) for j, w in enumerate(ws)]
        for t in feeders:
            t.start()
        for t in feeders:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in feeders)
    for j, w in enumerate(ws):
        assert w.finished() == [None] * n and w.files == n and w._queued == 0
        assert w.bursts >= n // 3
        for k in range(n):
            got = (tmp_path / f"w{j}_{k}").read_text()
            assert got == f">{j} {k}\n" + "ACGT" * (k % 50)


def test_idle_writer_uses_no_cpu(tmp_path):
    """Between records the writer's thread waits on its condition: it
    spends no CPU time while nothing is queued (no polling, no spinning)."""
    w = FileWriter()
    w.put(str(tmp_path / "f"), "x")
    deadline = time.monotonic() + 30
    while not w.finished() and time.monotonic() < deadline:
        time.sleep(0.01)
    clock = time.pthread_getcpuclockid(w._thread.ident)
    cpu = time.clock_gettime(clock)
    time.sleep(0.5)
    idle_cpu = time.clock_gettime(clock) - cpu
    w.close()
    assert idle_cpu < 0.005, idle_cpu


def test_no_thread_before_the_first_record_or_after_close(tmp_path):
    import nanoreviser_torch.cli.reviser  # noqa: F401 — nothing starts at import

    assert not _writer_threads()
    w = FileWriter()
    assert not _writer_threads()
    w.put(str(tmp_path / "f"), "x")
    assert len(_writer_threads()) == 1
    w.close()
    assert not _writer_threads() and w.finished() == [None]


class SyncWriter:
    """The writer's interface, writing each file at its hand-off on the
    caller's thread with ``open(path, "w")``, as the CLI did before it had
    a writer thread."""

    files = bursts = 0
    busy_s = 0.0

    def __init__(self):
        self._done = []

    def put(self, path, text):
        try:
            with open(path, "w") as fp:
                fp.write(text)
            self._done.append(None)
        except OSError as exc:
            self._done.append(exc)

    def finished(self):
        out, self._done = self._done, []
        return out

    def close(self):
        pass


BAD = "read_0002_not_hdf5.fast5"
UNWRITABLE = "read_0003"            # its output path is a directory


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    d = tmp_path_factory.mktemp("writer_cli")
    fast5 = str(d / "fast5")
    names = write_synthetic_dir(fast5, 7, (150, 500), seed=51)
    with open(os.path.join(fast5, BAD), "wb") as fp:
        fp.write(b"this is not an HDF5 file\n" * 8)
    paths = []
    for k, nc in enumerate((6, 5)):
        gen = torch.Generator().manual_seed(510 + k)
        p = randomize_inference_stats(
            init_reviser_params(gen, ReviserConfig(window=11, n_classes=nc)), gen)
        paths.append(str(d / f"m{k + 1}.h5"))
        save_keras_weights(p, paths[-1], 11, nc)
    return d, fast5, names, paths


def _cli(folder, tag, mode, fmt, *extra):
    """(rc, printed lines, output files, -e lines) of one CLI run."""
    from nanoreviser_torch.cli.reviser import main

    d, fast5, _, paths = folder
    out, failed = d / f"out_{tag}", d / f"failed_{tag}.txt"
    os.makedirs(out / f"{UNWRITABLE}_out.{fmt}")
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        rc = main(["-d", fast5, "-o", str(out), "-F", fmt, "--revise_mode", mode,
                   "--device", "cpu", "--thread", "2", "--align", "center",
                   "--model1_predict_dir", paths[0], "--model2_predict_dir", paths[1],
                   "--merged_output", str(out / "merged.txt"), "-e", str(failed),
                   *extra])
    lines = [ln.replace(str(out), "<out>") for ln in printed.getvalue().splitlines()
             if not ln.startswith("[s:::] NanoReviser time consuming")]
    files = {f: (out / f).read_bytes() for f in sorted(os.listdir(out))
             if (out / f).is_file()}
    errs = [ln.replace(str(out), "<out>") for ln in failed.read_text().splitlines()]
    return rc, lines, files, errs


@pytest.mark.parametrize("fmt", ["fasta", "fastq"])
@pytest.mark.parametrize("mode", ["passthrough", "model"])
def test_cli_writes_as_the_synchronous_writer(folder, monkeypatch, mode, fmt):
    rc, lines, files, errs = _cli(folder, f"{mode}_{fmt}_burst", mode, fmt)
    with monkeypatch.context() as m:
        m.setattr(writers, "FileWriter", SyncWriter)
        want = _cli(folder, f"{mode}_{fmt}_sync", mode, fmt)
    assert (rc, lines, files) == want[:3]
    names = folder[2]
    reads = [f for f in files if f != "merged.txt"]
    assert rc == 1 and len(reads) == len(names) - 1
    assert files["merged.txt"] == b"".join(files[f] + b"\n" for f in reads)
    # the failed write's line may come later; the others keep their order
    assert sorted(errs) == sorted(want[3])
    assert [e for e in errs if not e.startswith(UNWRITABLE)] == [
        e for e in want[3] if not e.startswith(UNWRITABLE)]
    assert [e.split("\t")[0] for e in sorted(errs)] == [BAD, UNWRITABLE + ".fast5"]
    assert any("Is a directory" in ln and UNWRITABLE in ln for ln in lines)


@pytest.mark.parametrize("mode", ["passthrough", "model"])
def test_cli_trace_counts_the_writers_files(folder, mode):
    d = folder[0]
    path = d / f"trace_{mode}.json"
    rc, _, files, _ = _cli(folder, f"{mode}_traced", mode, "fasta",
                           "--trace_json", str(path))
    got = json.loads(path.read_text())
    c, calls = got["counters"], got["span_calls"]
    written = len(files) - 1                                # less the merged file
    assert rc == 1 and written == len(folder[2]) - 1
    assert c["writer.files"] == written + 1                 # + the unwritable path
    assert 1 <= c["writer.bursts"] <= c["writer.files"]
    assert c["writer.busy_s"] > 0.0
    assert calls["cli.write_join"] == 1
    assert calls["cli.write"] == calls["cli.emit"] == written + 1
