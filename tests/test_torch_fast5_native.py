"""The port's native fast5 ingest (``nr_fast5_compact`` through
``signal.host_prep.compact_fast5``) against the Python path and the JAX
package (CPU; g++ builds the host library, h5py writes the files).

* Parity grid: every file compacts in one library call, bit for bit equal
  (bases, csig, pos0, vlen, feats, shift, scale) to
  ``compact_read(get_read_data(p))`` and to the JAX package's
  ``compact_fast5(p)`` (libhdf5 there), with ``native_fallbacks()``
  unchanged. Files: the port's writer (contiguous, and chunked with gzip and
  shuffle); h5py ``libver="earliest"`` with 64-sample Signal chunks, so the
  chunk B-tree has an internal level; h5py ``libver="latest"`` (superblock
  v3, v2 object headers, link messages, v3 attributes, a variable-length
  UTF-8 ``version``); legacy files (no ``version``, ``"0.0"``) with event
  times in seconds and ``start_time`` as u8 and f8; ``"0.0-rc.5"``, which
  the Python rule reads as not legacy (the JAX C++ reads it as legacy, fails
  on the signal length and falls back to h5py, so there the JAX reference
  is its h5py path, and the test checks that it does fall back); an Albacore-like Events
  dtype (f8 mean/stdv, u8 start/length, extra members, move-2 events).
  On the two files in legacy seconds the JAX reference is its h5py decode
  path (``compact_read(get_read_data(p))`` of the JAX package): the JAX
  library is built with ``-march=native`` and GCC's default contraction,
  so its ``start * 4000.0 - start_time`` is one fused multiply-add, and its
  ``compact_fast5`` differs there from its own Python path (the count of
  differing starts is printed); the port rounds twice, as numpy does.
  Where the Events store f4 the result also equals ``compact_read_numpy``;
  with f8 means the f16 features of columns 4-5 may differ from it by the
  double rounding f8 -> f4 -> f16 that the JAX package's native path shares
  (counted and printed, not asserted zero).
* The JAX package's library is loaded from a complete file: the JAX package
  builds ``libnanorev.so`` lazily and in place, so a test worker that loads
  it while another writes it fails, and its loader gives up for the life of
  the process; ``compact_fast5`` then takes its h5py path, whose features
  differ by one f16 ULP on f8 event moments. The ``jax_native`` fixture
  (``tests/torch_jax_native.py``) compiles the same source with the same
  flags into a private directory unless this process already holds the
  library, and every JAX ``compact_fast5`` that must be native fails loudly
  if it falls back.
* Bad reads fail with the Python path's ``Fast5Error`` text and count no
  fallback; the library's return code names the reason. A too-small ``out``
  is retried once. Seeded truncations and byte flips never crash or hang
  the library, and a read it returns equals the Python path's.
* Without libz (a process whose ``libz.so.1`` lacks zlib's symbols) a
  compressed file returns ``NO_ZLIB`` and a contiguous one still reads.
* A ``PrepPool`` of 2 workers over gzip reads equals the inline path; h5py
  reads back what the port writes chunked with gzip and shuffle.
"""

import dataclasses
import os
import subprocess

import h5py
import numpy as np
import pytest

import nanoreviser_tpu.io as jio
import nanoreviser_tpu.signal.host_prep as jprep
from nanoreviser_torch import native
from nanoreviser_torch.infer.hostpipe import PrepPool
from nanoreviser_torch.io import fast5, get_read_data
from nanoreviser_torch.io import hdf5
from nanoreviser_torch.io.fast5 import Fast5Error
from nanoreviser_torch.io.synthetic import (
    EVENT_DTYPE, synthetic_read_arrays, write_synthetic_dir, write_synthetic_fast5)
from nanoreviser_torch.signal import host_prep
from tests.torch_jax_native import jax_native  # noqa: F401 (fixture)
from tests.torch_threads import one_torch_thread  # noqa: F401 (fixture)

GROUP = "/Analyses/Basecall_1D_000"
EVENTS = GROUP + "/BaseCalled_template/Events"
ALBACORE_DTYPE = np.dtype([
    ("mean", "<f8"), ("start", "<u8"), ("stdv", "<f8"), ("length", "<u8"),
    ("model_state", "S5"), ("move", "<i8"), ("weights", "<f8"),
    ("p_model_state", "<f8")])
LEGACY_DTYPE = np.dtype([
    ("start", "<f8"), ("length", "<f8"), ("mean", "<f4"), ("stdv", "<f4"),
    ("model_state", "S5"), ("move", "<i4")])


def _write_h5py(path, arrays, libver="earliest", version=b"2.3.1",
                start_time=np.uint64(1000), events=None, chunks=None):
    """One read through h5py: ``version`` None (absent), bytes (fixed
    string), str (variable-length UTF-8) or ("ascii", bytes) (variable-length
    ASCII); ``chunks`` (events, signal) rows with gzip and shuffle."""
    _, ev, signal, _, _ = arrays
    ev = ev if events is None else events
    kw = ({}, {}) if chunks is None else tuple(
        {"chunks": (c,), "compression": "gzip", "shuffle": True} for c in chunks)
    with h5py.File(path, "w", libver=libver) as f:
        g = f.create_group(GROUP)
        if isinstance(version, tuple):
            g.attrs.create("version", version[1], dtype=h5py.string_dtype("ascii"))
        elif version is not None:
            g.attrs["version"] = np.bytes_(version) if isinstance(version, bytes) else version
        f.create_dataset(EVENTS, data=ev, **kw[0])
        r = f.create_group("/Raw/Reads/Read_7")
        r.attrs["start_time"] = start_time
        r.attrs["read_number"] = np.int32(7)
        r.create_dataset("Signal", data=signal, **kw[1])


def _seconds(ev, start_time):
    """The events with start and length in legacy seconds."""
    out = np.zeros(len(ev), LEGACY_DTYPE)
    out["start"] = (ev["start"].astype(np.float64) + float(start_time)) / 4000.0
    out["length"] = ev["length"].astype(np.float64) / 4000.0
    for k in ("mean", "stdv", "model_state", "move"):
        out[k] = ev[k]
    return out


def _albacore(ev, rng):
    out = np.zeros(len(ev), ALBACORE_DTYPE)
    for k in ("start", "length", "model_state", "move"):
        out[k] = ev[k]
    out["mean"] = ev["mean"].astype(np.float64) + rng.random(len(ev)) * 1e-3
    out["stdv"] = ev["stdv"].astype(np.float64) + rng.random(len(ev)) * 1e-3
    out["weights"] = rng.random(len(ev))
    out["p_model_state"] = rng.random(len(ev))
    return out


CASES = ["port_contiguous", "port_gzip", "h5py_earliest_gzip_btree2",
         "h5py_latest", "legacy_no_version_u8", "legacy_0.0_f8",
         "version_0.0-rc.5", "albacore_f8"]
LEGACY_SECONDS = ("legacy_no_version_u8", "legacy_0.0_f8")


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("fast5_native")
    rng = np.random.default_rng(808)
    out = {}
    for name in CASES:
        p = str(d / f"{name}.fast5")
        out[name] = p
        if name.startswith("port_"):
            write_synthetic_fast5(p, int(rng.integers(2000, 3000)), rng, 3,
                                  compression="gzip" if name == "port_gzip" else None)
            continue
        arrays = synthetic_read_arrays(int(rng.integers(2000, 3000)), rng)
        ev = arrays[1]
        if name == "h5py_earliest_gzip_btree2":
            _write_h5py(p, arrays, chunks=(100, 64))
        elif name == "h5py_latest":
            _write_h5py(p, arrays, libver="latest", version="2.3.1")
        elif name == "legacy_no_version_u8":
            _write_h5py(p, arrays, version=None, start_time=np.uint64(123457),
                        events=_seconds(ev, 123457))
        elif name == "legacy_0.0_f8":
            _write_h5py(p, arrays, version=("ascii", b"0.0"),
                        start_time=np.float64(98765.5), events=_seconds(ev, 98765.5),
                        chunks=(300, 4096))
        elif name == "version_0.0-rc.5":
            _write_h5py(p, arrays, version="0.0-rc.5")
        else:
            _write_h5py(p, arrays, events=_albacore(ev, rng), chunks=(256, 8192))
    return out


def _fields(c):
    """The fields of a read, arrays copied (a pool's slot is recycled)."""
    return {f.name: (lambda x: x.copy() if isinstance(x, np.ndarray) else x)(
        getattr(c, f.name)) for f in dataclasses.fields(c)}


def _assert_same(a, b, what):
    for k, x in _fields(a).items():
        y = getattr(b, k)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and x.shape == y.shape, (what, k)
            assert x.tobytes() == y.tobytes(), (what, k)
        else:
            assert x == y, (what, k)


def _jax_compact_fast5_native(p, case, monkeypatch):
    """The JAX package's ``compact_fast5(p)``, failing if it falls back to
    its h5py path (``compact_read(get_read_data(p))``)."""
    def h5py_path(*args, **kwargs):
        raise AssertionError(
            f"{case}: the JAX package's compact_fast5 fell back to its h5py "
            f"path; the bit-for-bit comparison needs its native path")

    with monkeypatch.context() as mp:
        mp.setattr(jprep, "compact_read", h5py_path)
        return jprep.compact_fast5(p)


@pytest.mark.parametrize("case", CASES)
def test_ingest_parity(files, jax_native, monkeypatch, case):
    if not jax_native.hdf5_available():
        pytest.fail("the JAX package's native fast5 path is unavailable "
                    f"(library {jax_native.LIB_PATH})")
    p = files[case]
    fb = host_prep.native_fallbacks()
    got = host_prep.compact_fast5(p)
    assert host_prep.native_fallbacks() == fb
    rd = get_read_data(p)
    assert got.n_bases == rd.n_bases > 1000
    _assert_same(got, host_prep.compact_read(rd), "compact_read(get_read_data)")
    if case == "version_0.0-rc.5":
        # the JAX C++ refuses this file; its compact_fast5 is its h5py path
        with pytest.raises(AssertionError, match="fell back"):
            _jax_compact_fast5_native(p, case, monkeypatch)
        _assert_same(got, jprep.compact_fast5(p), "JAX compact_fast5 (h5py path)")
        _assert_same(got, jprep.compact_read(jio.get_read_data(p)),
                     "JAX compact_read(get_read_data)")
    elif case in LEGACY_SECONDS:
        jax_c = _jax_compact_fast5_native(p, case, monkeypatch)
        jax_py = jprep.compact_read(jio.get_read_data(p))
        _assert_same(got, jax_py, "JAX compact_read(get_read_data)")
        n = min(jax_c.n_bases, jax_py.n_bases)
        print(f"{case}: JAX compact_fast5 has {jax_c.n_bases} bases against "
              f"{jax_py.n_bases} on its h5py path, and "
              f"{int((jax_c.pos0[:n] != jax_py.pos0[:n]).sum())} pos0 differ")
    else:
        _assert_same(got, _jax_compact_fast5_native(p, case, monkeypatch),
                     "JAX compact_fast5")
    ref = host_prep.compact_read_numpy(rd)
    if rd.ab_mean.dtype == np.float32:
        _assert_same(got, ref, "compact_read_numpy")
    else:
        # f8 event moments: one rounding (numpy) against f8 -> f4 -> f16
        diff = got.feats.view(np.uint16) != ref.feats.view(np.uint16)
        print(f"{case}: {int(diff.sum())} of {diff.size} f16 features differ "
              f"from compact_read_numpy")
        assert not diff[:, :4].any()
        assert diff.sum() <= diff.size // 1000
    assert host_prep.native_fallbacks() == fb


def test_one_library_call_reads_valid_files(files, monkeypatch):
    def boom(*args, **kwargs):
        raise AssertionError("get_read_data called")

    want = {k: host_prep.compact_read(get_read_data(files[k]))
            for k in ("port_contiguous", "port_gzip", "h5py_latest")}
    monkeypatch.setattr(fast5, "get_read_data", boom)
    monkeypatch.setattr(host_prep, "get_read_data", boom)
    for k, w in want.items():
        _assert_same(host_prep.compact_fast5(files[k]), w, k)


def test_small_out_retries_once(files, monkeypatch):
    p = files["port_gzip"]
    want = host_prep.compact_fast5(p)
    calls = []
    real = native.fast5_compact_native

    def counted(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(native, "fast5_compact_native", counted)
    fb = host_prep.native_fallbacks()
    small = (np.empty(100, np.int16), np.empty(10, np.int32), np.empty(10, np.uint8),
             np.empty((10, 6), np.float16), np.empty(10, np.uint8))
    _assert_same(host_prep.compact_fast5(p, out=small), want, "retry")
    assert len(calls) == 2 and host_prep.native_fallbacks() == fb
    with pytest.raises(native.NativeError) as exc:
        real(p, "Basecall_1D_000", "BaseCalled_template", out=small)
    assert exc.value.rc == native.CAPACITY
    assert exc.value.need == (want.n_bases, want.n_samples)


def _bad_files(d, rng):
    """name -> (path, basecall group, expected library code)."""
    arrays = synthetic_read_arrays(400, rng)
    _, ev, signal, _, _ = arrays
    out = {}
    p = str(d / "short_events.fast5")
    one = ev[:1].copy()
    one["move"] = 1
    _write_h5py(p, arrays, events=one)
    out["events_too_short"] = (p, "Basecall_1D_000", -4)
    p = str(d / "short_signal.fast5")
    _write_h5py(p, (None, ev, signal[: int(ev["start"][-1])], None, None))
    out["signal_shorter"] = (p, "Basecall_1D_000", -5)
    p = str(d / "good.fast5")
    _write_h5py(p, arrays)
    out["missing_group"] = (p, "Basecall_1D_001", -3)
    p = str(d / "not_hdf5.fast5")
    with open(p, "wb") as fp:
        fp.write(b"this is not an HDF5 file\n" * 8)
    out["not_hdf5"] = (p, "Basecall_1D_000", -3)
    p = str(d / "fletcher32.fast5")
    with h5py.File(p, "w", libver="earliest") as f:
        f.create_group(GROUP).attrs["version"] = np.bytes_(b"2.3.1")
        f.create_dataset(EVENTS, data=ev)
        f.create_dataset("/Raw/Reads/Read_7/Signal", data=signal, chunks=(1000,),
                         fletcher32=True)
    out["fletcher32_filter"] = (p, "Basecall_1D_000", native.SUBSET)
    return out


def test_bad_reads_fail_as_the_python_path(tmp_path):
    for name, (p, group, rc) in _bad_files(tmp_path, np.random.default_rng(9)).items():
        with pytest.raises(native.NativeError) as lib:
            native.fast5_compact_native(p, group, "BaseCalled_template")
        assert lib.value.rc == rc, name
        with pytest.raises(Fast5Error) as want:
            get_read_data(p, group)
        fb = host_prep.native_fallbacks()
        with pytest.raises(Fast5Error) as got:
            host_prep.compact_fast5(p, group)
        assert str(got.value) == str(want.value), name
        assert host_prep.native_fallbacks() == fb, name


def _python_path(p):
    try:
        return host_prep.compact_read(get_read_data(p))
    except Exception as exc:  # noqa: BLE001 — any failure of the Python path
        return exc


def test_corrupt_files_never_crash_and_agree(tmp_path):
    """Truncations and byte flips of a contiguous and a gzip file: the
    library returns a code or a read, and a read equals the Python path's."""
    rng = np.random.default_rng(2027)
    srcs = []
    for comp in (None, "gzip"):
        p = str(tmp_path / f"src_{comp}.fast5")
        write_synthetic_fast5(p, 300, np.random.default_rng(5), 1, compression=comp)
        srcs.append(open(p, "rb").read())
    returned = refused = 0
    p = str(tmp_path / "corrupt.fast5")
    for k in range(100):
        data = bytearray(srcs[k % 2])
        if k % 5 == 0:
            data = data[: int(rng.integers(8, len(data)))]
        else:
            for pos in rng.integers(0, len(data), int(rng.integers(1, 4))):
                data[pos] ^= int(rng.integers(1, 256))
        with open(p, "wb") as fp:
            fp.write(bytes(data))
        try:
            got = host_prep._ingest(p, "Basecall_1D_000", "BaseCalled_template", None)
        except native.NativeError:
            refused += 1
            continue
        returned += 1
        want = _python_path(p)
        assert not isinstance(want, Exception), (k, repr(want))
        _assert_same(got, want, f"corruption {k}")
    assert returned > 0 and refused > 0


NO_ZLIB_DRIVER = r"""
#include <dlfcn.h>
#include <cstdint>
#include <cstdio>
#include <vector>
typedef int64_t (*Ingest)(const char*, const char*, const char*, int, uint8_t*,
                          int64_t, double*, double*, int16_t*, int64_t, int32_t*,
                          uint8_t*, uint16_t*, int64_t*);
int main(int argc, char** argv) {
  void* h = dlopen(argv[1], RTLD_NOW);
  if (!h) return 2;
  auto loaded = reinterpret_cast<int (*)()>(dlsym(h, "nr_zlib_loaded"));
  auto ingest = reinterpret_cast<Ingest>(dlsym(h, "nr_fast5_compact"));
  const int64_t cap = 1 << 16;
  std::vector<uint8_t> bases(cap), vlen(cap);
  std::vector<int32_t> pos0(cap);
  std::vector<uint16_t> feats(6 * cap);
  std::vector<int16_t> csig(50 * cap);
  double shift, scale;
  int64_t counts[2];
  std::printf("%d", loaded());
  for (int i = 2; i < argc; ++i)
    std::printf(" %lld", (long long)ingest(
        argv[i], "Basecall_1D_000", "BaseCalled_template", 50, bases.data(), cap,
        &shift, &scale, csig.data(), 50 * cap, pos0.data(), vlen.data(),
        feats.data(), counts));
  return 0;
}
"""


def test_without_libz_compressed_files_return_their_code(files, tmp_path):
    from nanoreviser_torch.native.build import build

    fake = tmp_path / "fake"
    fake.mkdir()
    (tmp_path / "empty.cpp").write_text("int nr_not_zlib = 0;\n")
    (tmp_path / "driver.cpp").write_text(NO_ZLIB_DRIVER)
    for cmd in (["g++", "-shared", "-fPIC", "-o", str(fake / "libz.so.1"),
                 str(tmp_path / "empty.cpp")],
                ["g++", "-O1", "-o", str(tmp_path / "driver"),
                 str(tmp_path / "driver.cpp"), "-ldl"]):
        subprocess.run(cmd, check=True, capture_output=True)
    out = subprocess.run(
        [str(tmp_path / "driver"), str(build()), files["port_contiguous"],
         files["port_gzip"]], capture_output=True, text=True, check=True, timeout=60,
        env={**os.environ, "LD_LIBRARY_PATH": str(fake)}).stdout.split()
    n_bases = host_prep.compact_fast5(files["port_contiguous"]).n_bases
    assert out == ["0", str(n_bases), str(native.NO_ZLIB)]


def test_pool_over_gzip_reads_matches_inline(tmp_path):
    d = str(tmp_path / "gz")
    names = write_synthetic_dir(d, 4, (300, 800), seed=61, compression="gzip")
    got = {}
    for n_workers in (0, 2):
        with PrepPool(n_workers) as pool:
            got[n_workers] = [(fn, None if w is None else _fields(w), err)
                              for fn, w, err in pool.stream(d, names)]
            assert pool.native_fallbacks == 0
    assert [fn for fn, _, _ in got[2]] == names
    for (fn, a, ea), (_, b, eb) in zip(got[0], got[2]):
        assert ea is None and eb is None, fn
        for k, x in a.items():
            y = b[k]
            assert (x.tobytes() == y.tobytes()) if isinstance(x, np.ndarray) else x == y


def test_h5py_reads_port_chunked_gzip(tmp_path):
    rng = np.random.default_rng(3)
    ev = np.zeros(700, EVENT_DTYPE)
    ev["start"] = np.arange(700) * 9
    ev["mean"] = rng.random(700)
    ev["model_state"] = b"ACGTA"
    ev["move"] = rng.integers(0, 3, 700)
    sig = rng.integers(-3000, 3000, 5000).astype(np.int16)
    big = np.arange(10000, dtype=np.int32)
    p = tmp_path / "w.h5"
    with hdf5.File(p, "w") as f:
        f.create_dataset("a/ev", data=ev, chunks=(256,), compression="gzip", shuffle=True)
        f.create_dataset("a/sig", data=sig, chunks=(64,), compression="gzip", shuffle=True)
        f.create_dataset("a/sig1", data=sig, chunks=(8192,), compression="gzip")
        f.create_dataset("a/big", data=big, chunks=(2,))   # a B-tree of 3 levels
    with h5py.File(p, "r") as g:
        for k, v in (("ev", ev), ("sig", sig), ("sig1", sig), ("big", big)):
            assert g["a/" + k][()].tobytes() == v.tobytes(), k
            for i in rng.integers(0, len(v), 10):        # chunk lookups
                assert g["a/" + k][int(i)].tobytes() == v[int(i)].tobytes(), k
        assert g["a/ev"].compression == "gzip" and g["a/ev"].shuffle
        assert g["a/sig"].chunks == (64,)
    r = hdf5.File(p)
    for k, v in (("ev", ev), ("sig", sig), ("big", big)):
        assert r["a/" + k][()].tobytes() == v.tobytes(), k
