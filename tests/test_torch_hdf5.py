"""The port's own HDF5 reader/writer (nanoreviser_torch/io/hdf5.py) vs h5py.

Files the port writes must read back identically through h5py (the HDF5
library), and files h5py writes (default and latest formats, chunked +
compressed datasets, variable-length strings) must read identically
through the port.
"""

import h5py
import numpy as np
import pytest

from nanoreviser_torch.io import hdf5
from nanoreviser_torch.io.synthetic import EVENT_DTYPE
from tests.torch_threads import one_torch_thread  # noqa: F401 (fixture)


def _events(n, rng):
    ev = np.zeros(n, EVENT_DTYPE)
    ev["start"] = np.cumsum(rng.integers(5, 15, n))
    ev["length"] = rng.integers(5, 15, n)
    ev["mean"] = rng.normal(450, 40, n)
    ev["stdv"] = rng.random(n)
    ev["model_state"] = [bytes(rng.choice(list(b"ACGT"), 5)) for _ in range(n)]
    ev["move"] = rng.integers(0, 3, n)
    return ev


def test_port_writes_what_h5py_reads(tmp_path):
    rng = np.random.default_rng(0)
    ev = _events(50, rng)
    sig = rng.integers(-2000, 2000, 777).astype(np.int16)
    weights = {f"layer_{i:02d}/w/kernel:0": rng.random((i + 1, 3)).astype(np.float32)
               for i in range(21)}                 # > 8 members: several nodes
    path = tmp_path / "w.h5"
    with hdf5.File(path, "w") as f:
        f.attrs["names"] = np.array([b"a", b"bcd"])
        f.attrs["ver"] = "2.3.1"
        f.attrs["t0"] = np.uint64(12345)
        f.create_group("/Analyses/Basecall_1D_000").attrs["version"] = b"1.0"
        f.create_dataset("/Analyses/Basecall_1D_000/T/Events", data=ev)
        f.create_dataset("/Analyses/Basecall_1D_000/T/Fastq",
                         data=np.bytes_(b"@r\nAC\n+\n!!\n"))
        f.create_dataset("/Raw/Reads/Read_9/Signal", data=sig)
        f.create_dataset("/empty", data=np.zeros((0, 4), np.float16))
        for k, v in weights.items():
            f.create_dataset(k, data=v)
    with h5py.File(path, "r") as g:
        assert list(g.attrs["names"]) == [b"a", b"bcd"]
        assert g.attrs["ver"] == b"2.3.1" and g.attrs["t0"] == 12345
        assert g["Analyses/Basecall_1D_000"].attrs["version"] == b"1.0"
        assert g["Analyses/Basecall_1D_000/T/Events"][()].tobytes() == ev.tobytes()
        assert g["Analyses/Basecall_1D_000/T/Fastq"][()] == b"@r\nAC\n+\n!!\n"
        np.testing.assert_array_equal(g["Raw/Reads/Read_9/Signal"][()], sig)
        assert g["empty"].shape == (0, 4)
        for k, v in weights.items():
            np.testing.assert_array_equal(g[k][()], v)
    f = hdf5.File(path)
    assert f["/Raw/Reads/"].keys() == ["Read_9"]
    assert f["Analyses/Basecall_1D_000/T/Events"][()].tobytes() == ev.tobytes()
    assert f["Analyses/Basecall_1D_000/T/Fastq"][()] == b"@r\nAC\n+\n!!\n"
    assert f.attrs["ver"] == b"2.3.1"
    for k, v in weights.items():
        np.testing.assert_array_equal(np.asarray(f[k]), v)


@pytest.mark.parametrize("libver", ["earliest", "latest"])
def test_port_reads_what_h5py_writes(tmp_path, libver):
    rng = np.random.default_rng(1)
    ev = _events(40, rng)
    path = tmp_path / "r.h5"
    with h5py.File(path, "w", libver=libver) as g:
        g.attrs["fixed"] = np.array([b"x", b"yz"])
        g.attrs["utf8"] = "café"
        g.attrs["ascii"] = b"abc"
        g.attrs["f"] = np.float64(2.5)
        g.create_dataset("a/b/ev", data=ev)
        g.create_dataset("sig", data=np.arange(5000, dtype=np.int16))
        if libver == "earliest":
            g.create_dataset("gz", data=np.arange(9000, dtype=np.int16),
                             chunks=(1000,), compression="gzip", shuffle=True)
            g.create_dataset("gz2", data=np.arange(391.0).reshape(17, 23),
                             chunks=(5, 7), compression="gzip")
        # the latest format moves groups of more than 8 links to dense
        # storage (a fractal heap), which the port does not read
        n_members = 12 if libver == "earliest" else 5
        for i in range(n_members):
            g.create_dataset(f"m/{i}", data=np.full(3, i, np.int32))
    f = hdf5.File(path)
    assert list(f.attrs["fixed"]) == [b"x", b"yz"]
    assert f.attrs["utf8"] == "café" and f.attrs["ascii"] == b"abc"
    assert f.attrs["f"] == 2.5
    assert f["a/b/ev"][()].tobytes() == ev.tobytes()
    np.testing.assert_array_equal(f["sig"][()], np.arange(5000))
    if libver == "earliest":
        np.testing.assert_array_equal(f["gz"][()], np.arange(9000))
        np.testing.assert_array_equal(f["gz2"][()], np.arange(391.0).reshape(17, 23))
    assert [int(f[f"m/{i}"][0]) for i in range(n_members)] == list(range(n_members))
    assert "a/b" in f and "nope" not in f
