"""Port host side vs the JAX package on synthetic fast5 reads (CPU).

fast5 decode, compaction, wire encode, the merges and the writers must give
identical arrays and bytes in both packages.
"""

import dataclasses
import os

import numpy as np
import pytest

import nanoreviser_tpu.infer.merge as jmerge
import nanoreviser_tpu.infer.wire as jwire
import nanoreviser_tpu.io as jio
import nanoreviser_tpu.signal.host_prep as jprep
from nanoreviser_tpu.signal.segmentation import (
    mad_normalizers_int16 as jax_mad_int16,
)
import nanoreviser_torch.infer.merge as tmerge
import nanoreviser_torch.infer.wire as twire
import nanoreviser_torch.io as tio
import nanoreviser_torch.signal.host_prep as tprep
from nanoreviser_torch.io.synthetic import write_synthetic_dir
from nanoreviser_torch.signal.segmentation import mad_normalizers_int16
from tests.torch_threads import one_torch_thread  # noqa: F401 (fixture)


@pytest.fixture(scope="module")
def fast5_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("fast5")
    write_synthetic_dir(d, 6, (150, 900), seed=7)
    return str(d)


def _fields_equal(a, b):
    assert type(a).__name__ == type(b).__name__
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and x.shape == y.shape, f.name
            assert x.tobytes() == y.tobytes(), f.name
        else:
            assert x == y, f.name


def test_fast5_compact_encode_identical(fast5_dir):
    assert tio.list_fast5_files(fast5_dir) == jio.list_fast5_files(fast5_dir)
    n_esc = np.zeros(4, int)
    for fn in tio.list_fast5_files(fast5_dir):
        path = os.path.join(fast5_dir, fn)
        rt, rj = tio.get_read_data(path), jio.get_read_data(path)
        _fields_equal(rt, rj)
        assert tio.extract_fastq(path) == jio.extract_fastq(path)
        tail = rt.signal[rt.read_start_rel_to_raw :]
        assert mad_normalizers_int16(tail) == jax_mad_int16(tail)
        ct, cj = tprep.compact_read_numpy(rt), jprep.compact_read_numpy(rj)
        _fields_equal(ct, cj)
        wt, wj = twire.encode_read(ct), jwire.encode_read(cj)
        _fields_equal(wt, wj)
        n_esc += [len(wt.sig_esc_idx), len(wt.vlen_esc_idx),
                  len(wt.dur_esc_idx), len(wt.col_esc_idx)]
    # the synthetic reads exercise every escape list of the wire format
    assert (n_esc > 0).all(), n_esc


def test_wire_tables_and_read_tables_identical():
    for name in ("DUR_TABLE_F16", "COLOR_TABLE_F16", "CODE_OF_BASE"):
        a, b = getattr(twire, name), getattr(jwire, name)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), name
    assert (twire.ESC, int(twire.DROP), twire.MAX_BOUNDARY_DELTA) == (
        jwire.ESC, int(jwire.DROP), jwire.MAX_BOUNDARY_DELTA)
    from nanoreviser_tpu.ops.window_gather import pack_read_tables

    rng = np.random.default_rng(0)
    shifts = rng.uniform(300, 600, 37).astype(np.float32)
    scales = rng.uniform(5, 80, 37).astype(np.float32)
    t = twire.pack_read_tables(shifts, scales)
    j = pack_read_tables(shifts, scales)
    assert t.dtype == np.uint16 and t.tobytes() == j.tobytes()
    codes = rng.integers(0, 4, 64).astype(np.uint8)
    assert twire.pack_codes2(codes).tobytes() == jwire.pack_codes2(codes).tobytes()
    with pytest.raises(twire.WireEncodeError):
        twire.validate_chain_bounds(5, 0, 10)


@pytest.mark.parametrize("align", ["reference", "center"])
def test_merges_identical(align):
    rng = np.random.default_rng(1)
    for n in (20, 200):
        bases = "".join(rng.choice(list("ACGTN"), n, p=[.24, .24, .24, .24, .04]))
        y1 = rng.integers(0, 6, n - 11)
        y2 = rng.integers(0, 5, n - 11)
        q1 = rng.integers(0, 94, n - 11).astype(np.uint8)
        q2 = rng.integers(0, 94, n - 11).astype(np.uint8)
        for off in (None, 4):
            assert tmerge.merge_revision(
                bases, y1, y2, align=align, window=11, center_offset=off
            ) == jmerge.merge_revision(
                bases, y1, y2, align=align, window=11, center_offset=off)
            assert tmerge.merge_revision_with_quality(
                bases, y1, y2, q1, q2, align=align, window=11, center_offset=off
            ) == jmerge.merge_revision_with_quality(
                bases, y1, y2, q1, q2, align=align, window=11, center_offset=off)
        for min_n in (8, 64):
            assert tmerge.calibrate_center_offset(bases, y1, 11, min_n=min_n) == \
                jmerge.calibrate_center_offset(bases, y1, 11, min_n=min_n)


def test_writers_identical(tmp_path):
    names = ["dir/a read.fast5", "b.fast5"]
    for fn in names:
        assert tio.format_read_fasta(fn, "ACGT") == jio.format_read_fasta(fn, "ACGT")
        assert tio.format_read_fastq(fn, "ACGT", "!!!!") == \
            jio.format_read_fastq(fn, "ACGT", "!!!!")
        assert tio.format_train_fasta(fn, "AC") == jio.format_train_fasta(fn, "AC")
    tio.write_read_fastq(names[0], tmp_path / "t" / "x.fastq", "ACG", "III")
    jio.write_read_fastq(names[0], tmp_path / "j" / "x.fastq", "ACG", "III")
    assert (tmp_path / "t" / "x.fastq").read_bytes() == \
        (tmp_path / "j" / "x.fastq").read_bytes()
    tio.write_read_fasta(names[1], tmp_path / "t" / "y.fasta", "ACG")
    jio.write_read_fasta(names[1], tmp_path / "j" / "y.fasta", "ACG")
    assert (tmp_path / "t" / "y.fasta").read_bytes() == \
        (tmp_path / "j" / "y.fasta").read_bytes()
