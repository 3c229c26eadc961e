"""The port's aligner, SAM parsing and labels vs the JAX package (CPU).

* The banded DP: the port's torch DP (``banded_sw_torch`` on the CPU), the
  JAX scan, the port's ``nr_banded_sw`` and the JAX package's native
  library give identical ops, j_start and score on 24 mutated reads
  (substitutions, insertions, deletions at three rates, bands 128 and 256),
  on a one-base read and on an alignment whose path reaches the band's edge.
  The JAX package's library is loaded from a complete file (the
  ``jax_native`` fixture of ``tests/torch_jax_native.py``), whichever test
  worker built it in place.
* ``clip_ops``, ``columns_from_ops``, ``KmerIndex.seed`` and
  ``align_read_to_genome`` on both strands (with adapter ends to clip) give
  the JAX package's results.
* ``pick_sam_record``, ``parse_sam_record`` (clips, leading and trailing
  indels, both strands, with and without the reference's bug),
  ``clean_read_map_ref`` and ``fix_raw_starts_for_clipped_bases`` equal the
  JAX package's.
* No fallback: a host library that does not build raises, and the torch DP
  on "cuda" raises without a card.
"""

import dataclasses

import numpy as np
import pytest
import torch

from nanoreviser_torch import native
from nanoreviser_torch.align import labels as port_labels
from nanoreviser_torch.align import sam as port_sam
from nanoreviser_torch.align import sw as port_sw
from nanoreviser_tpu.align import labels as jax_labels
from nanoreviser_tpu.align import sam as jax_sam
from nanoreviser_tpu.align import sw as jax_sw
from tests.torch_jax_native import jax_native  # noqa: F401 (fixture)
from tests.torch_threads import one_torch_thread  # noqa: F401 (fixture)


def _mutate(rng, seq, sub, ins, dele):
    out = []
    for ch in seq:
        r = rng.random()
        if r < dele:
            continue
        out.append("ACGT"[rng.integers(4)] if r < dele + sub else ch)
        if rng.random() < ins:
            out.append("ACGT"[rng.integers(4)])
    return "".join(out)


def _all_backends(read, ref, **kw):
    """(ops, j_start, score) of the four DPs."""
    return {
        "torch": port_sw.align_banded(read, ref, backend="torch", device="cpu", **kw),
        "port_native": port_sw.align_banded(read, ref, backend="native", **kw),
        "jax": jax_sw.align_banded(read, ref, backend="jax", **kw),
        "jax_native": jax_sw.align_banded(read, ref, backend="native", **kw),
    }


def _assert_same(res):
    ops, js, sc = res["jax"]
    for name, (o, j, s) in res.items():
        np.testing.assert_array_equal(o, ops, err_msg=name)
        assert (j, s) == (js, sc), (name, j, s, js, sc)


@pytest.mark.parametrize("group,rates,band", [
    (0, (0.03, 0.01, 0.01), 256),
    (1, (0.06, 0.03, 0.03), 256),
    (2, (0.10, 0.05, 0.05), 256),
    (3, (0.06, 0.03, 0.03), 128),
])
def test_dp_backends_identical(jax_native, group, rates, band):
    rng = np.random.default_rng(100 + group)
    for _ in range(6):
        ref = "".join(rng.choice(list("ACGT"), 1200))
        lead = int(rng.integers(0, 150))
        tail = int(rng.integers(0, 150))
        read = _mutate(rng, ref[lead:1200 - tail], *rates)
        res = _all_backends(read, ref, band=band, t_lead=lead, t_tail=tail)
        _assert_same(res)
        ops, j_start, _ = res["torch"]
        rv, _, mv = port_sw.columns_from_ops(ops, read, ref, j_start)
        assert rv.replace("-", "") == read
        assert mv.count("M") > 0.6 * len(read)


def test_dp_one_base_read(jax_native):
    for read, ref in (("A", "CCAGT"), ("G", "ACGTTGCA" * 40), ("T", "T")):
        _assert_same(_all_backends(read, ref, band=16))


def test_dp_path_reaches_band_edge(jax_native):
    """A 40-base deletion early in the read drags the path off the band's
    centre line until it reaches the band's edge."""
    rng = np.random.default_rng(9)
    ref = "".join(rng.choice(list("ACGT"), 400))
    read = ref[:150] + ref[190:]
    band = 32
    res = _all_backends(read, ref, band=band)
    _assert_same(res)
    ops, j_start, _ = res["torch"]
    j0 = port_sw._band_line(len(read), len(ref), 0, 0)
    i, j, ks = 0, j_start, []
    for op in ops:
        ks.append(j - j0(i) + band // 2)
        i += op != port_sw.LEFT
        j += op != port_sw.UP
    assert min(ks) <= 0 or max(ks) >= band - 1, (min(ks), max(ks))


def test_align_read_to_genome_both_strands():
    rng = np.random.default_rng(7)
    genome = {"chr1": "".join(rng.choice(list("ACGT"), 20000)),
              "chr2": "".join(rng.choice(list("ACGT"), 8000))}
    pidx, jidx = port_sw.KmerIndex(genome), jax_sw.KmerIndex(genome)
    for chrom, start in (("chr1", 4000), ("chr2", 3000)):
        core = _mutate(rng, genome[chrom][start:start + 1500], 0.05, 0.02, 0.02)
        read = ("".join(rng.choice(list("ACGT"), 120)) + core
                + "".join(rng.choice(list("ACGT"), 80)))
        for q in (read, port_sam.rev_comp(read)):
            codes = port_sw.encode_seq(q)
            np.testing.assert_array_equal(codes, jax_sw.encode_seq(q))
            assert dataclasses.asdict(pidx.seed(codes)) == dataclasses.asdict(
                jidx.seed(codes))
            got = port_sw.align_read_to_genome(q, pidx, genome)
            want = jax_sw.align_read_to_genome(q, jidx, genome)
            assert dataclasses.asdict(got) == dataclasses.asdict(want)
            assert got.chrom == chrom and got.start_clipped_bases > 0

    # clip_ops and columns on their own, from a glocal alignment with ends
    # that do not align
    target = genome["chr1"][9000:10600]
    q = ("".join(rng.choice(list("ACGT"), 90))
         + _mutate(rng, genome["chr1"][9100:10500], 0.05, 0.02, 0.02))
    ops, js, _ = port_sw.align_banded(q, target, t_lead=100, t_tail=100)
    got = port_sw.clip_ops(ops, q, target, js)
    want = jax_sw.clip_ops(ops, q, target, js)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:] and got[3] > 0
    assert (port_sw.columns_from_ops(got[0], q, target, got[1], got[2])
            == jax_sw.columns_from_ops(got[0], q, target, got[1], got[2]))
    assert port_sw.align_read_to_genome("ACGT" * 3, pidx, genome) is None


SAM_HEAD = "@SQ\tSN:chr\tLN:1000\n"


def _sam_line(flag, pos, cigar, seq):
    return f"r\t{flag}\tchr\t{pos}\t60\t{cigar}\t*\t0\t0\t{seq}\t*\n"


def _outcome(fn, *args):
    """fn's result, or its exception's type and message (the reference's
    parser raises on some cigars; both packages must raise alike)."""
    try:
        return fn(*args)
    except Exception as exc:  # noqa: BLE001 — compared by the caller
        return type(exc).__name__, str(exc)


def test_sam_and_labels_match_jax():
    rng = np.random.default_rng(3)
    ref = "".join(rng.choice(list("ACGT"), 1000))
    genome = {"chr": ref}
    cases = [
        (0, 11, "5S20M2I10M3D15M4S", 56),
        (16, 101, "3H10M1D12M2I8M5S", 37),
        (0, 51, "2I30M4D20M", 50),
        (0, 201, "25M3I2D", 27),
        (16, 301, "6S2D40M1I", 48),
        (0, 401, "12=3X10=", 25),
        (0, 501, "10M", 11),                 # SEQ and CIGAR disagree
    ]
    n_parsed = 0
    for flag, pos, cigar, n_seq in cases:
        seq = "".join(rng.choice(list("ACGTN"), n_seq, p=[0.24] * 4 + [0.04]))
        lines = [SAM_HEAD, _sam_line(0, 1, "4M", "ACGT"), _sam_line(flag, pos, cigar, seq)]
        rec = port_sam.pick_sam_record(lines)
        assert rec == jax_sam.pick_sam_record(lines)
        for bug in (True, False):
            outcome = [_outcome(lambda: dataclasses.asdict(
                mod.parse_sam_record(rec, genome, bug_compat=bug)))
                for mod in (port_sam, jax_sam)]
            assert outcome[0] == outcome[1], (cigar, bug)
            if isinstance(outcome[0], dict):
                n_parsed += 1
                cols = [outcome[0][k] for k in ("read_vals", "map_vals", "ref_vals")]
                assert (_outcome(port_labels.clean_read_map_ref, *cols)
                        == _outcome(jax_labels.clean_read_map_ref, *cols)), cigar
    assert n_parsed >= 8, n_parsed
    for bad in ([SAM_HEAD], [SAM_HEAD, "r\t4\t*\t0\t0\t*\t*\t0\t0\tACGT\t*\n"]):
        with pytest.raises(port_sam.SamParseError):
            port_sam.pick_sam_record(bad)
    assert port_sam.rev_comp("ACGTNRY-") == jax_sam.rev_comp("ACGTNRY-")

    n = 60
    starts = np.cumsum(rng.integers(3, 12, n))
    lengths = rng.integers(3, 12, n).astype(np.float64)
    abm, abs_ = rng.normal(0, 1, n), rng.normal(1, 0.2, n)
    for sc, ec in ((0, 0), (4, 0), (0, 3), (5, 7)):
        got = port_labels.fix_raw_starts_for_clipped_bases(sc, ec, starts, lengths,
                                                           123, abm, abs_)
        want = jax_labels.fix_raw_starts_for_clipped_bases(sc, ec, starts, lengths,
                                                           123, abm, abs_)
        assert got[2] == want[2]
        for a, b in zip(got[:2] + got[3:], want[:2] + want[3:]):
            np.testing.assert_array_equal(a, b)


def test_no_fallback(monkeypatch, tmp_path):
    from nanoreviser_torch.native import build

    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(build, "lib_path", lambda: tmp_path / "libnanorev_x.so")
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    with pytest.raises(build.NativeBuildError):
        port_sw.align_banded("ACGTACGT", "ACGTACGT")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_sw.align_banded("ACGTACGT", "ACGTACGT", backend="torch")
    with pytest.raises(ValueError, match="backend"):
        port_sw.align_banded("ACGTACGT", "ACGTACGT", backend="jax")
