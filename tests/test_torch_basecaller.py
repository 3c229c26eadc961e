"""The port's basecaller mode and ``revision_stats`` vs the JAX package (CPU).

A stub basecaller written by the test (as tests/test_basecaller.py does)
emits a fastq with the reference's trim geometry: the raw lines are sliced
``[13:-13]``, so 13 characters go from the head and 12 plus the newline from
the tail.

* ``prep_basecaller_options``, ``harvest_fastq`` (one ``.fastq``, and a
  directory holding two) and ``rebasecall_read`` through the stub equal the
  JAX package's; a missing exe raises the same exception in both.
* The CLI's ``--revise_mode basecaller`` on synthetic reads, in fasta and
  fastq, writes files byte-identical to the JAX CLI's, with the stub and
  without a binary (rc 1, every read in ``-e``, passthrough output).
* ``revision_stats`` equals the JAX package's on random labels.
"""

import os
import stat
import sys

import numpy as np
import pytest

from nanoreviser_torch.infer import basecaller as port_bc
from nanoreviser_torch.infer.merge import revision_stats
from nanoreviser_torch.io.synthetic import write_synthetic_dir
from nanoreviser_torch.io.writers import format_read_fasta, format_read_fastq
from nanoreviser_tpu.infer import basecaller as jax_bc
from nanoreviser_tpu.infer.merge import revision_stats as jax_revision_stats
from tests.torch_threads import one_torch_thread  # noqa: F401 (fixture)

PAD13, PAD12 = "N" * 13, "N" * 12

# per read: a core sequence and quality that depend on the staged file name
STUB = f"""#!{sys.executable}
import argparse, os, sys
p = argparse.ArgumentParser()
p.add_argument("--input_path", required=True)
p.add_argument("--save_path", required=True)
p.add_argument("--config", required=True)
a = p.parse_args()
fast5s = [f for f in os.listdir(a.input_path) if f.endswith(".fast5")]
assert len(fast5s) == 1, fast5s
stem = fast5s[0].split(".")[0]
seq = "ACGTACGTAC" + "".join("ACGT"[ord(c) % 4] for c in stem)
qual = "".join(chr(33 + (7 * i + ord(c)) % 40) for i, c in enumerate(seq))
with open(os.path.join(a.save_path, "stub_out.fastq"), "w") as fp:
    fp.write("@stub\\n{PAD13}" + seq + "{PAD12}\\n+\\n{PAD13}" + qual + "{PAD12}\\n")
"""


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    d = tmp_path_factory.mktemp("basecaller")
    fast5 = d / "fast5"
    names = write_synthetic_dir(str(fast5), 3, (300, 500), seed=71)
    exe = d / "bin" / "basecaller"
    exe.parent.mkdir()
    exe.write_text(STUB)
    exe.chmod(exe.stat().st_mode | stat.S_IXUSR)
    return d, fast5, names, str(exe)


def test_option_shape():
    opts = port_bc.prep_basecaller_options("/in", "/out", "/cfg/x.cfg")
    assert opts == ["--input_path", "/in", "--save_path", "/out", "--config", "/cfg/x.cfg"]
    assert opts == jax_bc.prep_basecaller_options("/in", "/out", "/cfg/x.cfg")
    assert port_bc.DEFAULT_CONFIG_NAME == jax_bc.DEFAULT_CONFIG_NAME


def test_harvest_trim_matches_jax(tmp_path):
    one, two = tmp_path / "one", tmp_path / "two"
    one.mkdir()
    two.mkdir()
    (one / "r.fastq").write_text(f"@r\n{PAD13}ACGTTGCA{PAD12}\n+\n{PAD13}!#%&'()*{PAD12}\n")
    (one / "notes.txt").write_text("not a fastq\n")
    for k, core in enumerate(("AAAACCCC", "GGGGTTTT")):
        (two / f"r{k}.fastq").write_text(
            f"@r{k}\n{PAD13}{core}{PAD12}\n+\n{PAD13}{'?' * 8}{PAD12}\n")
    assert port_bc.harvest_fastq(str(one)) == ("ACGTTGCA", "!#%&'()*")
    for d in (one, two):
        assert port_bc.harvest_fastq(str(d)) == jax_bc.harvest_fastq(str(d))
    # the last .fastq that the listing yields wins
    last = [n for n in os.listdir(two) if n.endswith(".fastq")][-1]
    assert port_bc.harvest_fastq(str(two))[0] == ("AAAACCCC" if last == "r0.fastq"
                                                   else "GGGGTTTT")


def test_rebasecall_read_matches_jax(setup, tmp_path):
    _, fast5, names, exe = setup
    for n in names:
        got = port_bc.rebasecall_read(str(fast5 / n), str(tmp_path / "p"), exe, "x.cfg")
        want = jax_bc.rebasecall_read(str(fast5 / n), str(tmp_path / "j"), exe, "x.cfg")
        assert got == want and len(got[0]) == len(got[1]) > 10
    assert os.listdir(tmp_path / "p") == []          # stage dirs removed


def test_rebasecall_missing_exe_raises_as_jax(setup, tmp_path):
    _, fast5, names, _ = setup
    missing = str(tmp_path / "no_such_basecaller")
    errors = []
    for rebasecall in (port_bc.rebasecall_read, jax_bc.rebasecall_read):
        with pytest.raises(Exception) as info:
            rebasecall(str(fast5 / names[0]), str(tmp_path / "t"), missing, "x.cfg")
        errors.append((type(info.value), str(info.value)))
    assert errors[0] == errors[1] and errors[0][0] is FileNotFoundError
    assert os.listdir(tmp_path / "t") == []


def _run_both(setup, tag, fmt, exe):
    """Both CLIs in basecaller mode; {package: (rc, files, -e text)}."""
    from nanoreviser_torch.cli.reviser import main as port_main
    from nanoreviser_tpu.cli.reviser import main as jax_main

    d, fast5, _, _ = setup
    res = {}
    for pkg, main in (("port", port_main), ("jax", jax_main)):
        out, failed = d / f"{tag}_{fmt}_{pkg}", d / f"{tag}_{fmt}_{pkg}_failed.txt"
        rc = main(["-d", str(fast5), "-o", str(out), "-F", fmt, "--revise_mode",
                   "basecaller", "--basecaller_exe", exe, "--thread", "2",
                   "-t", str(d / f"tmp_{pkg}"), "-e", str(failed)])
        files = {p: (out / p).read_bytes() for p in sorted(os.listdir(out))}
        res[pkg] = (rc, files, failed.read_text() if failed.exists() else None)
    return res


@pytest.mark.parametrize("fmt", ["fasta", "fastq"])
def test_cli_basecaller_mode_byte_identical_to_jax(setup, fmt):
    _, fast5, names, exe = setup
    res = _run_both(setup, "stub", fmt, exe)
    assert res["port"] == res["jax"]
    rc, files, failed = res["port"]
    assert rc == 0 and failed is None and len(files) == len(names)
    for n in names:
        got = files[n.split(".")[0] + f"_out.{fmt}"].decode()
        seq, qual = port_bc.rebasecall_read(str(fast5 / n), str(setup[0] / "t"), exe, "x")
        want = (format_read_fasta(n, seq) if fmt == "fasta"
                else format_read_fastq(n, seq, qual))
        assert got == want


@pytest.mark.parametrize("fmt", ["fasta", "fastq"])
def test_cli_without_binary_degrades_as_jax(setup, fmt):
    from nanoreviser_torch.cli.reviser import main as port_main

    d, fast5, names, _ = setup
    res = _run_both(setup, "nobin", fmt, str(d / "no_such_dir" / "basecaller"))
    assert res["port"] == res["jax"]
    rc, files, failed = res["port"]
    assert rc == 1
    assert [ln.split("\t")[0] for ln in failed.splitlines()] == names
    out = d / f"pass_{fmt}"
    assert port_main(["-d", str(fast5), "-o", str(out), "-F", fmt,
                      "--revise_mode", "passthrough", "-e", str(d / "pass_failed.txt")]) == 0
    assert files == {p: (out / p).read_bytes() for p in sorted(os.listdir(out))}


@pytest.mark.parametrize("offset", range(8))
def test_revision_stats_matches_jax(offset):
    rng = np.random.default_rng(offset)
    n = 400
    bases = "".join(rng.choice(list("ACGTN"), n, p=[0.24, 0.24, 0.24, 0.24, 0.04]))
    y1 = rng.integers(0, 6, n - offset // 2)
    y2 = rng.integers(0, 5, n - offset)
    got = revision_stats(bases, y1, y2, center_offset=offset)
    assert got == jax_revision_stats(bases, y1, y2, center_offset=offset)
    assert got["covered"] == n - offset and got["edits"] > 0
