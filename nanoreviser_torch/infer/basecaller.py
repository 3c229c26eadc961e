"""External-basecaller rebasecall hook (the reference's ``get_base_G`` path).

Copy of ``nanoreviser_tpu/infer/basecaller.py``. The reference shells out
to a bundled ONT Guppy ``basecaller`` binary (reference
output_handeler.py:159-197): it stages the read's fast5 into a per-read
temporary dir, invokes the binary with ``--input_path <dir> --save_path
<dir> --config <cfg>``, then harvests whichever ``*.fastq`` appears in the
save dir and trims 13 characters off each end of the sequence and quality
lines (output_handeler.py:86-102: the raw ``readlines()`` line is sliced
``[13:-13]``, so the tail trim eats the newline plus 12 characters;
reproduced here bit for bit).

No basecaller binary ships with the reference, so there the observable
behaviour is the degradation path. The exe and config are arguments, and
no ``uname -a>a.txt`` is written into the cwd (reference
output_handeler.py:160-178).
"""

from __future__ import annotations

import os
import shutil
import subprocess

DEFAULT_CONFIG_NAME = "dna_r9.4.1_450bps_hac.cfg"


def prep_basecaller_options(
    input_dir: str, save_path: str, config_fn: str
) -> list[str]:
    """The reference's exact option shape (output_handeler.py:159-167)."""
    return ["--input_path", input_dir, "--save_path", save_path,
            "--config", config_fn]


def run_basecaller(exe: str, options: list[str]) -> int:
    """Invoke the external basecaller, stdout/stderr discarded (reference
    output_handeler.py:170-184). Returns the exit status; FileNotFoundError
    propagates so callers can degrade per-read."""
    return subprocess.call(
        [exe, *options],
        stdout=subprocess.DEVNULL,
        stderr=subprocess.DEVNULL,
    )


def harvest_fastq(save_dir: str) -> tuple[str, str]:
    """(seq, qual) from the save dir's ``*.fastq``, 13/13-trimmed.

    Reference parity (output_handeler.py:86-102): scans the directory and
    keeps whichever ``.fastq`` the listing yields LAST; slices the raw
    sequence/quality lines ``[13:-13]`` — because ``readlines()`` keeps the
    newline, the tail trim removes 12 bases plus ``\\n``.
    """
    seq, qual = "", ""
    for name in os.listdir(save_dir):
        if not name.endswith(".fastq"):
            continue
        with open(os.path.join(save_dir, name)) as fp:
            lines = fp.readlines()
        seq = lines[1][13:-13]
        qual = lines[3][13:-13]
    return seq, qual


def rebasecall_read(
    fast5_path: str,
    tmp_dir: str,
    exe: str,
    config_fn: str,
) -> tuple[str, str]:
    """Stage one fast5 into a private dir, rebasecall it, harvest the fastq.

    Raises on a missing/failing binary or empty harvest — the caller owns
    the degradation contract (reference NanoReviser.py:146-154 falls back to
    the original event bases).
    """
    stage_dir = os.path.join(
        tmp_dir, os.path.basename(fast5_path).split(".")[0] + "_bc"
    )
    os.makedirs(stage_dir, exist_ok=True)
    try:
        shutil.copy(fast5_path, stage_dir)
        options = prep_basecaller_options(stage_dir, stage_dir, config_fn)
        status = run_basecaller(exe, options)
        if status != 0:
            raise RuntimeError(
                f"basecaller exited {status} "
                "(error in revising file, like a broken .fast5 file)"
            )
        seq, qual = harvest_fastq(stage_dir)
        if not seq:
            raise RuntimeError("basecaller produced no .fastq output")
        return seq, qual
    finally:
        shutil.rmtree(stage_dir, ignore_errors=True)
