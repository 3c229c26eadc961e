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
"""

from __future__ import annotations

import os


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
