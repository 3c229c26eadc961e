"""Reference-genome fasta parsing (copy of ``nanoreviser_tpu/io/fasta.py``;
parity: reference input_handeler.py:28-57)."""

from __future__ import annotations

import os


def parse_fasta(fasta_fn: str | os.PathLike) -> dict[str, str]:
    """Parse a (multi-)fasta into {first-token-of-header: sequence}."""
    records: dict[str, str] = {}
    curr_id: str | None = None
    chunks: list[str] = []
    with open(fasta_fn, "r") as fp:
        for line in fp:
            if line.startswith(">"):
                if curr_id is not None and chunks:
                    records[curr_id] = "".join(chunks)
                chunks = []
                curr_id = line[1:].strip().split()[0]
            else:
                chunks.append(line.strip())
    if curr_id is not None and chunks:
        records[curr_id] = "".join(chunks)
    return records
