"""SAM/cigar parsing into per-column alignment arrays.

Copy of ``nanoreviser_tpu/align/sam.py`` (strings only). Parity with
reference input_handeler.py:60-160 / alignutils.py:78-178 (the two are
duplicates), including, optionally, the reference's tail-trim bug at
input_handeler.py:118, where the *leading* cigar element's length is added
to ``end_clipped_bases`` while trimming trailing non-match elements
(``bug_compat=True``, the default, reproduces it; False applies the fix).

Columns are encoded as three aligned strings: readVals (read base or '-'),
refVals (reference base or '-'), mapVals in {M, X, I, D}.
"""

from __future__ import annotations

import re
from dataclasses import dataclass

_CIGAR_PAT = re.compile(r"(\d+)([MIDNSHP=X])")
_COMP = str.maketrans("ACGTN-", "TGCAN-")

SAM_FIELDS = (
    "qName", "flag", "rName", "pos", "mapq",
    "cigar", "rNext", "pNext", "tLen", "seq", "qual",
)


class SamParseError(RuntimeError):
    pass


def rev_comp(seq: str) -> str:
    out = seq.translate(_COMP)[::-1]
    return re.sub(r"[^ACGTN-]", "N", out)


def pick_sam_record(sam_lines: list[str]) -> dict:
    """The reference keeps only the LAST non-header record (alignutils.py:52-58)."""
    record: dict = {}
    for line in sam_lines:
        if line.startswith("@"):
            continue
        record = dict(zip(SAM_FIELDS, line.strip().split()))
    if not record:
        raise SamParseError("Map Error, there is no read record in the sam file")
    if len(record) < len(SAM_FIELDS) or record["rName"] == "*":
        raise SamParseError("Map Error, the read is unmapped.")
    return record


@dataclass
class AlignmentColumns:
    read_vals: str
    ref_vals: str
    map_vals: str
    genome_start: int
    strand: str
    chrom: str
    start_clipped_bases: int
    end_clipped_bases: int


def parse_sam_record(
    record: dict, genome_index: dict[str, str], bug_compat: bool = True
) -> AlignmentColumns:
    cigar = [(int(n), t) for n, t in _CIGAR_PAT.findall(record["cigar"])]
    if not cigar:
        raise SamParseError("Invalid cigar string produced.")

    strand = "-" if int(record["flag"]) & 0x10 else "+"
    if strand == "-":
        cigar = cigar[::-1]
    q_seq = record["seq"] if strand == "+" else rev_comp(record["seq"])

    start_clipped = 0
    end_clipped = 0
    if cigar[0][1] == "H":
        start_clipped += cigar[0][0]
        cigar = cigar[1:]
    if cigar[-1][1] == "H":
        end_clipped += cigar[-1][0]
        cigar = cigar[:-1]
    if cigar[0][1] == "S":
        start_clipped += cigar[0][0]
        q_seq = q_seq[cigar[0][0]:]
        cigar = cigar[1:]
    if cigar[-1][1] == "S":
        end_clipped += cigar[-1][0]
        q_seq = q_seq[: -cigar[-1][0]]
        cigar = cigar[:-1]

    t_len = sum(n for n, t in cigar if t in "MDN=X")
    pos = int(record["pos"])
    t_seq = genome_index[record["rName"]][pos - 1 : pos + t_len - 1]
    if strand == "-":
        t_seq = rev_comp(t_seq)

    while cigar[0][1] not in "M=X":
        if cigar[0][1] in "IP":
            t_seq = t_seq[cigar[0][0]:]
        else:
            q_seq = q_seq[cigar[0][0]:]
            start_clipped += cigar[0][0]
        cigar = cigar[1:]
    while cigar[-1][1] not in "M=X":
        if cigar[-1][1] in "IP":
            t_seq = t_seq[: -cigar[-1][0]]
        else:
            q_seq = q_seq[: -cigar[-1][0]]
            # reference bug: adds the HEAD element's length (input_handeler.py:118)
            end_clipped += cigar[0][0] if bug_compat else cigar[-1][0]
        cigar = cigar[:-1]

    q_len = sum(n for n, t in cigar if t in "MIP=X")
    if len(q_seq) != q_len:
        raise SamParseError(
            "Read sequence from SAM and cooresponding cigar string do not agree."
        )

    read_parts: list[str] = []
    ref_parts: list[str] = []
    map_parts: list[str] = []
    qi = ti = 0
    for n, t in cigar:
        if t in "M=X":
            q_chunk = q_seq[qi : qi + n]
            t_chunk = t_seq[ti : ti + n]
            read_parts.append(q_chunk)
            ref_parts.append(t_chunk)
            map_parts.append(
                "".join("M" if a == b else "X" for a, b in zip(q_chunk, t_chunk))
            )
            qi += n
            ti += n
        elif t in "IP":
            read_parts.append(q_seq[qi : qi + n])
            ref_parts.append("-" * n)
            map_parts.append("I" * n)
            qi += n
        else:
            ref_parts.append(t_seq[ti : ti + n])
            read_parts.append("-" * n)
            map_parts.append("D" * n)
            ti += n

    return AlignmentColumns(
        read_vals="".join(read_parts),
        ref_vals="".join(ref_parts),
        map_vals="".join(map_parts),
        genome_start=pos - 1,
        strand=strand,
        chrom=record["rName"],
        start_clipped_bases=start_clipped,
        end_clipped_bases=end_clipped,
    )
