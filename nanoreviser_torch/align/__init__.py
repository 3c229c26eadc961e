"""Alignment and labels: SAM parsing, label construction and the banded
Smith-Waterman aligner (counterpart of ``nanoreviser_tpu/align``)."""

from .labels import clean_read_map_ref, fix_raw_starts_for_clipped_bases
from .sam import SamParseError, parse_sam_record, pick_sam_record, rev_comp

__all__ = [
    "parse_sam_record",
    "pick_sam_record",
    "rev_comp",
    "SamParseError",
    "clean_read_map_ref",
    "fix_raw_starts_for_clipped_bases",
]
