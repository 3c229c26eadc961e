from .device_prep import device_preprocess_batch
from .features import (
    BASE_COLOR_TABLE,
    BASE_LABEL_TABLE,
    assemble_features,
    base_colors,
    base_labels,
)
from .host_prep import (
    CompactRead,
    PreppedRead,
    compact_read_numpy,
    prep_fast5,
    prep_read,
    prep_read_numpy,
)
from .segmentation import (
    SegmentedSignal,
    mad_normalizers,
    mad_normalizers_int16,
    segment_signal,
)

__all__ = [
    "BASE_COLOR_TABLE",
    "BASE_LABEL_TABLE",
    "CompactRead",
    "PreppedRead",
    "SegmentedSignal",
    "assemble_features",
    "base_colors",
    "base_labels",
    "compact_read_numpy",
    "device_preprocess_batch",
    "mad_normalizers",
    "mad_normalizers_int16",
    "prep_fast5",
    "prep_read",
    "prep_read_numpy",
    "segment_signal",
]
