from .host_prep import CompactRead, compact_read_numpy
from .segmentation import mad_normalizers_int16

__all__ = [
    "CompactRead",
    "compact_read_numpy",
    "mad_normalizers_int16",
]
