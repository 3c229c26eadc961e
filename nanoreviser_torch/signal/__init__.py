"""Signal preparation: MAD normalizers, per-base features, per-read prep.

Names are imported on first use (a module ``__getattr__``), so that
importing ``nanoreviser_torch.signal.host_prep`` in a prep-pool worker does
not import ``device_prep`` and with it torch.
"""

import importlib

_SOURCES = {
    "device_preprocess_batch": "device_prep",
    "BASE_COLOR_TABLE": "features",
    "BASE_LABEL_TABLE": "features",
    "assemble_features": "features",
    "base_colors": "features",
    "base_labels": "features",
    "CompactRead": "host_prep",
    "PreppedRead": "host_prep",
    "compact_fast5": "host_prep",
    "compact_read": "host_prep",
    "compact_read_numpy": "host_prep",
    "prep_fast5": "host_prep",
    "prep_read": "host_prep",
    "prep_read_numpy": "host_prep",
    "SegmentedSignal": "segmentation",
    "mad_normalizers": "segmentation",
    "mad_normalizers_int16": "segmentation",
    "segment_signal": "segmentation",
}

__all__ = sorted(_SOURCES)


def __getattr__(name: str):
    if name not in _SOURCES:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f".{_SOURCES[name]}", __name__), name)
