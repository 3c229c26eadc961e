"""Inference: wire format, revision merge, the streaming engine, the prep
pool.

Names are imported on first use (a module ``__getattr__``), so that a
prep-pool worker importing ``nanoreviser_torch.infer.wire`` does not
import ``streaming`` and with it torch.
"""

import importlib

_SOURCES = {
    "labels_to_bases": "merge",
    "merge_revision": "merge",
    "merge_revision_with_quality": "merge",
    "revision_stats": "merge",
    "StreamingReviser": "streaming",
    "PrepPool": "hostpipe",
}

__all__ = sorted(_SOURCES)


def __getattr__(name: str):
    if name not in _SOURCES:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f".{_SOURCES[name]}", __name__), name)
