from .merge import labels_to_bases, merge_revision, merge_revision_with_quality
from .streaming import StreamingReviser

__all__ = [
    "merge_revision",
    "merge_revision_with_quality",
    "labels_to_bases",
    "StreamingReviser",
]
