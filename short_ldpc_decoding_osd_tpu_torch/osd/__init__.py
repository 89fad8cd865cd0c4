"""OSD: TEP segmentation and the batched engine."""
from . import engine, experimental, path, segments

__all__ = ["engine", "experimental", "path", "segments"]
