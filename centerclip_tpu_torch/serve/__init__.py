# coding=utf-8
"""Online serving: device-resident gallery index + text-query engine."""
from .engine import RetrievalEngine
from .index import VideoIndex, load_index
from .ivf import IVFVideoIndex

__all__ = ["RetrievalEngine", "VideoIndex", "IVFVideoIndex", "load_index"]
