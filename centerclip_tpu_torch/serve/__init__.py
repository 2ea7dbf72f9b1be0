# coding=utf-8
"""Online serving: device-resident flat gallery index + text-query engine."""
from .engine import RetrievalEngine
from .index import VideoIndex, load_index

__all__ = ["RetrievalEngine", "VideoIndex", "load_index"]
