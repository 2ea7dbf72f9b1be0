# coding=utf-8
"""The data layer: decoders, datasets, the FrameStore container and its C++
batch reader, the batch loader and the dataloader registry."""
from .decode import HAS_LMDB, HAS_PYAV, VideoDecoder
from .framestore import FrameStore, FrameStoreWriter, build_framestore
from .loader import BatchLoader, collate, pin_batch
from .registry import DATALOADER_DICT
