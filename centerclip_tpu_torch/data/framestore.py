# coding=utf-8
"""FrameStore: a packed single-file frame container.

The port's own copy of the JAX package's `data/framestore.py`, with the same
`FST1` file format, so a store written by either package reads in the
other.  It replaces the reference's LMDB-of-video-bytes (reference:
preprocess/folder2lmdb.py + dataloaders/decode.py:54-60): instead of
compressed video that must be FFmpeg-decoded per sample, a FrameStore holds
pre-decoded RGB frames (uint8, fixed resolution per entry) behind one mmap —
reads are zero-copy slices, so the host input pipeline does no decode work
at train time.

Layout (little-endian):
    header   : magic 'FST1' | u32 version | u64 num_entries | u64 index_off
    data     : concatenated raw frame blobs (T*H*W*C bytes each)
    index    : per entry: u16 key_len | key utf-8 | u32 T,H,W,C | u64 offset

The index is also mirrored to a side JSON for debuggability.  The C++ batch
reader (`csrc/framestore_reader.cpp`, bound in `data/native.py`) gathers,
crops and normalizes whole batches in threads.
"""
from __future__ import annotations

import json
import mmap
import os
import struct
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

MAGIC = b"FST1"
_HEADER = struct.Struct("<4sIQQ")
_ENTRY_FIXED = struct.Struct("<IIIIQ")


class FrameStoreWriter:
    def __init__(self, path: str):
        assert path.endswith(".fstore"), "FrameStore paths end with .fstore"
        self.path = path
        self._f = open(path, "wb")
        self._f.write(_HEADER.pack(MAGIC, 1, 0, 0))
        self._index: List[Tuple[str, tuple, int]] = []

    def add(self, key: str, frames: np.ndarray) -> None:
        """frames: [T, H, W, C] uint8."""
        frames = np.ascontiguousarray(frames, np.uint8)
        assert frames.ndim == 4
        off = self._f.tell()
        self._f.write(frames.tobytes())
        self._index.append((key, frames.shape, off))

    def close(self) -> None:
        index_off = self._f.tell()
        for key, shape, off in self._index:
            kb = key.encode("utf-8")
            self._f.write(struct.pack("<H", len(kb)))
            self._f.write(kb)
            self._f.write(_ENTRY_FIXED.pack(*shape, off))
        self._f.seek(0)
        self._f.write(_HEADER.pack(MAGIC, 1, len(self._index), index_off))
        self._f.close()
        with open(self.path + ".json", "w") as f:
            json.dump({k: {"shape": list(s), "offset": o}
                       for k, s, o in self._index}, f)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class FrameStore:
    """Read-only mmap view over a FrameStore file."""

    def __init__(self, path: str):
        self.path = path
        self._file = open(path, "rb")
        self._mm = mmap.mmap(self._file.fileno(), 0, access=mmap.ACCESS_READ)
        magic, version, n, index_off = _HEADER.unpack_from(self._mm, 0)
        assert magic == MAGIC, f"not a FrameStore: {path}"
        assert version == 1
        self.index: Dict[str, Tuple[tuple, int]] = {}
        pos = index_off
        for _ in range(n):
            (klen,) = struct.unpack_from("<H", self._mm, pos)
            pos += 2
            key = self._mm[pos:pos + klen].decode("utf-8")
            pos += klen
            t, h, w, c, off = _ENTRY_FIXED.unpack_from(self._mm, pos)
            pos += _ENTRY_FIXED.size
            self.index[key] = ((t, h, w, c), off)

    def keys(self) -> Iterable[str]:
        return self.index.keys()

    def __contains__(self, key: str) -> bool:
        return key in self.index

    def get(self, key: Optional[str]):
        """Zero-copy [T, H, W, C] uint8 view.  `key=None` returns the sole
        entry (single-video stores)."""
        if key is None:
            assert len(self.index) == 1, "key required for multi-entry store"
            key = next(iter(self.index))
        shape, off = self.index[key]
        size = int(np.prod(shape))
        return np.frombuffer(self._mm, np.uint8, count=size,
                             offset=off).reshape(shape)

    def close(self):
        self._mm.close()
        self._file.close()

    # decoder instances are pickled into worker threads
    def __getstate__(self):
        return {"path": self.path}

    def __setstate__(self, state):
        self.__init__(state["path"])


def build_framestore(video_frames: Dict[str, np.ndarray], path: str) -> str:
    """Convenience builder: {video_id: [T, H, W, C] uint8} -> .fstore file."""
    with FrameStoreWriter(path) as w:
        for key, frames in video_frames.items():
            w.add(key, frames)
    return path
