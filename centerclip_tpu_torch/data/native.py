# coding=utf-8
"""ctypes binding for the C++ FrameStore batch reader
(`csrc/framestore_reader.cpp`; port of the JAX package's `data/native.py`).

`NativeFrameStore.gather_batch` performs the entire hot host path — frame
gather, center-crop, uint8→float conversion and CLIP normalization — in C++
threads, producing the fixed-shape [B, T, 3, size, size] float32 batch with
no Python per-pixel work; `gather_batch_u8` crops only, for the model's
on-device normalization.  Both write into a caller's `out=` buffer when
given one (the loader passes a view of a pinned tensor).

The library is built from the checkout's source by the host's C++ compiler
at first use (`ops/_build.py`); a failed build raises with the compiler's
output.  There is no Python fallback.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import numpy as np

from ..ops import _build
from .transforms import CLIP_MEAN, CLIP_STD

SOURCE = "framestore_reader"


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    i64_array = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    f32_array = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    lib.fs_open.restype = ctypes.c_void_p
    lib.fs_open.argtypes = [ctypes.c_char_p]
    lib.fs_close.restype = None
    lib.fs_close.argtypes = [ctypes.c_void_p]
    lib.fs_num_entries.restype = ctypes.c_int64
    lib.fs_num_entries.argtypes = [ctypes.c_void_p]
    lib.fs_find_key.restype = ctypes.c_int64
    lib.fs_find_key.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.fs_entry_info.restype = ctypes.c_int
    lib.fs_entry_info.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                  ctypes.POINTER(ctypes.c_int64)]
    lib.fs_gather_batch.restype = ctypes.c_int
    lib.fs_gather_batch.argtypes = [
        ctypes.c_void_p, i64_array, i64_array,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        f32_array, f32_array, f32_array, ctypes.c_int]
    lib.fs_gather_batch_u8.restype = ctypes.c_int
    lib.fs_gather_batch_u8.argtypes = [
        ctypes.c_void_p, i64_array, i64_array,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"), ctypes.c_int]
    return lib


def load_library() -> ctypes.CDLL:
    """The reader's library, built first if needed (raises on failure)."""
    return _declare(_build.load(SOURCE))


def _output(out: Optional[np.ndarray], shape: tuple, dtype) -> np.ndarray:
    if out is None:
        return np.empty(shape, dtype)
    if not isinstance(out, np.ndarray) or out.dtype != dtype \
            or out.shape != shape or not out.flags.c_contiguous \
            or not out.flags.writeable:
        raise ValueError(f"out must be a writeable C-contiguous "
                         f"{np.dtype(dtype)} array of shape {shape}")
    return out


class NativeFrameStore:
    """C++-backed FrameStore reader."""

    def __init__(self, path: str, num_threads: int = 4):
        self._h = None
        self._lib = load_library()
        self.path = path
        self.num_threads = num_threads
        self._h = self._lib.fs_open(path.encode())
        if not self._h:
            raise IOError(f"failed to open FrameStore {path} (missing, "
                          f"truncated or not a FrameStore)")

    def __len__(self) -> int:
        return int(self._lib.fs_num_entries(self._h))

    def entry_id(self, key) -> int:
        eid = int(self._lib.fs_find_key(self._h, str(key).encode()))
        if eid < 0:
            raise KeyError(key)
        return eid

    def entry_info(self, entry_id: int) -> tuple:
        buf = (ctypes.c_int64 * 4)()
        rc = self._lib.fs_entry_info(self._h, entry_id, buf)
        if rc != 0:
            raise IndexError(entry_id)
        return tuple(int(v) for v in buf)

    def num_frames(self, key) -> int:
        return self.entry_info(self.entry_id(key))[0]

    def _indices(self, entry_ids, frame_indices):
        if self._h is None:
            raise ValueError(f"FrameStore {self.path} is closed")
        eids = np.ascontiguousarray(entry_ids, np.int64)
        idx = np.ascontiguousarray(frame_indices, np.int64)
        if idx.ndim != 2 or eids.shape != (idx.shape[0],):
            raise ValueError(f"entry_ids {eids.shape} and frame_indices "
                             f"{idx.shape} must be [B] and [B, T]")
        return eids, idx

    def gather_batch(self, entry_ids: Sequence[int],
                     frame_indices: np.ndarray, size: int = 224,
                     mean=CLIP_MEAN, std=CLIP_STD,
                     out: Optional[np.ndarray] = None) -> np.ndarray:
        """Gather + transform a batch.

        Args:
            entry_ids: [B] framestore entry ids.
            frame_indices: [B, T] int frame indices (clamped in C++).
            out: optional preallocated [B, T, 3, size, size] float32 buffer.
        Returns:
            [B, T, 3, size, size] float32 CLIP-normalised batch.
        """
        eids, idx = self._indices(entry_ids, frame_indices)
        B, T = idx.shape
        out = _output(out, (B, T, 3, size, size), np.float32)
        mean, std = (np.ascontiguousarray(v, np.float32) for v in (mean, std))
        if mean.shape != (3,) or std.shape != (3,):
            raise ValueError("mean and std need 3 values (RGB)")
        rc = self._lib.fs_gather_batch(self._h, eids, idx, B, T, size, mean,
                                       std, out, self.num_threads)
        if rc != 0:
            raise RuntimeError(f"fs_gather_batch failed with code {rc}")
        return out

    def gather_batch_u8(self, entry_ids: Sequence[int],
                        frame_indices: np.ndarray, size: int = 224,
                        out: Optional[np.ndarray] = None) -> np.ndarray:
        """Crop-only uint8 gather: [B, T, 3, size, size] uint8, zero-padded.
        Pair with the model's on-device normalization (uint8 inputs) to ship
        4x fewer bytes to the card."""
        eids, idx = self._indices(entry_ids, frame_indices)
        B, T = idx.shape
        out = _output(out, (B, T, 3, size, size), np.uint8)
        rc = self._lib.fs_gather_batch_u8(self._h, eids, idx, B, T, size,
                                          out, self.num_threads)
        if rc != 0:
            raise RuntimeError(f"fs_gather_batch_u8 failed with code {rc}")
        return out

    def close(self):
        if self._h:
            self._lib.fs_close(self._h)
            self._h = None

    def __del__(self):
        self.close()

    def __getstate__(self):
        return {"path": self.path, "num_threads": self.num_threads}

    def __setstate__(self, state):
        self.__init__(state["path"], state["num_threads"])
