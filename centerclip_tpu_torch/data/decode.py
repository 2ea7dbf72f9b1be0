# coding=utf-8
"""Video decode + frame sampling (port of the JAX package's `data/decode.py`;
reference: dataloaders/decode.py).

Multi-backend decoder producing fixed-shape [T, C, H, W] float32 clips:

* ``pyav``   — FFmpeg via PyAV, like the reference (gated: raises when the
  module is absent)
* ``lmdb``   — raw video bytes from an LMDB, decoded with PyAV (gated)
* ``framedir`` — a directory of numbered image frames (PIL)
* ``npy``    — one ``.npy`` of [T, H, W, C] uint8 frames per video (the
  hermetic format our preprocess tool emits; also the unit-test backend)
* ``framestore`` — our packed single-file frame container (see
  data/framestore.py)

The sampling rules are the reference's exactly: TSN multi-segment random
sampling in train, segment-centre uniform sampling in eval, clip-and-mask for
short videos (decode.py:82-101) — outputs are always exactly `num_segments`
frames plus a valid-length for the mask.
"""
from __future__ import annotations

import io
import os
from typing import Optional, Tuple

import numpy as np

from ..ops.sampling import multi_segments_sampling, uniform_sampling
from .transforms import (clip_eval_transform, clip_train_transform,
                         clip_transform_uint8)

try:
    import av  # type: ignore
    HAS_PYAV = True
except ImportError:
    HAS_PYAV = False

try:
    import lmdb  # type: ignore
    HAS_LMDB = True
except ImportError:
    HAS_LMDB = False


class VideoDecoder:
    """Fixed-shape clip extractor (reference: RawVideoExtractorpyAV,
    decode.py:18-136)."""

    def __init__(self, size: int = 224, is_train: bool = True,
                 num_segments: int = 12, lmdb_dataset: Optional[str] = None,
                 backend: str = "auto", emit_uint8: bool = False,
                 rng: Optional[np.random.Generator] = None):
        self.size = size
        self.train = is_train
        self.num_segments = num_segments
        self.lmdb_dataset = None if lmdb_dataset in (None, "None") \
            else lmdb_dataset
        self.backend = backend
        # ship raw cropped uint8 pixels; normalisation moves on-device
        # (4x less host->device traffic than float32 frames)
        self.emit_uint8 = emit_uint8
        self.rng = rng or np.random.default_rng()
        self._db_txn = None
        self._framestore = None

    # --- backend resolution ---------------------------------------------
    def _resolve_backend(self, video_path: str) -> str:
        if self.backend != "auto":
            return self.backend
        if self.lmdb_dataset is not None:
            return "lmdb"
        if video_path.endswith(".npy"):
            return "npy"
        if video_path.endswith(".fstore") or ".fstore/" in video_path:
            return "framestore"
        if os.path.isdir(video_path):
            return "framedir"
        return "pyav"

    # --- raw frame access --------------------------------------------------
    def _read_all_frames(self, video_path: str, start_time=None,
                         end_time=None):
        """Return (frames, num_frames): `frames` is an indexable of
        [H, W, C] uint8 arrays."""
        backend = self._resolve_backend(video_path)
        if backend in ("pyav", "lmdb"):
            if not HAS_PYAV:
                raise RuntimeError(
                    "PyAV is not available in this environment; use the "
                    "'npy'/'framedir'/'framestore' backends or pre-decode "
                    "videos with preprocess/frames_to_npy.")
            if backend == "lmdb":
                if not HAS_LMDB:
                    raise RuntimeError("lmdb is not available")
                if self._db_txn is None:
                    env = lmdb.open(self.lmdb_dataset,
                                    subdir=os.path.isdir(self.lmdb_dataset),
                                    readonly=True, lock=False,
                                    readahead=False, meminit=False,
                                    map_size=1 << 41)
                    self._db_txn = env.begin(write=False)
                data = self._db_txn.get(os.path.basename(video_path).encode())
                container = av.open(io.BytesIO(data))
            else:
                assert os.path.exists(video_path), \
                    f"{video_path} does not exist"
                container = av.open(video_path)
            stream = container.streams.video[0]
            num_frames = stream.frames
            fps = float(stream.average_rate)
            all_frames = []
            if start_time is None or end_time is None:
                for frame in container.decode(video=0):
                    all_frames.append(frame)
            else:
                s = max(0, int(start_time * fps))
                e = min(int(end_time * fps), num_frames)
                for cnt, frame in enumerate(container.decode(video=0)):
                    if s <= cnt <= e:
                        all_frames.append(frame)
            num_frames = min(num_frames, len(all_frames))
            frames = [f.to_rgb().to_ndarray() for f in all_frames]
            return frames, num_frames
        if backend == "npy":
            arr = np.load(video_path, mmap_mode="r")   # [T, H, W, C] uint8
            frames = arr
            return frames, self._window(len(arr), start_time, end_time,
                                        frames)[1]
        if backend == "framestore":
            from .framestore import FrameStore
            store_path, key = self._split_store_path(video_path)
            if self._framestore is None or \
                    self._framestore.path != store_path:
                self._framestore = FrameStore(store_path)
            frames = self._framestore.get(key)
            return frames, len(frames)
        if backend == "framedir":
            from PIL import Image
            files = sorted(os.listdir(video_path))
            files = [f for f in files if f.lower().endswith(
                (".jpg", ".jpeg", ".png"))]
            frames = _LazyImageList(video_path, files)
            return frames, len(files)
        raise NotImplementedError(backend)

    @staticmethod
    def _split_store_path(video_path: str):
        if video_path.endswith(".fstore"):
            return video_path, None
        store, key = video_path.split(".fstore/", 1)
        return store + ".fstore", key

    @staticmethod
    def _window(n, start_time, end_time, frames, fps: float = 3.0):
        """Time-window selection for pre-decoded backends (assumes the
        preprocess fps, default 3 — preprocess/compress_video.py)."""
        if start_time is None or end_time is None:
            return frames, n
        s = max(0, int(start_time * fps))
        e = min(int(end_time * fps), n)
        return frames[s:e + 1], max(e + 1 - s, 0)

    # --- public API ----------------------------------------------------------
    def get_video_data(self, video_path: str, start_time=None, end_time=None,
                       random_shift: Optional[bool] = None,
                       rng: Optional[np.random.Generator] = None
                       ) -> Tuple[np.ndarray, int]:
        """Decode + sample one clip.

        Returns ([T=num_segments, C, H=size, W=size] float32 CLIP-normalised
        frames, valid frame count for the mask) — decode.py:51-101.

        ``rng`` overrides the decoder-level generator; datasets pass a
        per-(seed, epoch, sample) generator so concurrent decode threads
        never interleave draws on shared RNG state (run-to-run
        nondeterminism — see datasets.VideoTextDataset._sample_rng).
        """
        random_shift = True if random_shift is None else random_shift
        rng = rng if rng is not None else self.rng
        frames, num_frames = self._read_all_frames(video_path, start_time,
                                                   end_time)
        if self._resolve_backend(video_path) in ("npy",) and (
                start_time is not None and end_time is not None):
            frames, num_frames = self._window(len(frames), start_time,
                                              end_time, frames)

        if self.train:
            inds = multi_segments_sampling(self.num_segments, num_frames,
                                           random_shift=random_shift,
                                           rng=rng)
        else:
            inds = uniform_sampling(self.num_segments, num_frames)

        sampled = [np.asarray(frames[int(i)]) for i in inds]
        if self.emit_uint8:
            tensor = clip_transform_uint8(sampled, self.size)
        elif self.train:
            tensor = clip_train_transform(sampled, self.size, rng=rng)
        else:
            tensor = clip_eval_transform(sampled, self.size)
        frame_length = min(num_frames, self.num_segments)
        return tensor, frame_length

    def process_frame_order(self, video: np.ndarray, frame_order: int = 0,
                            rng: Optional[np.random.Generator] = None
                            ) -> np.ndarray:
        """0 ordinary / 1 reverse / 2 random (decode.py:109-122)."""
        if frame_order == 1:
            return video[::-1].copy()
        if frame_order == 2:
            rng = rng if rng is not None else self.rng
            order = rng.permutation(video.shape[0])
            return video[order]
        return video

    # pickling into worker threads/processes (decode.py:123-136)
    def __getstate__(self):
        state = dict(self.__dict__)
        state["_db_txn"] = None
        state["_framestore"] = None
        return state

    def __setstate__(self, state):
        self.__dict__ = state


class _LazyImageList:
    """Index-on-demand image frames from a directory."""

    def __init__(self, root: str, files):
        self.root = root
        self.files = files

    def __len__(self):
        return len(self.files)

    def __getitem__(self, i):
        from PIL import Image
        with Image.open(os.path.join(self.root, self.files[i])) as im:
            return np.asarray(im.convert("RGB"))
