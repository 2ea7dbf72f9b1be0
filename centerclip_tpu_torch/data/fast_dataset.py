# coding=utf-8
"""Batched FrameStore dataset: the high-throughput input path (port of the
JAX package's `data/fast_dataset.py`).

Couples the C++ reader (data/native.py) with batch-level sampling: one
`get_batch(indices)` call tokenizes the captions (cached) and performs a
single multithreaded gather+transform for all clips — the whole host-side
video path for a training step is one C call.  With `pin_memory` the reader
writes the frames straight into a pinned tensor, so the copy to the card can
be asynchronous and no second host copy is made.  Any (video_id, caption)
pair list works, so every dataset family can be converted by packing its
videos into a FrameStore.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..models.tokenizer import SimpleTokenizer, tokenize_batch
from ..ops.sampling import multi_segments_sampling, uniform_sampling
from .loader import pin_batch
from .native import NativeFrameStore


class FrameStoreClipDataset:
    """(video_id, caption) pairs over one FrameStore.

    Exposes both the per-sample `__getitem__` protocol and the batched
    `get_batch` fast path that BatchLoader prefers when present.
    """

    multi_sentence_per_video = False
    cut_off_points: List[int] = []
    sentence_num = -1
    video_num = -1

    def __init__(self, store_path: str,
                 pairs: Sequence[Tuple[str, str]],
                 tokenizer: SimpleTokenizer, max_words: int = 32,
                 max_frames: int = 12, image_resolution: int = 224,
                 is_train: bool = True, num_threads: int = 4,
                 seed: int = 42, device_normalize: bool = False):
        self.device_normalize = device_normalize
        self.store = NativeFrameStore(store_path, num_threads=num_threads)
        self.pairs = list(pairs)
        self.tokenizer = tokenizer
        self.max_words = max_words
        self.max_frames = max_frames
        self.size = image_resolution
        self.is_train = is_train
        self.seed = seed
        self.epoch = 0
        # resolve entries + frame counts once
        self._entry_ids = np.array(
            [self.store.entry_id(vid) for vid, _ in self.pairs], np.int64)
        self._num_frames = np.array(
            [self.store.entry_info(e)[0] for e in self._entry_ids], np.int64)
        # tokenize all captions once (text is tiny)
        ids, mask, seg = tokenize_batch(
            tokenizer, [cap for _, cap in self.pairs], max_words=max_words)
        self._ids, self._mask, self._seg = ids, mask, seg

    def __len__(self) -> int:
        return len(self.pairs)

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def _sample_indices(self, n_frames: int, sample_idx: int) -> np.ndarray:
        if self.is_train:
            # keyed per (seed, epoch, sample): draws are identical for any
            # visit order or shard layout (see datasets._sample_rng)
            rng = np.random.default_rng(np.random.SeedSequence(
                [self.seed, self.epoch, int(sample_idx)]))
            return multi_segments_sampling(self.max_frames, n_frames,
                                           random_shift=True, rng=rng)
        return uniform_sampling(self.max_frames, n_frames)

    def get_batch(self, indices: Sequence[int], pin_memory: bool = False
                  ) -> Dict[str, np.ndarray]:
        """One batch: numpy arrays, or with `pin_memory` tensors in pinned
        host memory (the frames gathered into it directly)."""
        idx = np.asarray(indices, np.int64)
        B, T = len(idx), self.max_frames
        frame_idx = np.zeros((B, T), np.int64)
        vmask = np.zeros((B, T), np.int32)
        for i, j in enumerate(idx):
            nf = int(self._num_frames[j])
            frame_idx[i] = self._sample_indices(nf, j)
            vmask[i, : min(nf, T)] = 1
        shape = (B, T, 3, self.size, self.size)
        # raw uint8 pixels (the model normalizes on the card) or float32
        dtype = torch.uint8 if self.device_normalize else torch.float32
        pinned = (torch.empty(shape, dtype=dtype, pin_memory=True)
                  if pin_memory else None)
        out = None if pinned is None else pinned.numpy()
        if self.device_normalize:
            video = self.store.gather_batch_u8(self._entry_ids[idx],
                                               frame_idx, size=self.size,
                                               out=out)
        else:
            video = self.store.gather_batch(self._entry_ids[idx], frame_idx,
                                            size=self.size, out=out)
        batch = {
            "input_ids": self._ids[idx],
            "attention_mask": self._mask[idx],
            "segment_ids": self._seg[idx],
            # [B, pair=1, T, 3, H, W]
            "video": (video if pinned is None else pinned)[:, None],
            "video_mask": vmask,
        }
        return pin_batch(batch) if pin_memory else batch

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        b = self.get_batch([i])
        return {k: v[0] for k, v in b.items()}
