# coding=utf-8
"""Frame sampling (host-side, NumPy) — TSN multi-segment and uniform.

The port's own copy of the JAX package's `ops/sampling.py`: the same
`np.random.Generator` draws give the same indices.  Semantics match the
reference exactly (reference: dataloaders/sampling.py)
since the sampled indices determine which frames feed the model and therefore
the retrieval numbers.  Randomness is injected via an explicit
`np.random.Generator` so the host pipeline is seedable and reproducible.
"""
from __future__ import annotations

from typing import Optional

import numpy as np


def multi_segments_sampling(clip_length: int, num_frames: int,
                            random_shift: bool = True, data_length: int = 1,
                            rng: Optional[np.random.Generator] = None
                            ) -> np.ndarray:
    """TSN-style sampling: split the video into `clip_length` segments and
    pick one frame per segment (random in train, the segment start otherwise)
    (reference: sampling.py:8-51)."""
    rng = rng or np.random.default_rng()
    if random_shift:
        average_duration = (num_frames - data_length + 1) // clip_length
        if average_duration > 0:
            offsets = (np.arange(clip_length) * average_duration
                       + rng.integers(0, average_duration, size=clip_length))
        elif num_frames > clip_length:
            offsets = np.sort(rng.choice(num_frames, clip_length,
                                         replace=False))
        else:
            offsets = np.clip(np.arange(0, clip_length * data_length,
                                        data_length),
                              0, num_frames - data_length)
    else:
        if num_frames > clip_length + data_length - 1:
            tick = (num_frames - data_length + 1) / float(clip_length)
            offsets = np.array([int(tick / 2.0 + tick * x)
                                for x in range(clip_length)])
        else:
            offsets = np.clip(np.arange(0, clip_length * data_length,
                                        data_length),
                              0, num_frames - data_length)
    return np.asarray(offsets, np.int64)


def token_sparse_sampling(target: int, total: int, random_shift: bool = True,
                          rng: Optional[np.random.Generator] = None
                          ) -> np.ndarray:
    """Randomly / uniformly sample `target` token indices from `total`
    (reference: cluster_utils.py:136-174)."""
    rng = rng or np.random.default_rng()
    if random_shift:
        average_duration = total // target
        if average_duration > 0:
            offsets = (np.arange(target) * average_duration
                       + rng.integers(0, average_duration, size=target))
        elif total > target:
            offsets = np.sort(rng.choice(total, target, replace=False))
        else:
            offsets = np.clip(np.arange(target), 0, total)
    else:
        if total > target:
            tick = total / float(target)
            offsets = np.array([int(tick / 2.0 + tick * x)
                                for x in range(target)])
        else:
            offsets = np.clip(np.arange(target), 0, total)
    return np.asarray(offsets, np.int64)


def uniform_sampling(clip_length: int, num_frames: int, data_length: int = 1,
                     twice_sample: bool = False) -> np.ndarray:
    """Segment-center sampling for eval (reference: sampling.py:54-81)."""
    if num_frames > clip_length + data_length - 1:
        tick = (num_frames - data_length + 1) / float(clip_length)
        if twice_sample:
            offsets = ([int(tick / 2.0 + tick * x) for x in range(clip_length)]
                       + [int(tick * x) for x in range(clip_length)])
        else:
            offsets = [int(tick / 2.0 + tick * x) for x in range(clip_length)]
        offsets = np.array(offsets)
    else:
        offsets = np.clip(np.arange(0, clip_length * data_length, data_length),
                          0, num_frames - data_length)
    return np.asarray(offsets, np.int64)
