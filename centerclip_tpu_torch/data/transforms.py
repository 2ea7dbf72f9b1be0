# coding=utf-8
"""Host-side video transforms (NumPy).

The port's own copy of the JAX package's `data/transforms.py`.  Equivalents
of the reference's tensor-domain transforms (reference:
dataloaders/transforms.py) on numpy arrays, so a decode thread holds no
tensor.  The eval/train pipeline the reference actually
uses is: ToTensor(/255) -> CenterCrop(224) -> Normalize(CLIP stats)
(reference: dataloaders/decode.py:32-49).
"""
from __future__ import annotations

import random
from typing import List, Optional, Sequence, Tuple

import numpy as np

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def group_to_bchw(frames: Sequence[np.ndarray], div: bool = True) -> np.ndarray:
    """List of [H, W, C] uint8 frames -> [T, C, H, W] float32 (/255)
    (reference: transforms.py:137-165)."""
    x = np.stack([np.asarray(f) for f in frames], axis=0)     # [T, H, W, C]
    x = np.transpose(x, (0, 3, 1, 2)).astype(np.float32)
    if div:
        x = x / 255.0
    return x


def center_crop(x: np.ndarray, size: int) -> np.ndarray:
    """[T, C, H, W] -> [T, C, size, size]; zero-pads when smaller (matching
    torchvision CenterCrop semantics used at decode.py:39,48)."""
    T, C, H, W = x.shape
    if H < size or W < size:
        ph, pw = max(size - H, 0), max(size - W, 0)
        x = np.pad(x, ((0, 0), (0, 0),
                       (ph // 2, ph - ph // 2), (pw // 2, pw - pw // 2)))
        T, C, H, W = x.shape
    top = (H - size) // 2
    left = (W - size) // 2
    return x[:, :, top:top + size, left:left + size]


def normalize(x: np.ndarray, mean=CLIP_MEAN, std=CLIP_STD) -> np.ndarray:
    """Per-channel normalize on [T, C, H, W] (reference: transforms.py:19-34)."""
    mean = np.asarray(mean, np.float32).reshape(1, -1, 1, 1)
    std = np.asarray(std, np.float32).reshape(1, -1, 1, 1)
    return (x - mean) / std


def random_horizontal_flip(x: np.ndarray, p: float = 0.5,
                           rng: Optional[np.random.Generator] = None
                           ) -> np.ndarray:
    """Flip the whole group with probability p
    (reference: transforms.py:168-196)."""
    rng = rng or np.random.default_rng()
    if rng.random() < p:
        return x[..., ::-1].copy()
    return x


def multi_scale_crop(x: np.ndarray, size: int,
                     scales: Sequence[float] = (1.0, 0.875, 0.75, 0.66),
                     max_distort: int = 1, fix_crop: bool = True,
                     more_fix_crop: bool = True,
                     rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """TSN-style multi-scale crop with fixed offsets
    (reference: transforms.py:37-134): pick a (w, h) crop from paired scale
    choices with |i-j| <= max_distort, at one of the canonical offsets, then
    resize to (size, size)."""
    rng = rng or np.random.default_rng()
    T, C, H, W = x.shape
    base = min(H, W)
    crop_sizes = [int(base * s) for s in scales]
    crop_sizes = [size if abs(c - size) < 3 else c for c in crop_sizes]
    pairs = [(w, h) for i, h in enumerate(crop_sizes)
             for j, w in enumerate(crop_sizes) if abs(i - j) <= max_distort]
    cw, ch = pairs[rng.integers(len(pairs))]
    if not fix_crop:
        x1 = int(rng.integers(0, W - cw + 1))
        y1 = int(rng.integers(0, H - ch + 1))
    else:
        x1, y1 = _sample_fix_offset(W, H, cw, ch, more_fix_crop, rng)
    crop = x[:, :, y1:y1 + ch, x1:x1 + cw]
    return _resize_bilinear(crop, size, size)


def _sample_fix_offset(W, H, cw, ch, more_fix_crop, rng):
    w_step, h_step = (W - cw) // 4, (H - ch) // 4
    offsets = [(0, 0), (4 * w_step, 0), (0, 4 * h_step),
               (4 * w_step, 4 * h_step), (2 * w_step, 2 * h_step)]
    if more_fix_crop:
        offsets += [(0, 2 * h_step), (4 * w_step, 2 * h_step),
                    (2 * w_step, 4 * h_step), (2 * w_step, 0),
                    (1 * w_step, 1 * h_step), (3 * w_step, 1 * h_step),
                    (1 * w_step, 3 * h_step), (3 * w_step, 3 * h_step)]
    return offsets[rng.integers(len(offsets))]


def _resize_bilinear(x: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Bilinear resize on [T, C, H, W] (align_corners=False convention)."""
    T, C, H, W = x.shape
    if H == out_h and W == out_w:
        return x
    ys = (np.arange(out_h) + 0.5) * H / out_h - 0.5
    xs = (np.arange(out_w) + 0.5) * W / out_w - 0.5
    y0 = np.clip(np.floor(ys).astype(np.int64), 0, H - 1)
    y1 = np.clip(y0 + 1, 0, H - 1)
    x0 = np.clip(np.floor(xs).astype(np.int64), 0, W - 1)
    x1 = np.clip(x0 + 1, 0, W - 1)
    wy = np.clip(ys - y0, 0, 1).astype(np.float32)
    wx = np.clip(xs - x0, 0, 1).astype(np.float32)
    top = (x[:, :, y0][:, :, :, x0] * (1 - wx) +
           x[:, :, y0][:, :, :, x1] * wx)
    bot = (x[:, :, y1][:, :, :, x0] * (1 - wx) +
           x[:, :, y1][:, :, :, x1] * wx)
    return top * (1 - wy[None, None, :, None]) + bot * wy[None, None, :, None]


def clip_transform_uint8(frames: Sequence[np.ndarray], size: int = 224
                         ) -> np.ndarray:
    """Raw-pixel pipeline: [H, W, C] uint8 frames -> [T, C, size, size]
    uint8 (centre-cropped, NOT normalised).

    The /255 + CLIP-stat normalisation happens on device
    (models/clip4clip.py get_visual_output), so the host ships 4x fewer
    bytes than the float32 pipeline; zero-padding smaller frames matches the
    float path (0 uint8 -> 0.0 after /255)."""
    x = np.stack([np.asarray(f) for f in frames], axis=0)     # [T, H, W, C]
    x = np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2)))   # [T, C, H, W]
    return center_crop(x, size)


def clip_eval_transform(frames: Sequence[np.ndarray], size: int = 224
                        ) -> np.ndarray:
    """The reference's eval pipeline (decode.py:44-49)."""
    return normalize(center_crop(group_to_bchw(frames), size))


def clip_train_transform(frames: Sequence[np.ndarray], size: int = 224,
                         rng: Optional[np.random.Generator] = None
                         ) -> np.ndarray:
    """The reference's train pipeline — identical to eval (the crop/flip
    augmentations are commented out at decode.py:32-42)."""
    return normalize(center_crop(group_to_bchw(frames), size))
