# coding=utf-8
"""Pack a folder of videos into one FrameStore (port of the JAX package's
`preprocess/build_framestore.py`; the counterpart of the reference's LMDB
builder, preprocess/folder2lmdb.py).

Each input is decoded once, at the training fps and short side, and stored
as raw uint8 frames for mmap reads.  Inputs: a `.npy` of [T, H, W, C]
uint8 (no decoder needed), a directory of image frames (PIL), or a video
file (PyAV, imported only for one).  Files are taken in `os.walk` order
with each directory's names sorted, the key being the file name without
its extension, so the same folder gives the JAX tool's bytes.

    python -m centerclip_tpu_torch.preprocess.build_framestore \\
        --input_root videos/ --output videos.fstore
"""
from __future__ import annotations

import argparse
import os

import numpy as np

from ..data.framestore import FrameStoreWriter


def iter_videos(input_root: str):
    for root, _, files in os.walk(input_root):
        for fname in sorted(files):
            yield os.path.join(root, fname)


def _resize_short_side(img: np.ndarray, short: int) -> np.ndarray:
    from PIL import Image
    h, w = img.shape[:2]
    if min(h, w) == short:
        return img
    if h < w:
        nh, nw = short, max(int(round(w * short / h)) // 2 * 2, 2)
    else:
        nw, nh = short, max(int(round(h * short / w)) // 2 * 2, 2)
    return np.asarray(Image.fromarray(img).resize((nw, nh), Image.BILINEAR))


def decode_video_file(path: str, short_side: int = 224, fps: float = 3.0
                      ) -> np.ndarray:
    """A video file resampled to `fps` with short side `short_side`."""
    import av
    with av.open(path) as container:
        in_fps = float(container.streams.video[0].average_rate)
        step = max(int(round(in_fps / fps)), 1)
        frames = [_resize_short_side(f.to_rgb().to_ndarray(), short_side)
                  for i, f in enumerate(container.decode(video=0))
                  if i % step == 0]
    return np.stack(frames)


def load_frames(path: str, short_side: int, fps: float) -> np.ndarray:
    if path.endswith(".npy"):
        return np.load(path)
    if os.path.isdir(path):
        from PIL import Image
        files = sorted(f for f in os.listdir(path)
                       if f.lower().endswith((".jpg", ".jpeg", ".png")))
        return np.stack([np.asarray(Image.open(os.path.join(path, f))
                                    .convert("RGB")) for f in files])
    return decode_video_file(path, short_side, fps)


def video_key(path: str) -> str:
    """The store key of a file: its name without the last extension."""
    name = os.path.basename(path)
    return ".".join(name.split(".")[:-1]) if "." in name else name


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Pack a video folder into a .fstore frame container")
    parser.add_argument("--input_root", type=str, required=True)
    parser.add_argument("--output", type=str, required=True,
                        help="output .fstore path")
    parser.add_argument("--short_side", type=int, default=224)
    parser.add_argument("--fps", type=float, default=3.0)
    args = parser.parse_args(argv)
    n = 0
    with FrameStoreWriter(args.output) as writer:
        for path in iter_videos(args.input_root):
            try:
                frames = load_frames(path, args.short_side, args.fps)
            except Exception as e:      # an unreadable input is skipped
                print(f"SKIP {path}: {e}")
                continue
            writer.add(video_key(path), np.ascontiguousarray(frames, np.uint8))
            n += 1
            if n % 100 == 0:
                print(f"packed {n} videos")
    print(f"done: {n} videos -> {args.output}")
    return n


if __name__ == "__main__":
    main()
