# coding=utf-8
"""Integrity scan of a video folder (port of the JAX package's
`preprocess/check_video.py`; reference: preprocess/check_video.py): open
and decode every file and report the broken ones, for the datasets' skip
lists.  Takes `.npy` frame dumps, `.fstore` containers and video files
(PyAV, imported only for one; without it a video file counts as broken).

    python -m centerclip_tpu_torch.preprocess.check_video --input_root videos/
"""
from __future__ import annotations

import argparse
import os

import numpy as np


def check_file(path: str) -> bool:
    """True when every frame of `path` decodes and there is at least one."""
    try:
        if path.endswith(".npy"):
            arr = np.load(path, mmap_mode="r")
            return arr.ndim == 4 and arr.shape[0] > 0
        if path.endswith(".fstore"):
            from ..data.framestore import FrameStore
            store = FrameStore(path)
            try:
                return all(store.get(key).shape[0] > 0
                           for key in store.keys())
            finally:
                store.close()
        import av
        with av.open(path) as container:
            return sum(1 for _ in container.decode(video=0)) > 0
    except Exception:           # any failure to read is what is reported
        return False


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--input_root", type=str, required=True)
    args = parser.parse_args(argv)
    broken, total = [], 0
    for root, _, files in os.walk(args.input_root):
        for fname in sorted(files):
            path = os.path.join(root, fname)
            total += 1
            if not check_file(path):
                broken.append(path)
                print(f"BROKEN: {path}")
    print(f"checked {total} files; {len(broken)} broken")
    return broken


if __name__ == "__main__":
    main()
