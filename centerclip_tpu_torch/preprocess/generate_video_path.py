# coding=utf-8
"""Write the video_id -> relative path JSON that the LSMDC and ActivityNet
loaders read (port of the JAX package's
`preprocess/generate_video_path.py`; reference:
preprocess/generate_video_path.py).

    python -m centerclip_tpu_torch.preprocess.generate_video_path \\
        --features_path videos/ --output video_path.json
"""
from __future__ import annotations

import argparse
import json
import os

VIDEO_EXTS = (".mp4", ".avi", ".mkv", ".webm", ".3gp", ".mpg", ".mov",
              ".npy")


def video_paths(features_path: str) -> dict:
    """{video id: path relative to features_path} of every video file."""
    mapping = {}
    for root, _, files in os.walk(features_path):
        for fname in sorted(files):
            if fname.lower().endswith(VIDEO_EXTS):
                mapping[".".join(fname.split(".")[:-1])] = os.path.relpath(
                    os.path.join(root, fname), features_path)
    return mapping


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser()
    parser.add_argument("--features_path", type=str, required=True)
    parser.add_argument("--output", type=str, required=True)
    args = parser.parse_args(argv)
    mapping = video_paths(args.features_path)
    with open(args.output, "w") as f:
        json.dump(mapping, f, indent=2)
    print(f"wrote {len(mapping)} entries to {args.output}")
    return mapping


if __name__ == "__main__":
    main()
