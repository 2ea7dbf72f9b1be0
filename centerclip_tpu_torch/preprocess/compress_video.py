# coding=utf-8
"""Re-encode videos to 3 fps with a 224-pixel short side (port of the JAX
package's `preprocess/compress_video.py`; reference:
preprocess/compress_video.py).  Needs `ffmpeg` on the PATH and exits with
"ffmpeg not found on PATH" without it.

    python -m centerclip_tpu_torch.preprocess.compress_video \\
        --input_root raw/ --output_root videos/
"""
from __future__ import annotations

import argparse
import os
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor

# the reference's filter: the short side to 224, aspect kept, even sizes
# (compress_video.py:17-24)
SCALE_FILTER = ("scale='if(gt(a,1),trunc(oh*a/2)*2,224)'"
                ":'if(gt(a,1),224,trunc(ow*a/2)*2)'")


def ffmpeg_command(src: str, dst: str, fps: int = 3) -> list:
    return ["ffmpeg", "-y", "-i", src, "-filter:v", SCALE_FILTER,
            "-map", "0:v", "-r", str(fps), dst]


def compress(pair, fps: int = 3):
    """(src, dst) -> (dst, ffmpeg's exit code)."""
    src, dst = pair
    proc = subprocess.run(ffmpeg_command(src, dst, fps),
                          stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                          stderr=subprocess.PIPE)
    return dst, proc.returncode


def prepare_pairs(input_root: str, output_root: str, ignore_exist=True):
    pairs = []
    for root, _, files in os.walk(input_root):
        for fname in files:
            dst = os.path.join(output_root, fname)
            if ignore_exist and os.path.exists(dst):
                continue
            pairs.append((os.path.join(root, fname), dst))
    return pairs


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Compress videos to 3fps / 224px for training")
    parser.add_argument("--input_root", type=str, required=True)
    parser.add_argument("--output_root", type=str, required=True)
    parser.add_argument("--num_works", type=int, default=16)
    parser.add_argument("--fps", type=int, default=3)
    args = parser.parse_args(argv)
    if args.input_root == args.output_root:
        raise SystemExit("--output_root must differ from --input_root")
    if shutil.which("ffmpeg") is None:
        raise SystemExit("ffmpeg not found on PATH")
    os.makedirs(args.output_root, exist_ok=True)
    pairs = prepare_pairs(args.input_root, args.output_root)
    print(f"Total videos to process: {len(pairs)}")
    failed = []
    with ThreadPoolExecutor(max_workers=args.num_works) as pool:
        for i, (dst, code) in enumerate(
                pool.map(lambda p: compress(p, args.fps), pairs)):
            if code != 0:
                failed.append(dst)
                print(f"FAILED: {dst}")
            if (i + 1) % 100 == 0:
                print(f"{i + 1}/{len(pairs)}")
    return failed


if __name__ == "__main__":
    main()
