# coding=utf-8
"""LSMDC downloader (port of the JAX package's
`preprocess/download_lsmdc.py`; reference: preprocess/download_lsmdc.py):
an authenticated `wget` of each clip URL of a list, several at a time.
It needs network access and the dataset's credentials; `compress_video`
and `build_framestore` come after it.

    python -m centerclip_tpu_torch.preprocess.download_lsmdc \\
        --url_list urls.txt --output_dir raw/ --user U --password P
"""
from __future__ import annotations

import argparse
import os
import subprocess
from concurrent.futures import ThreadPoolExecutor


def wget_command(url: str, dst: str, user: str, password: str) -> list:
    return ["wget", "-q", f"--user={user}", f"--password={password}",
            "-O", dst, url]


def download_one(url: str, out_dir: str, user: str, password: str) -> int:
    """wget's exit code; 0 without a call when the file is already there."""
    dst = os.path.join(out_dir, url.split("/")[-1])
    if os.path.exists(dst):
        return 0
    return subprocess.run(wget_command(url, dst, user, password)).returncode


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--url_list", type=str, required=True,
                        help="text file with one clip URL per line")
    parser.add_argument("--output_dir", type=str, required=True)
    parser.add_argument("--user", type=str, required=True)
    parser.add_argument("--password", type=str, required=True)
    parser.add_argument("--num_works", type=int, default=8)
    args = parser.parse_args(argv)
    os.makedirs(args.output_dir, exist_ok=True)
    with open(args.url_list) as f:
        urls = [u.strip() for u in f if u.strip()]
    with ThreadPoolExecutor(max_workers=args.num_works) as pool:
        codes = list(pool.map(
            lambda u: download_one(u, args.output_dir, args.user,
                                   args.password), urls))
    failed = sum(1 for c in codes if c != 0)
    print(f"downloaded {len(urls) - failed}/{len(urls)}")
    return failed


if __name__ == "__main__":
    main()
