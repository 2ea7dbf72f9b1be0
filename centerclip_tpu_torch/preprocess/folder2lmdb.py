# coding=utf-8
"""Pack raw video bytes into one LMDB keyed by file name (port of the JAX
package's `preprocess/folder2lmdb.py`; reference:
preprocess/folder2lmdb.py:11-68).  Needs py-lmdb (and PyAV for the decode
check); without it, `import lmdb` raises.  `build_framestore` is the
pre-decoded alternative.

    python -m centerclip_tpu_torch.preprocess.folder2lmdb \\
        --input_root videos/ --output videos.lmdb
"""
from __future__ import annotations

import argparse
import os


def folder2lmdb(input_root: str, output_path: str,
                map_size: int = 1 << 41) -> int:
    """Every file under `input_root` into `output_path`; returns the count."""
    import lmdb
    env = lmdb.open(output_path, subdir=False, map_size=map_size,
                    readonly=False, meminit=False, map_async=True)
    try:
        txn = env.begin(write=True)
        n = 0
        for root, _, files in os.walk(input_root):
            for fname in sorted(files):
                with open(os.path.join(root, fname), "rb") as f:
                    txn.put(fname.encode(), f.read())
                n += 1
                if n % 200 == 0:
                    txn.commit()
                    txn = env.begin(write=True)
                    print(f"packed {n}")
        txn.commit()
        env.sync()
    finally:
        env.close()
    print(f"done: {n} videos -> {output_path}")
    return n


def decode_test(lmdb_path: str, key: str) -> int:
    """Decode one stored video back (folder2lmdb.py:53-68); its frames."""
    import io
    import av
    import lmdb
    env = lmdb.open(lmdb_path, subdir=os.path.isdir(lmdb_path),
                    readonly=True, lock=False)
    try:
        with env.begin(write=False) as txn:
            data = txn.get(key.encode())
    finally:
        env.close()
    with av.open(io.BytesIO(data)) as container:
        n = sum(1 for _ in container.decode(video=0))
    print(f"{key}: {n} frames decoded OK")
    return n


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--input_root", type=str, required=True)
    parser.add_argument("--output", type=str, required=True)
    parser.add_argument("--test_key", type=str, default=None)
    args = parser.parse_args(argv)
    folder2lmdb(args.input_root, args.output)
    if args.test_key:
        decode_test(args.output, args.test_key)


if __name__ == "__main__":
    main()
