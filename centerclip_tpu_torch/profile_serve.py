# coding=utf-8
"""Where the time of the serving path goes on the card.

    python -m centerclip_tpu_torch.profile_serve [--batch 32] [--queries 4]

Builds the flagship CLIP4Clip (`config.flagship_config`, bf16, seeded random
weights), warms up, then runs one gallery batch of `--batch` seeded uint8
clips and one search of `--queries` texts under `torch.profiler`.  For each
it prints the wall time (host clock, ending in a device sync), the device
time summed over kernels and copies, the device's busy share of the wall
time, and the device time by group (the port's three kernels, cuBLAS
matmuls, copies, the rest) and by kernel name.  Exits non-zero without a
CUDA device, or if the profiler records no device time.
"""
from __future__ import annotations

import argparse
import collections
import sys
import time

import numpy as np
import torch

from .config import flagship_config
from .models.clip4clip import CLIP4Clip
from .serve import RetrievalEngine

GROUPS = (("attention kernel", ("attention_fwd_kernel",)),
          ("layernorm kernel", ("_ln_fwd",)),
          ("kmedoids kernel", ("kmedoids_kernel",)),
          ("matmul (cuBLAS)", ("gemm", "xmma", "nvjet", "cutlass", "sm90")),
          ("copies", ("memcpy", "memset")))
QUERIES = ["a man is cooking pasta in a kitchen",
           "two dogs are playing in the snow",
           "a woman sings on a stage while people dance",
           "a car drives along a mountain road at night"]


def _group(name: str) -> str:
    low = name.lower()
    for group, keys in GROUPS:
        if any(k.lower() in low for k in keys):
            return group
    return "other"


def profile(label: str, fn, top: int) -> None:
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.time() - t0) * 1e6
    by_name = collections.Counter()
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            by_name[evt.name] += evt.time_range.elapsed_us()
    device_us = sum(by_name.values())
    if device_us == 0:
        raise SystemExit(f"{label}: the profiler recorded no device time")
    by_group = collections.Counter()
    for name, us in by_name.items():
        by_group[_group(name)] += us
    print(f"{label}: wall {wall_us / 1e3:.3f} ms, device {device_us / 1e3:.3f}"
          f" ms, busy {100 * device_us / wall_us:.1f}% of wall")
    for group, us in by_group.most_common():
        print(f"  {group:18s} {us / 1e3:9.3f} ms {100 * us / device_us:5.1f}%")
    for name, us in by_name.most_common(top):
        print(f"    {us / 1e3:9.3f} ms  {name[:100]}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--queries", type=int, default=4)
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_serve: no CUDA device", file=sys.stderr)
        return 2
    print(torch.cuda.get_device_name(0))
    cfg = flagship_config()
    engine = RetrievalEngine(CLIP4Clip(cfg, device="cuda", seed=0),
                             device="cuda")
    g = np.random.default_rng(0)
    batch = {"video": g.integers(0, 256, (args.batch, 1, cfg.max_frames, 3,
                                          224, 224), dtype=np.uint8),
             "video_mask": np.ones((args.batch, cfg.max_frames), np.int32)}
    texts = (QUERIES * args.queries)[: args.queries]
    engine.build_index([batch], [f"v{i}" for i in range(args.batch)],
                       quantize="int8")
    for _ in range(2):                                      # warm-up
        engine.embed_video_batches([batch])
        engine.search(texts, k=5)
    profile(f"gallery batch of {args.batch} clips",
            lambda: engine.embed_video_batches([batch]), args.top)
    profile(f"search of {len(texts)} queries",
            lambda: engine.search(texts, k=5), args.top)
    return 0


if __name__ == "__main__":
    sys.exit(main())
