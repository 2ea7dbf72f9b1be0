# coding=utf-8
"""Where the time of the serving path goes on the card.

    python -m centerclip_tpu_torch.profile_serve [--batch 32] [--queries 4]

Builds the flagship CLIP4Clip (`config.flagship_config`, bf16, seeded random
weights), warms up (`RetrievalEngine.warmup`), then runs one gallery batch
of `--batch` seeded uint8 clips twice, from pageable numpy arrays and from
pinned tensors (as the data registry's loaders hand them to
`serve/cli.py build`), and one search of `--queries` texts, each under
`torch.profiler`.  For each it prints the wall time (host clock, ending in
a device sync), the device time summed over kernels and copies, the
device's busy share of the wall time, and the device time by group (the
port's kernels, cuBLAS matmuls, copies, the rest) and by kernel name; last
the copies' share of the encode's device time, pageable and pinned.  Exits
non-zero without a CUDA device, or if the profiler records no device time.
`profile` is shared with `profile_train.py`.
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

GROUPS = (("attention kernel", ("attention_fwd_mma_kernel",
                                 "attention_fwd_long_kernel",
                                 "attention_fwd_kernel")),
          ("attention bwd kernel", ("attention_bwd_mma_kernel",
                                    "attention_bwd_dq_kernel",
                                    "attention_bwd_dkv_kernel",
                                    "attention_bwd_kernel")),
          ("layernorm kernel", ("_ln_fwd",)),
          ("layernorm bwd kernel", ("_ln_bwd",)),
          ("kmedoids kernel", ("kmedoids_kernel",)),
          ("matmul (cuBLAS)", ("gemm", "xmma", "nvjet", "cutlass", "sm90")),
          ("optimizer (foreach)", ("multi_tensor_apply",)),
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


def profile(label: str, fn, top: int) -> dict:
    """Run `fn` once under torch.profiler and print its breakdown; returns
    {"wall_ms", "device_ms", "by_group_ms"}."""
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
    return {"wall_ms": wall_us / 1e3, "device_ms": device_us / 1e3,
            "by_group_ms": {k: v / 1e3 for k, v in by_group.items()}}


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
    pinned = {k: torch.from_numpy(v).pin_memory() for k, v in batch.items()}
    engine.build_index([pinned], [f"v{i}" for i in range(args.batch)],
                       quantize="int8")
    engine.warmup(k=5, max_queries=args.queries)
    for _ in range(2):                                      # warm-up
        engine.embed_video_batches([batch])
        engine.embed_video_batches([pinned])
        engine.search(texts, k=5)
    share = {}
    for kind, b in (("pageable", batch), ("pinned", pinned)):
        r = profile(f"gallery batch of {args.batch} clips ({kind})",
                    lambda: engine.embed_video_batches([b]), args.top)
        share[kind] = r["by_group_ms"].get("copies", 0.0) / r["device_ms"]
    profile(f"search of {len(texts)} queries",
            lambda: engine.search(texts, k=5), args.top)
    print(f"copies' share of the encode's device time: pageable "
          f"{100 * share['pageable']:.1f}%, pinned "
          f"{100 * share['pinned']:.1f}%")
    return 0


if __name__ == "__main__":
    sys.exit(main())
