# coding=utf-8
"""Where the time of a training step goes on the card.

    python -m centerclip_tpu_torch.profile_train [--batch 128] [--steps 1]

Builds the JAX package's preset `msrvtt_vitb32_k6` (ViT-B/32, kmediods++
12 -> 6 frames, meanP, bf16 towers, AdamW) on seeded random weights and a
`Trainer` over it, takes two warm-up steps on one batch of `--batch` seeded
uint8 clips with seeded token rows (tensors in pinned memory, as the data
loader hands them out on the card), then profiles `--steps` more under
`torch.profiler`: the wall time (host clock, ending in a device sync), the
device time summed over kernels and copies, the device's busy share, and
the device time by group (the port's five kernels, cuBLAS matmuls, the
optimizer's foreach kernels, copies, the rest) and by kernel name.  Exits
non-zero without a CUDA device, or if the profiler records no device time.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from .config import preset
from .data.loader import pin_batch
from .models.clip4clip import CLIP4Clip
from .profile_serve import profile
from .train import Trainer


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--steps", type=int, default=1)
    ap.add_argument("--top", type=int, default=16)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_train: no CUDA device", file=sys.stderr)
        return 2
    print(torch.cuda.get_device_name(0))
    run = preset("msrvtt_vitb32_k6", batch_size=args.batch)
    cfg = run.model
    trainer = Trainer(run, CLIP4Clip(cfg, device="cuda", seed=0),
                      total_steps=args.steps + 2)
    g = np.random.default_rng(0)
    ids = g.integers(1, 49406, (args.batch, cfg.max_words))
    ids[:, 0], ids[:, -1] = 49406, 49407
    batch = pin_batch({
        "input_ids": ids, "attention_mask": np.ones(ids.shape, np.int32),
        "video": g.integers(0, 256, (args.batch, 1, cfg.max_frames, 3,
                                     224, 224), dtype=np.uint8),
        "video_mask": np.ones((args.batch, cfg.max_frames), np.int32)})
    trainer.train_epoch(0, [batch, batch], n_display=10 ** 9)   # warm-up
    profile(f"{args.steps} training step(s) of {args.batch} clips (pinned "
            f"host batch)",
            lambda: trainer.train_epoch(1, [batch] * args.steps,
                                        n_display=10 ** 9), args.top)
    return 0


if __name__ == "__main__":
    sys.exit(main())
