# coding=utf-8
"""Where the time of a training step goes on the card.

    python -m centerclip_tpu_torch.profile_train [--batch 128] [--steps 1]
        [--preset msrvtt_vitb32_k6] [--remat 0|1] [--stream_scale A]

Builds a preset of the JAX package (by default `msrvtt_vitb32_k6`: ViT-B/32,
kmediods++ 12 -> 6 frames, meanP, bf16 towers, AdamW; `--remat` overrides
its `remat`) on seeded random weights (`--stream_scale` multiplies the
vision residual stream: `scale_vision_stream`) and a
`Trainer` over it, takes two warm-up steps on one batch of `--batch` seeded
uint8 clips with seeded token rows (tensors in pinned memory, as the data
loader hands them out on the card), then profiles `--steps` more under
`torch.profiler`: the wall time (host clock, ending in a device sync), the
device time summed over kernels and copies, the device's busy share, and
the device time by group (the port's five kernels, cuBLAS matmuls, the
optimizer's foreach kernels, copies, the rest) and by kernel name (with
launch counts), and the peak device memory allocated.  Exits non-zero without a CUDA device, if
the profiler records no device time, or, with a message and the peak
allocated so far, if the step does not fit in device memory.
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


def scale_vision_stream(model: CLIP4Clip, alpha: float) -> None:
    """Multiply a model's vision residual stream by `alpha`: ln_pre's weight
    and bias, every block's two output projections (attention's out_proj,
    the MLP's c_proj) and any cluster embedding added to it.  Every block
    reads the stream through a LayerNorm and ln_post normalises it, so the
    tower computes the same function (but for LayerNorm's eps and bf16
    rounding), and medoids scale with the stream; what reads its scale is
    spectral clustering's heat kernel exp(-d^2 / 2 sigma^2), which
    underflows off the diagonal (W = I) for tokens many sigma apart, as
    seeded random weights put them."""
    v = model.clip.visual
    params = [v.ln_pre.weight, v.ln_pre.bias]
    for block in v.transformer.resblocks:
        params += [block.attn.out_proj.weight, block.attn.out_proj.bias,
                   block.mlp.c_proj.weight, block.mlp.c_proj.bias]
        inter = block.tokencluster_inter
        if inter is not None and inter.has_embed:
            params.append(inter.cluster_embed)
    with torch.no_grad():
        for p in params:
            p.mul_(alpha)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--steps", type=int, default=1)
    ap.add_argument("--top", type=int, default=16)
    ap.add_argument("--preset", default="msrvtt_vitb32_k6")
    ap.add_argument("--remat", type=int, choices=(0, 1), default=None)
    ap.add_argument("--stream_scale", type=float, default=1.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_train: no CUDA device", file=sys.stderr)
        return 2
    print(torch.cuda.get_device_name(0))
    overrides = dict(batch_size=args.batch)
    if args.remat is not None:
        overrides["remat"] = bool(args.remat)
    run = preset(args.preset, **overrides)
    cfg = run.model
    print(f"{args.preset}, batch {args.batch}, remat {cfg.remat}, vision "
          f"stream scaled by {args.stream_scale}")
    model = CLIP4Clip(cfg, device="cuda", seed=0)
    scale_vision_stream(model, args.stream_scale)
    trainer = Trainer(run, model, total_steps=args.steps + 2)
    g = np.random.default_rng(0)
    ids = g.integers(1, 49406, (args.batch, cfg.max_words))
    ids[:, 0], ids[:, -1] = 49406, 49407
    batch = pin_batch({
        "input_ids": ids, "attention_mask": np.ones(ids.shape, np.int32),
        "video": g.integers(0, 256, (args.batch, 1, cfg.max_frames, 3,
                                     224, 224), dtype=np.uint8),
        "video_mask": np.ones((args.batch, cfg.max_frames), np.int32)})
    torch.cuda.reset_peak_memory_stats()
    try:
        trainer.train_epoch(0, [batch, batch], n_display=10 ** 9)  # warm-up
    except torch.OutOfMemoryError:
        print(f"out of device memory in a training step at batch "
              f"{args.batch} (peak allocated "
              f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB of "
              f"{torch.cuda.get_device_properties(0).total_memory / 2**30:.3f}"
              f" GiB)")
        return 1
    profile(f"{args.steps} training step(s) of {args.batch} clips (pinned "
            f"host batch)",
            lambda: trainer.train_epoch(1, [batch] * args.steps,
                                        n_display=10 ** 9), args.top)
    print(f"peak device memory allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    return 0


if __name__ == "__main__":
    sys.exit(main())
