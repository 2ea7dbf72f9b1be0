# coding=utf-8
"""Where the time of a training step goes on the card.

    python -m centerclip_tpu_torch.profile_train [--batch 128] [--steps 1]
        [--preset msrvtt_vitb32_k6] [--remat 0|1] [--precision amp|fp32]
        [--stream_scale A]
        [--sim_header meanP|seqTransf|tightTransf] [--cross_logits N]
        [--cluster_num_blocks K1 ... K12] [--target_frames_blocks T1 ... T12]
        [--max_frames F]
    torchrun --nproc_per_node N -m centerclip_tpu_torch.profile_train \
        [--fsdp 0|1] [--tensor_parallel T [--sequence_parallel 1] |
         --pipeline_parallel S [--pipeline_microbatches M]]
        [the flags above]

Builds a preset of the JAX package (by default `msrvtt_vitb32_k6`: ViT-B/32,
kmediods++ 12 -> 6 frames, meanP, bf16 towers, AdamW; `--remat` overrides
its `remat`, `--precision fp32` its towers' bf16 (as the CLI's flag of
that name does; `amp`, the default, keeps bf16), `--sim_header` its
header, `--cluster_num_blocks` and
`--target_frames_blocks` its cluster plan and `--max_frames` its frames a
clip, as the CLI's flags of those names do; e.g. chip_smoke.py's sixteenth
path: `--preset msrvtt_vitb16_k6 --remat 1 --batch 16 --max_frames 60
--cluster_num_blocks 196 x 6 160 x 6 --target_frames_blocks 60 x 6 3 x 6`) on seeded random weights (`--stream_scale` multiplies the
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
allocated so far, if the step does not fit in device memory.  With
tightTransf, `--cross_logits N` then profiles one chunk of the evaluation's
scoring from seeded cached features: `--cross_chunk` texts against N
videos through the cross model (`CLIP4Clip.cross_similarity`), with the
cross model's matmul FLOPs over the cuBLAS group's device time.

Under `torchrun` each model group takes `--batch / (N / T)` rows of the
global batch under DDP, or FSDP with `--fsdp 1`, over the N / T data
shards, its T ranks with `--tensor_parallel T` holding the slices of one
model (the `Trainer`'s wrapper); with `--pipeline_parallel S` each pipe
group of S ranks takes `--batch / (N / S)` rows and runs the towers' block
runs as S stages on the GPipe schedule; rank 0 (stage 0) prints its own
card's profile; NCCL's kernels are a group of their own,
and they overlap the compute streams, so the device time can exceed the
wall.  Build the kernels first (`ops/_build.py`), not in N ranks at once.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys

import numpy as np
import torch

from .config import preset
from .data.loader import pin_batch
from .models.clip4clip import CLIP4Clip
from .parallel.mesh import init_distributed, process_index, world_size
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
    ap.add_argument("--precision", choices=("amp", "fp32"), default="amp")
    ap.add_argument("--stream_scale", type=float, default=1.0)
    ap.add_argument("--sim_header", default=None,
                    choices=("meanP", "seqTransf", "tightTransf"))
    ap.add_argument("--cluster_num_blocks", type=int, nargs="+",
                    default=None)
    ap.add_argument("--target_frames_blocks", type=int, nargs="+",
                    default=None)
    ap.add_argument("--max_frames", type=int, default=None)
    ap.add_argument("--cross_logits", type=int, default=0)
    ap.add_argument("--cross_chunk", type=int, default=64)
    ap.add_argument("--fsdp", type=int, choices=(0, 1), default=0)
    ap.add_argument("--tensor_parallel", type=int, default=1)
    ap.add_argument("--sequence_parallel", type=int, choices=(0, 1),
                    default=0)
    ap.add_argument("--pipeline_parallel", type=int, default=1)
    ap.add_argument("--pipeline_microbatches", type=int, default=0)
    args = ap.parse_args(argv)
    if args.cross_logits and args.sim_header != "tightTransf":
        ap.error("--cross_logits needs --sim_header tightTransf")
    if not torch.cuda.is_available():
        print("profile_train: no CUDA device", file=sys.stderr)
        return 2
    dev = init_distributed()
    world = world_size()
    if process_index() != 0:          # rank 0 prints its card's profile
        sys.stdout = open(os.devnull, "w")
    print(f"{torch.cuda.get_device_name(dev)}, {world} process(es), fsdp "
          f"{args.fsdp}, tensor_parallel {args.tensor_parallel}, "
          f"sequence_parallel {args.sequence_parallel}, pipeline_parallel "
          f"{args.pipeline_parallel}")
    overrides = dict(batch_size=args.batch, fsdp=bool(args.fsdp),
                     tensor_parallel=args.tensor_parallel,
                     sequence_parallel=bool(args.sequence_parallel),
                     pipeline_parallel=args.pipeline_parallel,
                     pipeline_microbatches=args.pipeline_microbatches)
    if args.remat is not None:
        overrides["remat"] = bool(args.remat)
    if args.precision == "fp32":
        overrides.update(precision="fp32", compute_dtype="float32")
    if args.sim_header is not None:
        overrides["sim_header"] = args.sim_header
    for name in ("cluster_num_blocks", "target_frames_blocks"):
        if getattr(args, name) is not None:
            overrides[name] = tuple(getattr(args, name))
    if args.max_frames is not None:
        overrides["max_frames"] = args.max_frames
    run = preset(args.preset, **overrides)
    cfg = run.model
    print(f"{args.preset}, batch {args.batch}, {cfg.max_frames} frames, "
          f"remat {cfg.remat}, "
          f"compute dtype {cfg.compute_dtype}, sim_header {cfg.sim_header}, cluster_num_blocks "
          f"{cfg.cluster.cluster_num_blocks}, target_frames_blocks "
          f"{cfg.cluster.target_frames_blocks}, vision stream scaled by "
          f"{args.stream_scale}")
    model = CLIP4Clip(cfg, device=dev, seed=0)
    scale_vision_stream(model, args.stream_scale)
    trainer = Trainer(run, model, total_steps=args.steps + 2)
    group = args.tensor_parallel * args.pipeline_parallel
    shards = world // group             # a model or pipe group's rows
    rows = args.batch // shards
    g = np.random.default_rng(process_index() // group)
    ids = g.integers(1, 49406, (rows, cfg.max_words))
    ids[:, 0], ids[:, -1] = 49406, 49407
    batch = pin_batch({
        "input_ids": ids, "attention_mask": np.ones(ids.shape, np.int32),
        "video": g.integers(0, 256, (rows, 1, cfg.max_frames, 3,
                                     224, 224), dtype=np.uint8),
        "video_mask": np.ones((rows, cfg.max_frames), np.int32)})
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
    profile(f"{args.steps} training step(s) of {args.batch} clips, "
            f"{rows} on this card (pinned host batch)",
            lambda: trainer.train_epoch(1, [batch] * args.steps,
                                        n_display=10 ** 9), args.top)
    print(f"peak device memory allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    if args.cross_logits:
        del trainer, batch
        torch.cuda.empty_cache()
        cross_chunk(model.eval(), args.cross_logits, args.cross_chunk,
                    args.top)
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
    return 0


def cross_chunk(model: CLIP4Clip, n: int, chunk: int, top: int) -> None:
    """Profile tightTransf's scoring of `chunk` texts against `n` videos
    from seeded cached features ([chunk, 1, D], [n, T', D]): `chunk * n`
    pairs of 1 + T' tokens through the cross model's blocks and pooler,
    in fp32 without TF32.  Prints the cross model's matmul FLOPs over the
    cuBLAS group's device time and over the whole device time."""
    cfg = model.cfg
    D, T = cfg.arch["embed_dim"], cfg.final_frames
    gen = torch.Generator(device="cuda").manual_seed(0)
    seq = torch.randn((chunk, 1, D), generator=gen, device="cuda")
    vis = torch.randn((n, T, D), generator=gen, device="cuda")
    vmask = torch.ones((n, T), dtype=torch.int32, device="cuda")
    model.cfg = dataclasses.replace(cfg, cross_chunk_size=chunk)
    with torch.inference_mode():
        model.cross_similarity(seq, vis, vmask)                  # warm-up
        res = profile(f"tightTransf scoring of {chunk} texts x {n} videos "
                      f"(one chunk)",
                      lambda: model.cross_similarity(seq, vis, vmask), top)
    model.cfg = cfg
    # per pair: L tokens through each block (qkv 3 D^2, out D^2, MLP
    # 8 D^2; the scores and their product with V 2 L D) and the pooler D^2
    L = 1 + T
    flop = 2.0 * chunk * n * (cfg.cross_num_hidden_layers * L * (
        12 * D * D + 2 * L * D) + D * D)
    mm_ms = res["by_group_ms"].get("matmul (cuBLAS)", 0.0)
    if mm_ms == 0.0:
        raise SystemExit("the profile holds no kernel of the cuBLAS group")
    print(f"cross model matmuls {flop / 1e12:.3f} TFLOP: "
          f"{flop / mm_ms / 1e9:.2f} TFLOP/s over the cuBLAS group's "
          f"{mm_ms:.3f} ms ({100 * mm_ms / res['device_ms']:.1f} % of "
          f"device time), {flop / res['device_ms'] / 1e9:.2f} TFLOP/s over "
          f"all device time, {flop / res['wall_ms'] / 1e9:.2f} over the "
          f"wall")


if __name__ == "__main__":
    sys.exit(main())
