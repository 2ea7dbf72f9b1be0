#!/usr/bin/env python3
# coding=utf-8
"""Drive the PyTorch/CUDA port (`centerclip_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

1. Prints the card (nvidia-smi name and power limit), checks that TF32 is
   off (cuBLAS at start, cuDNN after the first model build), and builds the CUDA C++ kernels and the FrameStore reader from
   `centerclip_tpu_torch/csrc` (one nvcc per kernel source and the host
   compiler for the reader, all started together).
2. Serving phase, the first main path: a full-width ViT-B/32 CLIP4Clip
   (meanP, kmediods++ clustering 12 -> 6 frames before block 7, K = 49,
   bf16 towers) on seeded random weights; `RetrievalEngine.build_index` over
   64 seeded uint8 clips [12, 3, 224, 224] in batches of 32 (int8 index),
   then `search` with 4 text queries (k = 5).  Every kernel's launch count
   is zeroed just before this phase; after it exactly the forward kernels'
   (A, C, E and F's forward) must have moved; the
   attention forward must have run its tensor-core variant only (its fp32
   CUDA-core variant's count must not move).
3. Training phase, the second main path: the JAX package's preset
   `msrvtt_vitb32_k6` (the same model; AdamW lr 2e-3, coef_lr 1e-3, wd 0.2,
   warmup 0.1, freeze_layer_num 0) at its batch of 128 seeded clips with
   128 seeded token rows of 32; 2 untimed and 5 timed steps through
   `Trainer.train_epoch` (forward, symmetric InfoNCE, backward through
   kernels A-F, clip, update, logit-scale clamp).  The counts of kernels
   A-F are zeroed just before the steps and must have moved after them (F's
   by exactly 24 a step each way), the attention forward and backward
   through their tensor-core variants only.
   Then a checkpoint is saved and resumed into a fresh model and optimizer,
   one more step from each must give equal parameters, and
   `Evaluator.evaluate` runs on 64 of the clips with their texts.
4. Kernel phase: each kernel against its plain PyTorch version on the card,
   on the main paths' shapes (the k-medoids inputs are the tokens the
   serving phase and the first training step clustered; the forward kernels
   at the serving and the training shapes; the backward kernels at the
   training batch's shapes, where the autograd Function must return the
   kernel's gradient bit for bit, and the LayerNorm backward must return
   the same bits from a second call; its device launches per call are
   counted in a CUDA graph that one call is captured into), with errors,
   CUDA-event times, the time
   of one PyTorch library call for the same function where there is one
   (SDPA; its backward by `torch.autograd.grad`, so nothing accumulates
   into `.grad` between timed calls), the kernel's time over it, and the
   least time the card could take (bytes over the memory rate, or
   operations over the peak rate, whichever is larger).
5. CPU checks: 2 clips and the 4 queries again through the port on the CPU
   (plain versions, same weights and dtype), held to the card's embeddings
   by cosine; and one training step on 2 clips on the card and on the CPU
   from the same weights, held by loss and by the cosine of every large
   gradient.
6. Main phase, the third main path: `python -m centerclip_tpu_torch.main`'s
   `main(argv)` with scripts/msrvtt.sh's `common` flags and experiment 62
   (batch 128, ViT-B/32 kmediods++ 49 x 12, 12 -> 6 frames, bf16), changed
   only in `--features_path` (a .fstore), `--epochs 1`, `--n_display 1`,
   and the output and pretrained directories (a temporary directory in the
   checkout, so the run reads nothing outside it; no ViT-B-32.pt there, so
   seeded weights).  The data is a synthetic MSR-VTT shaped like
   preprocess/compress_video.py's output: 48 videos of 36 seeded uint8
   frames of 224 x 298 (12 s at 3 fps), as .npy files and one .fstore,
   train.csv / test.csv and 8 captions per video.  Run 1 trains 3 steps of
   128 through the pinned loader and kernels A-F (counts zeroed just
   before, read just after; attention on its tensor-core variants only)
   and evaluates the 48 clips in one ragged batch; run 2 reloads its
   ckpt.pth.tar with `--do_train 0 --do_eval 1 --init_model` and must give
   the same metrics and similarity matrix to the bit.  The first input of
   each shape that the attention forward, the LayerNorm forward and
   k-medoids took in the evaluation (its ragged batch of 48 clips and 48
   texts) is recorded at the model's call sites and each kernel is held
   against its plain version on it, with the kernel phase's tolerances.
   The first eval batch of the .npy loader must equal the .fstore loader's
   byte for byte.

7. ViT-B/16 phase, the fourth main path: the preset `msrvtt_vitb16_k6`
   (12 frames of 224 x 224 at patch 16: L = 197 in blocks 1-6; k-medoids of
   2 x 196 = 392 tokens per segment into K = 160 before block 7, L = 161
   after) on seeded random weights (no ViT-B-16.pt in the repo).  First an
   encode of 64 seeded clips through `RetrievalEngine` (batches of 32),
   timed after a 2-clip warm-up and once more (what the first one paid
   for first calls at a batch of 32 is the difference), and one search;
   then 2 untimed and 3 timed training steps at the recipe's
   batch of 128 with `remat` (without it the step does not fit in 80 GB),
   the peak memory printed, and one checkpoint-and-resume step that must
   equal the uninterrupted one.  Counts are zeroed before the encode and
   before the steps and read after each: the vision blocks must run
   attention's long variants only (L > 128: the encode's 12 forward
   launches a batch; a training step's 24 forward launches, `remat` running
   each block's forward twice, and 12 backward launches, the text tower's
   the L <= 128 variants), k-medoids only its global variant
   (N > SHARED_MAX_N).  Then B and A at qkv [1536, 197, 2304] and
   [768, 161, 2304] (with their kernels' registers, shared memory per CTA
   and resident CTAs per SM), C and D at LayerNorm rows [302592, 768] and
   [123648, 768], and E on the tokens the first step and the encode
   clustered ([768, 392, 392] and [192, 392, 392], K = 160), each against
   its plain version as in the kernel phase.  (The kernel phase also holds
   E at N = 147, K = 49: the first training step's tokens as the 12 -> 4
   presets cluster them.)

7b. Long-segment phase, the fourteenth main path (run after the ViT-B/16
   phase, on the main phase's fixture): ViT-B/16 at full width with remat
   on segments of 4 frames (the JAX reference's ActivityNet and DiDeMo
   schedules, 12 -> 3 segments: N = 784 tokens a segment), through
   experiment 62's flags with `--pretrained_clip_name ViT-B/16 --remat 1
   --cluster_num_blocks 196 x 6 160 x 6 --target_frames_blocks 12 x 6
   3 x 6` (no preset: the JAX package has none for these schedules).
   (a) 2 compared steps (kernel E held against its plain version on each
   one's tokens) and 3 timed ones at batch 128, an encode of 64 clips
   through `RetrievalEngine.build_index`, and `main(argv)` on the fixture
   (3 steps of 128, then its evaluation of 48 clips); (b) the same flags
   into K = 392, 2 steps, so that blocks 7-12 attend over L = 393 and
   kernel B runs past 256 keys in a real step; (c) E's cluster variant
   (N > 512: a thread-block cluster a segment, its CTAs a segment printed)
   against its plain version at the step's [384, 784, 784],
   an encode batch's [96, 784, 784], the step's tokens as three-frame
   segments [512, 588, 588] and as whole clips [8, 2352, 2352], and on
   spectral embeddings of 2 clips at N = 784 (tokens scaled 2 sigma
   apart), each with 0 segments of other ids or steps than the plain
   version's fixed point; A and B on (b)'s recorded qkv [384, 393, 2304]
   with a seeded output gradient, beside SDPA.  Counts are zeroed before
   each run and read after it: E must run its cluster variant only, the
   vision blocks attention's long variants only, and A and B must launch
   at L > 256 (counted by length around the wrappers' calls); the
   `{"long_segments": ...}` line holds (a)'s and (b)'s numbers beside the
   ViT-B/16 phase's, and the kernels line rows `kmedoids_cluster` (its
   launches on this path and the sixteenth), `attention_fwd_long_past_256`
   and `attention_bwd_long_past_256`.

7c. fp32 ViT-B/16 phase, the fifteenth main path (after 7b, on main's
   fixture): the preset `msrvtt_vitb16_k6` with `--precision fp32` and
   remat (the towers in float32: kernels A and B on their fp32 variants,
   the vision blocks' L = 197 and 161 on the tensor-core one, tf32x3:
   three TF32 passes a product; the 32-token text tower's on the one
   FP32_SHORT_RANGES give it).  FP32_WARMUP_STEPS + FP32_TIMED_STEPS
   training steps at batch 128 (peak memory), an encode of 64 clips and a
   search, card against CPU in fp32 with the card's medoid ids replayed (a
   2-clip embedding by cosine, one step on 2 clips by loss and gradient
   cosines: FP32_VIDEO_MIN_COS, FP32_LOSS_RTOL, FP32_GRAD_MIN_COS),
   `main(argv)` with experiment 62's flags at ViT-B/16, remat and
   `--precision fp32` (3 steps, then its evaluation); A and B against their
   plain versions on the first input of each shape the steps gave them
   (recorded at the model's call site), at FP32_ATTENTION_CASES beside
   SDPA in fp32 (1e-5 forward, FP32_BWD_ATOL backward) with two bounds
   (the fp32 operations over the CUDA cores' peak, and the split's: three
   TF32 passes over the TF32 peak, or the bytes), and both fp32 variants'
   times at FP32_THRESHOLD_CASES (where FP32_SHORT_RANGES come from).
   Counts are zeroed before each run and read after it: attention must
   run its fp32 variants only (24 tf32x3 forward and 12 tf32x3 backward
   launches a step), E its global one; the kernels line rows
   `attention_fwd_fp32_tf32x3`, `attention_bwd_fp32_tf32x3` and, where a
   path ran it, `attention_fwd_fp32` and `attention_bwd_fp32`.
7d. 20-frame segments phase, the sixteenth main path: ViT-B/16 with remat
   on 60 frames (`--max_frames 60`, ActivityNet's) grouped into 3 segments
   before block 7 (N = 3920 tokens a segment, K = 160), bf16, through
   experiment 62's flags: an encode of 32 clips (96 segments, D 5.9 GB)
   and a warm-up and a timed step at batch 16; E held against its plain
   version on the step's and the encode's tokens (every segment the plain
   version's ids and steps), then at K = 392, as 12-frame segments at
   K = N = 2352 ([8, 2352, 2352]) and on a segment cut to N = 3137, and
   the scratch variant, which no path runs any more, on the step's
   tokens.  E must run its cluster variant only; the kernels line rows
   `kmedoids_cluster` and `kmedoids_scratch`.

8. Serve phase, the fifth main path (run between the main and the ViT-B/16
   phases, on the main phase's fixture and run-1 checkpoint):
   `python -m centerclip_tpu_torch.serve.cli`'s `main(argv)` with
   experiment 62's flags, `--init_model <ckpt.pth.tar>` and the .fstore.
   `build --quantize float32` through the registry's pinned test loader
   (every gallery batch must arrive pinned), then `query` of the 48
   evaluation captions from a `--queries_file` (top 48), each score held to
   the Evaluator's similarity matrix within SERVE_SCORE_ATOL and no pair
   ranked against it by more than that (the check must see pairs more
   than the tolerance apart, and must fail each ranking held to the next
   query's row); `build --quantize int8`, `serve --port 0` on a thread
   (warm-up of the 8 query buckets up to the 128 queries a request may
   hold), `GET /healthz` and `POST /search` of the 4 queries, which must
   equal `engine.search` on the same index (first request after warm-up
   and the steady latency printed); `build --index_type ivf --n_clusters 8
   --nprobe 8`, whose ids must equal flat's outside ties.  Counts are
   zeroed before the first build and read after the IVF build: A, C and E
   must have launched, A only its tensor-core variant; the first input of
   each shape they took in between is recorded at the model's call sites
   and each kernel is held against its plain version on it.  The first
   and the steady search at 5 and 33 queries, sizes no call ran before,
   are printed, unpadded and padded to the warmed buckets.  Then IVF at deployment size: 1M x 512
   int8 rows drawn on the card (benchmarks/ivf_bench.py's clusterable
   recipe), 1024 cells, 5 Lloyd steps: build time, recall@10 against flat
   at nprobe 8 / 32 / 64, ids equal to flat's at nprobe 1024, device time
   per search (CUDA events) of flat and IVF at batches of 1 and 32, and a
   live `add` of 100 rows (no re-group; each its own top 1).  Last the
   encode rate of the 48 clips from pinned and from pageable memory (the
   same embeddings to the bit).

9. Cluster phase, the sixth main path (after the ViT-B/16 phase): the
   preset `lsmdc_vitb32_spectral6` (spectral clustering on a KNN graph,
   12 -> 6 frames before block 7, K = 49), its random vision weights'
   residual stream scaled so that the tokens it clusters lie a median
   2 sigma apart (at the seed's scale the heat kernel underflows off the
   diagonal: W = I, L_sym = 0; the phase fails on such tokens), encodes 64
   clips through `RetrievalEngine` and trains 2 + 3 steps at batch 128
   with the `eigh` solver (kernels A-F must launch), then 1 + 3 with
   the `subspace` solver; the spectral clustering and its eigensolve are
   timed by CUDA events inside the same calls, in those steps and alone at
   L_sym [768, 98, 98] (a training step's) and [192, 98, 98] (an encode
   batch's); kernel E is held against its plain version on the spectral
   embeddings recorded at its call site; card against CPU: L_sym's
   eigenvalues (within EIGVAL_ATOL) and a 2-clip embedding with the card's
   medoid ids replayed.  Then `pooling`, `sparse_sampling`, `temporal_shift`,
   `token_shift` (experiment 62's flags with `--cluster_algo <algo>`) and
   `deep_cluster` (`--deep_cluster 1 --cluster_inter 0`): 1 + 2 steps at
   batch 128 each (A-D must launch, k-medoids must not; finite losses, a
   positive cluster loss for deep_cluster only), and a 2-clip encode held
   to the CPU's.
10. Activity phase, the seventh: the preset `activity_vitb32` at the
   recipe's size (60 frames, 77 words, batch 128, 60 -> 15 frames, k-medoids
   of 196 tokens into 49, `remat` on: ACTIVITY_REMAT_WHY): 2 + 3 training
   steps (k-medoids on its shared-memory variant only), an encode of 64
   clips in batches of 32 that `pre_visual_pooling` pools to unit [64, 512]
   vectors in `CLIP4Clip.forward`, then A and B at qkv [7680, 50, 2304] and
   [128, 77, 1536] causal, C and D at [384000, 768] and E on the tokens the
   first step and the encode clustered ([1920, 196, 196] and
   [480, 196, 196]) against their plain versions.
11. Headers phase, the eighth: experiment 62's flags with `--sim_header
   seqTransf` (2 + 3 training steps at batch 128, a checkpoint-and-resume
   step equal to the uninterrupted one, an encode of 64 clips through
   `RetrievalEngine` and a search) and with `--sim_header tightTransf`
   (loose_type off: 2 + 3 steps, 128 x 128 pairs of 7 tokens through the
   4-layer fp32 cross model, peak memory, `Evaluator.evaluate` on 64
   clips), then the tightTransf logits of 1000 x 1000 seeded cached
   features in chunks of 64 texts, timed, with a block of 64 rows across a
   chunk boundary and the ragged tail held to the unchunked block.  The
   header blocks' attention is the plain fp32 path (a per-sample mask that
   kernel A does not take); their LayerNorms run C and D in fp32, held
   against the plain version at [768, 512] and [114688, 512].
12. Towers phase, the ninth: `--linear_patch 3d` (2 + 3 steps at batch
   128; the patchify alone by CUDA events, beside `F.conv3d` on the same
   inputs; a 2-clip encode card vs CPU) and
   `--pretrained_clip_name RN50` with clustering off (an encode of 64
   clips and a search; a 2-clip encode card vs CPU), after checking that
   the model builder turned cuDNN's TF32 off.
13. Preprocess phase, the tenth: `preprocess.build_framestore` over the
   main phase's .npy videos must write its .fstore byte for byte;
   `preprocess.visualize_clusters --mode mask` and `--mode overlay` on a
   seeded 12-frame .npy video on the card: kernel E must launch, and its
   medoid ids must equal the plain version's on the same pixel tokens
   ([6, 98, 3072], K = 49); E held and timed there.

14. Parallel phase, the eleventh (after the towers phase, on the main
   phase's fixture and init: experiment 62 at a global batch of 128):
   `python -m torch.distributed.run` starts this script as ranks
   (`--parallel-leg`).  Leg (a), one NCCL rank: PARALLEL_STEPS steps
   unwrapped (before the process group exists), then under DDP
   (`--data_parallel 1`) and FSDP (`--fsdp 1`) from the same init on the
   same batches; losses, step-1 gradients and parameters must equal the
   unwrapped ones to the bit, kernels A-F must launch (counts zeroed
   before, read after each) and kernel D only on the default stream with
   its tickets zero after; then PARALLEL_TIMED timed steps each (median
   and peak memory); then `main` with `--data_parallel 1 --fsdp 1` (rank
   0 evaluates the gathered parameters and writes) and the eval-only
   reload of its export in one process, equal to the bit.  Leg (b),
   GLOO_RANKS ranks sharing the card over gloo at 64 clips each: which
   collectives gloo takes on CUDA tensors, then the first step under DDP
   (and FSDP where gloo takes its collectives) held to leg (a)'s
   unwrapped step at batch 128 (loss within PARALLEL_LOSS_RTOL, every
   gradient by cosine >= PARALLEL_GRAD_MIN_COS).  A failed rank fails the
   script; nothing falls back.  `python3 chip_smoke.py --gpus N` runs
   only leg (c) on a machine with N cards: one NCCL rank a card, each
   first taking the one-process step at batch 128 on its card, then DDP
   and FSDP at 128 / N rows a rank held to it as leg (b) is, with their
   step times beside the one-card step's, then the tensor-parallel meshes
   of TP_MULTI_MESHES ((2, 2) + SP, (2, 2) + SP + FSDP, (1, 4) + SP: 50
   vision tokens over 4 ranks, 3 vision and 2 text heads a rank) held to
   it as leg (b') is, with step time and peak memory beside DDP's, then
   `main --fsdp 1` over the N ranks, and last `main --tensor_parallel 2
   --sequence_parallel 1` over them (rank 0 evaluates and writes; its
   export must load with `strict=True` into a model of one process).
15. Still in the parallel phase, the twelfth main path: leg (b'),
   TP_GLOO_RANKS gloo ranks sharing the card as a (data 1, model 2) mesh
   at TP_GLOO_BATCH clips: each rank takes the one-process step on the
   same batch first, then the first step under tensor parallelism and
   under tensor and sequence parallelism (kernels A and B on each rank's
   6 vision and 4 text heads, C and D on its rows, E replicated), held to
   it by TP_LOSS_RTOL and TP_GRAD_MIN_COS after gathering (the
   one-process step's medoid ids replayed); every kernel's
   count must have moved on each rank (zeroed before, read after each
   run), and the two ranks' cluster-layer inputs and medoid ids must be
   equal to the bit.  Then A and B at the local shapes of leg (c)'s
   meshes (TP_ATTENTION_CASES) and C and D at their SP-local rows
   (TP_LAYERNORM_CASES) against their plain versions, timed beside SDPA
   and ATen.
16. Still in the parallel phase, the thirteenth main path: leg (b''),
   PP_GLOO_RANKS gloo ranks sharing the card as a (data 1, pipe 2) mesh at
   TP_GLOO_BATCH clips: each rank takes the one-process step first, then
   the first step under pipeline parallelism (the text tower's 12 blocks
   and each 6-block vision run as 2 GPipe stages of 8 microbatches; the
   patchify, the cluster layer with kernel E, ln_post and the loss
   replicated on both stages), held to it as leg (b') is (the one-process
   medoid ids replayed, the flipped segments counted) on every rank, each
   gradient's length too (TP_GRAD_NORM_RTOL); every kernel's count must
   have moved on each rank, the stages' cluster inputs and medoid ids and
   the parameters after the step must be equal to the bit on the ranks,
   and on each rank A, C and E are held against their plain versions on
   the first input of each shape the step gave them
   (`recording_kernel_inputs`), B and D on the same inputs with a seeded
   output gradient.  Then A and B at the microbatch
   shapes of leg (c)'s pipe meshes (PP_ATTENTION_CASES) and C and D at
   their rows (PP_LAYERNORM_CASES), timed beside SDPA and ATen.  With
   `--gpus N`, leg (c) also runs PP_MULTI_MESHES ((2, 2), (1, 4) with
   its 2-block remainder, (2, 2) + FSDP) held to the one-process step,
   with step time and peak memory beside DDP's; `main --pipeline_parallel
   2` over the N ranks (its export loaded strict) and the evaluation of
   its export on GALLERY_ROWS rows by rank 0 alone against the same
   spread over the N ranks (metrics equal, seconds of each); and, in this
   process, the serve CLI's `build --data_parallel N` against `build` on
   one card (codes, scores and ranked ids, clips/s of each, the loading
   and the cards' encode apart) and its refusal of the IVF index.

Prints a `{"training": ...}`, a `{"main": ...}`, a `{"vitb16": ...}`, a
`{"long_segments": ...}`, an `{"fp32_vitb16": ...}`, a `{"seg20": ...}`, a
`{"serve": ...}`, a `{"cluster": ...}`, an `{"activity": ...}`, a
`{"headers": ...}`, a `{"towers": ...}`, a `{"preprocess": ...}`, a
`{"parallel": ...}` and a `{"kernels": [...]}` JSON line (attention's long
forward and backward, the global, large and scratch k-medoids variants,
the long forward and backward past L = 256 and attention's fp32 variants
as rows of their own; every
kernel's rows at each path's shapes, its launches by path; last QuickGELU's
kernel F, held to the eager composition to the bit and timed both ways
at QUICK_GELU_SHAPES and QUICK_GELU_OTHER_DTYPES beside its byte bound
and the eager ops, with its launches on the serving and training paths) and, last,
one JSON line {"ok":
true, "device": {...}}; before them, each phase's time.  Any failed check
exits non-zero before it.  Without a CUDA device it exits non-zero at
once.  Timing and bounds come from `centerclip_tpu_torch/kernel_timing.py`.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import subprocess
import sys
import time

from centerclip_tpu_torch.kernel_timing import (
    LAYERNORM_FWD_SHAPES, QUICK_GELU_SHAPES, SLEEP_CYCLES, bound, card_peaks,
    host_us_per_call, kmedoids_bound, kmedoids_sector_bound, layernorm_bound,
    layernorm_times, quick_gelu_times, tf32_peak, time_ms)

# tolerances, stated before any run:
# bf16 kernel vs plain version: both round fp32 values to bf16, summed in
# another order (mma's, not the plain version's matmul), so they differ by
# at most about one bf16 ulp (2^-7 relative at 1)
BF16_ATOL, BF16_RTOL = 1.6e-2, 1.6e-2
FP32_ATOL, FP32_RTOL = 1e-5, 1e-5
# k-medoids: ids equal, or, where a fp32 summation-order tie picked another
# medoid, the two answers' total within-cluster distance equal to 1e-6
KMEDOIDS_COST_RTOL = 1e-6
KMEDOIDS_MIN_SAME = 0.95
# card (CUDA kernels, cuBLAS) vs CPU (plain versions, oneDNN) in bf16:
# text features carry only rounding-order noise; video features may also
# move a few k-medoids choices
TEXT_MIN_COS, VIDEO_MIN_COS = 0.999, 0.99
# fp32 outputs of the backward kernels that are sums (dgamma, dbeta over
# rows) in another order than the plain version's: within 1e-5 of the sum
# of the terms' magnitudes (the worst case of ~150 sequential fp32 adds)
SUM_RTOL = 1e-5
# one training step on 2 clips, card (kernels, cuBLAS) vs CPU (plain
# versions) in bf16: the loss to relative 1e-2, and the flattened gradient
# of every trainable parameter with >= 1000 elements by cosine
TRAIN_LOSS_RTOL, TRAIN_GRAD_MIN_COS, TRAIN_GRAD_MIN_NUMEL = 1e-2, 0.99, 1000

N_CLIPS, BATCH, FRAMES, RES = 64, 32, 12, 224
SEARCH_REPEATS = 20
TRAIN_PRESET, TRAIN_WARMUP_STEPS, TRAIN_TIMED_STEPS = "msrvtt_vitb32_k6", 2, 5
N_EVAL_CLIPS = 64
# the main phase's synthetic MSR-VTT (preprocess/compress_video.py: 3 fps,
# short side 224) and scripts/msrvtt.sh's `common` + experiment 62 flags
MAIN_VIDEOS, MAIN_FRAMES, MAIN_HW, MAIN_CAPTIONS = 48, 36, (224, 298), 8
MAIN_BATCH = 128              # 48 x 8 pairs: 3 steps, then 48 clips of eval
# `--gpus N`'s evaluation gallery: the rows of MSR-VTT's 1k-A test split
GALLERY_ROWS = 1000
EXP62_FLAGS = [
    "--do_train", "1", "--do_eval", "1", "--datatype", "msrvtt",
    "--max_words", "32", "--max_frames", "12", "--feature_framerate", "3",
    "--batch_size", str(MAIN_BATCH), "--batch_size_val", str(MAIN_BATCH),
    "--epochs", "5",
    "--optim", "AdamW", "--lr", "2e-3", "--coef_lr", "1e-3", "--wd", "0.2",
    "--warmup_proportion", "0.1", "--loose_type", "--sim_header", "meanP",
    "--slice_framepos", "2", "--expand_msrvtt_sentences",
    "--precision", "amp", "--pretrained_clip_name", "ViT-B/32",
    "--num_thread_reader", "8", "--cluster_inter", "1",
    "--cluster_algo", "kmediods++", "--cluster_num_blocks", *["49"] * 12,
    "--target_frames_blocks", *["12"] * 6, *["6"] * 6]
# the eleventh main path: data parallelism and FSDP under
# `python -m torch.distributed.run`, on the main phase's fixture and init
# (experiment 62 at a global batch of 128).  One NCCL rank: PARALLEL_STEPS
# compared steps (equal to the unwrapped steps to the bit), then
# PARALLEL_TIMED timed ones, per wrapper.  GLOO_RANKS ranks on the one card
# over gloo (NCCL will not put two ranks on one GPU): the first step's loss
# within PARALLEL_LOSS_RTOL of the one-process step's at batch 128 and
# every gradient within cosine PARALLEL_GRAD_MIN_COS of it.  Tightened
# from the card-vs-CPU budget (1e-3, 0.99) to what the card allows: the
# gathered global batch gives the one-process loss to the bit, and the
# towers at 64 (or 32) rows a rank, where cuBLAS picks other bf16 kernels
# than at 128, leave each gradient's cosine above 0.99996.
PARALLEL_STEPS, PARALLEL_TIMED, GLOO_RANKS = 2, 5, 2
PARALLEL_LOSS_RTOL, PARALLEL_GRAD_MIN_COS = 1e-5, 0.9999
PARALLEL_TIMEOUT = 600
# the twelfth main path: tensor and sequence parallelism on the same fixture
# and init.  Leg (b'): TP_GLOO_RANKS gloo ranks share the card as a
# (data 1, model TP_GLOO_RANKS) mesh at a global batch of TP_GLOO_BATCH, cut
# from the recipe's 128 because gloo stages every one of a step's ~100
# activation all-reduces (or reduce-scatters and all-gathers) through host
# memory.  A TP step is held to the one-process step at the same batch by
# TP_LOSS_RTOL and TP_GRAD_MIN_COS, looser than the data legs' (whose
# ranks compute each row as one process does): each rank's bf16 partial
# products of a row-parallel layer, and its bf16 partial input gradients of
# a column-parallel one, are rounded before the model group sums them, one
# more rounding per block and direction than one process makes.  The
# card-vs-CPU budget is (1e-3, 0.99); these keep its loss bound and hold
# the gradients ten times closer.  That rounding moves some of k-medoids'
# 49 picks in most segments against the one-process step's, and a moved
# medoid hands blocks 7-12 other tokens: the TP runs replay the
# one-process step's medoid ids (`recording_cluster`), as the CPU tests
# replay ids where ties flip, and count the segments and the ids whose own
# picks differed.  Leg (c) holds its TP meshes the same way.
TP_GLOO_RANKS, TP_GLOO_BATCH = 2, 32
TP_LOSS_RTOL, TP_GRAD_MIN_COS = 1e-3, 0.999
# a cosine does not see a gradient scaled by a wrong factor (the group
# size, say): each gradient's length is held to the one-process length
# within the error that the cosine bound allows across it, sqrt(2 (1 -
# cos)) of the length (0.045)
TP_GRAD_NORM_RTOL = (2 * (1 - TP_GRAD_MIN_COS)) ** 0.5
# leg (c)'s meshes on four cards: (label, flags), each at the global 128
TP_MULTI_MESHES = (
    ("tp2_sp", ["--tensor_parallel", "2", "--sequence_parallel", "1"]),
    ("tp2_sp_fsdp", ["--tensor_parallel", "2", "--sequence_parallel", "1",
                     "--fsdp", "1"]),
    ("tp4_sp", ["--tensor_parallel", "4", "--sequence_parallel", "1"]))
# the thirteenth main path: pipeline parallelism (GPipe) on the same
# fixture and init.  Leg (b''): PP_GLOO_RANKS gloo ranks share the card as
# a (data 1, pipe PP_GLOO_RANKS) mesh at TP_GLOO_BATCH clips (gloo stages
# each tick's hop and the segments' broadcasts through host memory).  A PP
# step computes each row as one process does, but its matmuls run at a
# microbatch's rows (cuBLAS picks other bf16 kernels there, as at a DP
# rank's) and each block's weight gradient is rounded to bf16 per
# microbatch before the fp32 sum over them: one more rounding per
# microbatch, as TP's partial sums add one per rank.  So a PP step is held
# as a TP step is (TP_LOSS_RTOL, TP_GRAD_MIN_COS), with the one-process
# medoid ids replayed: where no pick flipped, the replay changes nothing,
# and the flipped segments are counted either way.
PP_GLOO_RANKS = 2
ALL_KERNELS = ("attention_fwd", "attention_bwd", "layernorm_fwd",
               "layernorm_bwd", "kmedoids")
# leg (c)'s pipe meshes on four cards: (label, flags), each at the global
# 128; (1, 4) splits each 6-block vision run 1 + 1 + 1 + 1 and runs the
# remaining 2 blocks after the pipeline, and the text tower's 12 blocks
# 3 a stage
PP_MULTI_MESHES = (
    ("pp2", ["--pipeline_parallel", "2"]),
    ("pp4", ["--pipeline_parallel", "4"]),
    ("pp2_fsdp", ["--pipeline_parallel", "2", "--fsdp", "1"]))
# kernels A-D at the microbatch shapes of the pipe meshes at the global 128
# (M = 4 S: (2, 2) and (1, 4) both give 96 frames a microbatch before the
# cluster layer, 48 after it, 8 texts) and of leg (b'') (32 clips, M = 8:
# 48 frames, 24, 4 texts)
PP_ATTENTION_CASES = (("pp, vision blocks 1-6", 96, 50, 12, None),
                      ("pp, vision blocks 7-12", 48, 50, 12, None),
                      ("pp, text", 8, 32, 8, "causal"),
                      ("pp gloo, vision blocks 7-12", 24, 50, 12, None),
                      ("pp gloo, text", 4, 32, 8, "causal"))
PP_LAYERNORM_CASES = (("pp, vision ln_1/ln_2 blocks 1-6", 96 * 50, 768),
                      ("pp, vision ln_1/ln_2 blocks 7-12", 48 * 50, 768),
                      ("pp, text ln_1/ln_2", 8 * 32, 512),
                      ("pp gloo, vision ln_1/ln_2 7-12", 24 * 50, 768),
                      ("pp gloo, text ln_1/ln_2", 4 * 32, 512))
# the serve CLI's `build --data_parallel N` on main's fixture: one gallery
# batch of all 48 clips, split 48 / N a card
SERVE_MULTI_BATCH = MAIN_VIDEOS
# the fourth main path: ViT-B/16 at the recipe's batch of 128; the step
# count is what is cut to keep the script inside its time limit
VITB16_PRESET, VITB16_WARMUP_STEPS, VITB16_TIMED_STEPS = \
    "msrvtt_vitb16_k6", 2, 3
VITB16_REMAT = True
VITB16_REMAT_WHY = ("without it the step at batch 128 does not fit in the "
                    "card's 80 GB: python -m centerclip_tpu_torch.profile_train "
                    "--preset msrvtt_vitb16_k6 --remat 0")
# the fourteenth main path: ViT-B/16 on segments of 4 frames (the JAX
# reference's schedules for ActivityNet and DiDeMo, 12 -> 3 segments: N =
# 4 x 196 = 784 tokens a segment) into K = 160 (scripts/msrvtt.sh's ViT-B/16
# K), on main's fixture through experiment 62's flags, with remat as
# msrvtt_vitb16_k6 takes it; leg (b) the same into K = 392, so that blocks
# 7-12 attend over L = 393 > 256 tokens
LONG_SEG_FRAMES, LONG_SEG_K, LONG_SEG_WIDE_K = 4, 160, 392
LONG_SEG_WARMUP_STEPS, LONG_SEG_TIMED_STEPS, LONG_SEG_WIDE_STEPS = 2, 3, 2
# the fifteenth main path: msrvtt_vitb16_k6 with --precision fp32 and
# remat (the towers in fp32: kernels A and B on their fp32 variants, the
# vision blocks, L = 197 and 161, on the long one); a warm-up step
# and FP32_TIMED_STEPS timed ones at the preset's batch of 128 (an fp32
# step takes seconds: the steps are what is cut)
FP32_WARMUP_STEPS, FP32_TIMED_STEPS = 1, 2
# card against CPU, both fp32, the card's medoid ids replayed on the CPU:
# only the order of fp32 sums differs (cuBLAS and the kernels against
# oneDNN and the plain versions, ~1e-6 relative a product), so the 2-clip
# embedding is held by cosine 0.999 and one training step's loss to
# relative 1e-4 and every large gradient by cosine 0.9999
FP32_VIDEO_MIN_COS, FP32_LOSS_RTOL, FP32_GRAD_MIN_COS = 0.999, 1e-4, 0.9999
# kernel B's fp32 outputs: sums of L products in another order than the
# plain version's (tests/test_torch_gpu.py's fp32 backward tolerance)
FP32_BWD_ATOL, FP32_BWD_RTOL = 1e-4, 1e-4
# kernels A and B's fp32 rows beside SDPA in fp32: ViT-B/16's two vision
# shapes and K = 392's L = 393 (the long variant), ViT-B/32's vision, the
# fifteenth path's own 32-word text tower and ActivityNet's 77-word one
# (label, B, L, H, causal); each variant's row in the kernels line takes
# its first case's times
FP32_ATTENTION_CASES = (
    ("ViT-B/16 blocks 1-6", 1536, 197, 12, False),
    ("ViT-B/16 blocks 7-12", 768, 161, 12, False),
    ("K = 392, blocks 7-12", 384, 393, 12, False),
    ("ViT-B/32 vision", 1536, 50, 12, False),
    ("32-word text (the path's)", 128, 32, 8, True),
    ("77-word text", 128, 77, 8, True))
# both fp32 variants at the lengths where both run, at ViT-B/32's vision
# batch of 1536 x 12 heads and the text tower's 128 x 8 (causal): the
# times FP32_SHORT_RANGES are set from
FP32_THRESHOLD_CASES = tuple(
    [(1536, L, 12, False) for L in (32, 40, 44, 48, 50, 56, 64, 68, 72, 77,
                                    80, 88, 96, 108, 128, 163)]
    + [(128, L, 8, True) for L in (32, 77)])
# the sixteenth main path: ViT-B/16 on segments of 20 frames (60 frames,
# ActivityNet's --max_frames, grouped into 3 segments before block 7: N =
# 20 x 196 = 3920 tokens a segment, past the large k-medoids variant's
# shared memory) into K = 160, bf16, remat; a 32-clip encode (96 segments)
# and a warm-up and a timed training step at batch 16 (the steps and the
# batch are what is cut: the widths are ViT-B/16's)
SEG20_FRAMES, SEG20_SEGMENTS, SEG20_K = 60, 3, 160
SEG20_ENCODE_CLIPS, SEG20_BATCH = 32, 16
SEG20_WARMUP_STEPS, SEG20_STEPS = 1, 1
# the sixth main path: the spectral preset, then the other algorithms at
# experiment 62's block flags; a 2-clip encode of each against the CPU
CLUSTER_PRESET, CLUSTER_WARMUP_STEPS, CLUSTER_TIMED_STEPS = \
    "lsmdc_vitb32_spectral6", 2, 3
BASELINE_ALGOS = ("pooling", "sparse_sampling", "temporal_shift",
                  "token_shift", "deep_cluster")
BASELINE_WARMUP_STEPS, BASELINE_TIMED_STEPS = 1, 2
# the spectral preset's random vision weights put the tokens block 7 clusters
# so far apart that the heat kernel underflows off the diagonal (W = I,
# L_sym = 0): the stream is scaled so that their median distance is this
# many sigma (exp(-2) between tokens that far apart)
SPECTRAL_MEDIAN_SIGMAS = 2.0
# L_sym's eigenvalues, card (cuSOLVER, cuBLAS affinity) against CPU
# (LAPACK, oneDNN) from the same fp32 tokens: the affinity rounds
# otherwise by ~1e-7 relative, the eigenvalues lie in [0, 2]
EIGVAL_ATOL = 1e-4
# the seventh main path: ActivityNet at the recipe's size
ACTIVITY_PRESET, ACTIVITY_WARMUP_STEPS, ACTIVITY_TIMED_STEPS = \
    "activity_vitb32", 2, 3
ACTIVITY_REMAT = True
ACTIVITY_REMAT_WHY = ("without it the step at batch 128 runs out of the "
                      "card's 80 GB (76.464 GiB allocated): python -m "
                      "centerclip_tpu_torch.profile_train --preset "
                      "activity_vitb32 --remat 0")
# the headers phase: experiment 62 with seqTransf / tightTransf, and the
# tightTransf logits of MSR-VTT's 1k-A test size from cached features; a
# chunk's rows held to the unchunked rows (fp32, other matmul batch sizes)
HEADERS_WARMUP_STEPS, HEADERS_TIMED_STEPS = 2, 3
CROSS_GALLERY, CROSS_CHUNK, CROSS_BLOCK_ATOL = 1000, 64, 1e-4
# the towers phase: experiment 62 with the 3-D patchify, and RN50
TOWERS_WARMUP_STEPS, TOWERS_TIMED_STEPS = 2, 3
# the preprocess phase: visualize_clusters at its defaults (12 frames, 6
# segments, K = 49)
VIS_FRAMES, VIS_K = 12, 49
# the serve phase: serve/cli.py on the main phase's fixture and checkpoint.
# Scores are logits (cosine x exp(logit_scale), ~14.3 here).  Against the
# Evaluator's fp32 similarity the engine rounds both score operands to bf16
# (at most 2^-8 in cosine for unit vectors) and runs the towers at other
# batch shapes (48 clips padded to 64, the texts in other batches), where
# cuBLAS may round a bf16 activation otherwise (~3e-3 in cosine):
# 14.3 x 7e-3
SERVE_SCORE_ATOL = 0.1
# IVF at full probe against flat: the same codes and exact bf16 products,
# fp32 sums in another order: within 1e-5 of the largest score
IVF_SCORE_RTOL = 1e-5
# the IVF cell at deployment size (benchmarks/ivf_bench.py:51-53, 66-85:
# 1M x 512 int8, 1024 cells, 5 Lloyd steps, 32 clusterable queries)
IVF_N, IVF_D, IVF_CELLS, IVF_ITERS = 1_000_000, 512, 1024, 5
IVF_QUERIES = 32
IVF_NPROBES, IVF_K, IVF_ADD = (8, 32, 64), 10, 100
HTTP_REPEATS, ENCODE_REPEATS = 20, 3
# query batch sizes the serve phase runs last, first unpadded, then padded
UNWARMED_QUERIES = (5, 33)
QUERIES = ["a man is cooking pasta in a kitchen",
           "two dogs are playing in the snow",
           "a woman sings on a stage while people dance",
           "a car drives along a mountain road at night"]


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


# the CUDA runtime's cudaGraphNodeType values of the work a call may enqueue
GRAPH_NODE_TYPES = {0: "kernel", 1: "memcpy", 2: "memset", 3: "host",
                    4: "child graph", 5: "empty", 6: "event wait",
                    7: "event record", 10: "mem alloc", 11: "mem free"}


def device_launches(torch, fn):
    """The device work one call of `fn` enqueues, by node type: the call is
    captured into a CUDA graph (nothing runs; `fn` must have run before at
    the same shapes, so nothing compiles or grows a cache inside the
    capture) and the graph's nodes are read through the CUDA runtime.
    (torch.profiler, opened once per call late in a long process, was seen
    to get no device activity from CUPTI at all.)"""
    import ctypes
    rt = ctypes.CDLL(f"libcudart.so.{torch.version.cuda.split('.')[0]}")
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    raw = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    err = rt.cudaGraphGetNodes(raw, None, ctypes.byref(n))
    nodes = (ctypes.c_void_p * n.value)()
    err = err or rt.cudaGraphGetNodes(raw, nodes, ctypes.byref(n))
    kinds = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        err = err or rt.cudaGraphNodeGetType(ctypes.c_void_p(node),
                                             ctypes.byref(kind))
        kinds.append(GRAPH_NODE_TYPES.get(kind.value, str(kind.value)))
    del graph
    if err:
        fail(f"reading the captured graph's nodes: CUDA error {err}")
    if not kinds:
        fail("the captured call enqueued no device work")
    return kinds


def zero_counts(counters):
    """Zero every kernel's launch count, and attention's and k-medoids' by
    variant."""
    from centerclip_tpu_torch.ops import attention_cuda, kmedoids_cuda
    for fn in counters:
        fn.launches = 0
    attention_cuda.reset_counts()
    kmedoids_cuda.reset_counts()


def attention_variant_counts(path, backward):
    """The attention wrappers' launches by variant since the counts were
    zeroed on a ViT-B/32 path (L <= 128); fails unless the tensor-core
    variants ran (the backward only on the training path) and neither the
    CUDA-core (fp32) nor the long (L > 128) variants did."""
    from centerclip_tpu_torch.ops import attention_cuda as ac
    counts = {fn.__name__: dict(fn.variant_launches)
              for fn in (ac.fused_attention, ac.attention_backward)}
    print(f"attention launches by variant during the {path} path: {counts}")
    for name, by in counts.items():
        if by[ac.CUDA_CORE] or by[ac.TF32X3] or \
                by[ac.TENSOR_CORE_LONG]:
            fail(f"{name} launched its CUDA-core or long variant on the "
                 f"{path} path: {by}")
        if (backward or name == "fused_attention") and not by[ac.TENSOR_CORE]:
            fail(f"{name} never launched its tensor-core variant on the "
                 f"{path} path")
    return counts


def build_model(cfg, device, seed=0):
    from centerclip_tpu_torch.models.clip4clip import CLIP4Clip
    return CLIP4Clip(cfg, device=device, seed=seed).eval()


def token_rows(np, g, n, length, vocab=49408):
    """Seeded token rows shaped like the tokenizer's: SOT, BPE ids, EOT (the
    largest id), zero padding; and their attention mask."""
    ids = np.zeros((n, length), np.int64)
    mask = np.zeros((n, length), np.int32)
    for i, end in enumerate(g.integers(5, length, n)):
        ids[i, 0], ids[i, end] = vocab - 2, vocab - 1
        ids[i, 1:end] = g.integers(1, vocab - 2, end - 1)
        mask[i, :end + 1] = 1
    return ids, mask


def training_phase(torch, np, dev, counters):
    """The second main path: preset training steps, checkpoint + resume,
    evaluation.  Returns what the kernel phase and the report need."""
    from centerclip_tpu_torch.config import preset
    from centerclip_tpu_torch.models.clip4clip import CLIP4Clip
    from centerclip_tpu_torch.train import Evaluator, Trainer
    run = preset(TRAIN_PRESET)
    B, cfg = run.batch_size, run.model
    total_steps = TRAIN_WARMUP_STEPS + TRAIN_TIMED_STEPS + 1
    t0 = time.time()
    model = CLIP4Clip(cfg, device=dev, seed=0)
    trainer = Trainer(run, model, total_steps=total_steps)
    batch = seeded_batch(np, np.random.default_rng(1), B, cfg.max_frames,
                         cfg.max_words)
    trainable = [(n, p) for n, p in model.named_parameters()
                 if p.requires_grad]
    print(f"training set-up ({TRAIN_PRESET}: batch {B}, {run.optim.optim} lr "
          f"{run.optim.lr} coef_lr {run.optim.coef_lr} wd "
          f"{run.optim.weight_decay}, freeze_layer_num "
          f"{run.freeze_layer_num}: {len(trainable)} trainable tensors, "
          f"{sum(p.numel() for _, p in trainable)} parameters) "
          f"{time.time() - t0:.2f} s")

    # the first step's gradients are checked between its backward and its
    # update: the optimizer would fill a missing gradient with zeros
    def checked_update():
        del trainer.optimizer.step
        bad = [n for n, p in trainable if p.grad is None
               or not bool(torch.isfinite(p.grad).all())
               or not bool(p.grad.abs().max() > 0)]
        if bad:
            fail(f"missing, zero or non-finite gradients in the first step: "
                 f"{bad[:5]} ({len(bad)} tensors)")
        trainer.optimizer.step()
    trainer.optimizer.step = checked_update

    # the first step's k-medoids input, for the kernel phase
    captured = {}
    hook = first_input_hook(cluster_module(model), captured)
    zero_counts(counters)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    med, step_ms, losses, _ = timed_steps(torch, np, trainer, batch,
                                          TRAIN_WARMUP_STEPS,
                                          TRAIN_TIMED_STEPS, TRAIN_PRESET)
    hook.remove()
    trainer.metric_writer = None
    if "step" in vars(trainer.optimizer):
        fail("the first training step did not reach the optimizer")
    launches = {fn.__name__: fn.launches for fn in counters}
    variants = attention_variant_counts("training", backward=True)
    peak = torch.cuda.max_memory_allocated()
    print(f"training: losses {[round(x, 6) for x in losses]}, step times "
          f"(host clock, ends in a sync, copies from host included) "
          f"{[round(x, 3) for x in step_ms]} ms; median of the "
          f"{TRAIN_TIMED_STEPS} timed {med:.3f} ms = "
          f"{B / med * 1e3:.2f} clips/s; peak memory allocated "
          f"{peak / 2**30:.3f} GiB; logit_scale "
          f"{float(model.clip.logit_scale.detach()):.6f}")
    print(f"launches during the training steps: {launches}")
    for fn_name, n in launches.items():
        if n == 0:
            fail(f"{fn_name} was never launched on the training path")
    check_quick_gelu_launches("the training path", launches,
                              TRAIN_WARMUP_STEPS + TRAIN_TIMED_STEPS,
                              2 if cfg.remat else 1)

    # checkpoint, resume into a fresh model and optimizer, one more step each
    resumed_step(torch, run, model, trainer, batch, total_steps, "training")

    # two-phase evaluation on 64 of the clips with their texts
    t0 = time.time()
    n = N_EVAL_CLIPS
    res = Evaluator(model).evaluate(
        {k: v[s:s + BATCH] for k, v in batch.items()}
        for s in range(0, n, BATCH))
    metrics = [res["t2v"][k] for k in ("R1", "R5", "R10", "MR", "MeanR")] \
        + [res["v2t"][k] for k in ("R1", "R5", "R10", "MR", "MeanR")]
    print(f"evaluation of {n} clips ({time.time() - t0:.2f} s): R@1 "
          f"{res['R1']:.4f}, t2v R@5 {res['t2v']['R5']:.4f} R@10 "
          f"{res['t2v']['R10']:.4f} MR {res['t2v']['MR']}, v2t R@1 "
          f"{res['v2t']['R1']:.4f} (random weights)")
    if res["sim_matrix"].shape != (n, n) or not np.isfinite(
            res["sim_matrix"]).all() or not np.isfinite(metrics).all():
        fail("evaluation gave a bad similarity matrix or metrics")
    result = dict(batch=B, step_ms=med, clips_per_s=B / med * 1e3,
                  step_ms_all=step_ms, losses=losses,
                  peak_memory_bytes=peak, R1=res["R1"], launches=launches,
                  variants=variants)
    return result, batch, captured["x"]


def training_cpu_check(torch, np, dev, batch):
    """One training step on the first 2 clips of the training batch, on the
    card and on the CPU, from the same seeded weights, both in bf16.

    k-medoids is a discrete choice: with K = 49 of N = 98 points many
    clusters have two members, and rounding decides which is the medoid, so
    a card and a CPU forward pick other tokens for blocks 7-12 and their
    gradients differ by a few percent whatever the dtype.  So the held CPU
    step takes the medoid ids the card chose (its own plain k-medoids still
    runs, and the segments where it chose otherwise are counted), and the
    check compares the differentiable path: kernels A-D and cuBLAS against
    the plain versions and oneDNN.  Printed beside it, not held: a CPU step
    with its own medoids against the card, and against a CPU step in fp32
    with its own medoids (no kernel in either: what rounding alone does
    through the k-medoids choices)."""
    import dataclasses
    from centerclip_tpu_torch.config import preset
    from centerclip_tpu_torch.models.clip4clip import CLIP4Clip
    from centerclip_tpu_torch.train import build_optimizer, make_train_step
    t0 = time.time()
    run = preset(TRAIN_PRESET)
    small = {k: v[:2] for k, v in batch.items()}
    card = CLIP4Clip(run.model, device=dev, seed=0)
    weights = {k: v.cpu().clone() for k, v in card.state_dict().items()}

    def cluster_modules(model):
        return [b.tokencluster_inter
                for b in model.clip.visual.transformer.resblocks
                if b.tokencluster_inter is not None]

    def one_step(model):
        opt = build_optimizer(run.optim, model, 10,
                              freeze_layer_num=run.freeze_layer_num)
        loss = float(make_train_step(model, opt)(small)["loss"])
        return loss, {n: p.grad.detach().double().cpu().flatten()
                      for n, p in model.named_parameters()
                      if p.requires_grad and p.numel() >= TRAIN_GRAD_MIN_NUMEL}

    chosen, differing = [], [0, 0]
    for mod in cluster_modules(card):
        def record(res_tmp, own=mod._cluster):
            out = own(res_tmp)
            chosen.append(tuple(t.cpu() for t in out))
            return out
        mod._cluster = record
    steps = {"card": one_step(card)}
    for label, dtype, replayed in (("cpu", "bfloat16", True),
                                   ("cpu_own", "bfloat16", False),
                                   ("cpu32_own", "float32", False)):
        cpu = CLIP4Clip(dataclasses.replace(run.model, compute_dtype=dtype),
                        device="cpu", seed=1)
        cpu.load_state_dict(weights, strict=True)
        if replayed:
            for i, mod in enumerate(cluster_modules(cpu)):
                def replay(res_tmp, own=mod._cluster, i=i):
                    mine = own(res_tmp)[1]
                    differing[0] += int((mine != chosen[i][1]).any(dim=1)
                                        .sum())
                    differing[1] += mine.shape[0]
                    return chosen[i]
                mod._cluster = replay
        steps[label] = one_step(cpu)

    def compare(a, b):
        """(relative loss gap, cosines lowest first; a NaN cosine, from a
        zero gradient, lowest of all)"""
        (la, ga), (lb, gb) = steps[a], steps[b]
        cos = {n: float((ga[n] @ gb[n]) / (ga[n].norm() * gb[n].norm()))
               for n in gb}
        return abs(la - lb) / abs(lb), sorted(
            cos.items(), key=lambda kv: (not math.isnan(kv[1]), kv[1]))
    rel, cos = compare("card", "cpu")
    rel_own, cos_own = compare("card", "cpu_own")
    rel_32, cos_32 = compare("cpu_own", "cpu32_own")
    l_card, l_cpu = steps["card"][0], steps["cpu"][0]
    print(f"training CPU check ({time.time() - t0:.1f} s): k-medoids segments "
          f"where the CPU's own choice differs from the card's: "
          f"{differing[0]}/{differing[1]}; with the card's medoids replayed: "
          f"loss card {l_card:.6f} cpu {l_cpu:.6f} (relative gap {rel:.3e}, "
          f"tol {TRAIN_LOSS_RTOL}), gradient cosine over {len(cos)} tensors "
          f">= {TRAIN_GRAD_MIN_NUMEL} elements: min {cos[0][1]:.6f} (min "
          f"{TRAIN_GRAD_MIN_COS}), lowest {cos[:3]}; not held: card vs CPU "
          f"bf16 with its own medoids: relative loss gap {rel_own:.3e}, min "
          f"cosine {cos_own[0][1]:.6f}, lowest {cos_own[:3]}; CPU bf16 vs "
          f"CPU fp32, each with its own medoids: relative loss gap "
          f"{rel_32:.3e}, min cosine {cos_32[0][1]:.6f}, lowest {cos_32[:3]}")
    if not rel <= TRAIN_LOSS_RTOL:
        fail("card and CPU training losses disagree")
    if not all(c >= TRAIN_GRAD_MIN_COS for _, c in cos):
        fail(f"card and CPU gradients disagree: {cos[:3]}")
    return dict(loss_card=l_card, loss_cpu=l_cpu, loss_rel_gap=rel,
                grad_min_cos=cos[0][1], grad_tensors=len(cos),
                kmedoids_segments_differing=differing[0],
                own_medoids_loss_rel_gap=rel_own,
                own_medoids_grad_min_cos=cos_own[0][1],
                cpu_bf16_vs_fp32_loss_rel_gap=rel_32,
                cpu_bf16_vs_fp32_grad_min_cos=cos_32[0][1])


def hold_close(torch, label, out, ref, atol, rtol):
    """Max |out - ref|; fails unless every element is within atol + rtol *
    |ref|."""
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs()
    if not bool((err <= atol + rtol * ref.float().abs()).all()):
        fail(f"{label} disagrees with its plain version")
    return err.max().item()


def hold_kmedoids(torch, label, points, K, iter_limit, id_sort=True,
                  distance="euclidean", norm_p=2.0, pre_norm=False,
                  variant=None, **_):
    """The k-medoids kernel against its plain version on [B, N, Dim]
    points (the keywords of `ops.kmedoids_cuda.kmedoids`; the plain
    version's `threshold` is not read by the kernel): ids equal on at least
    KMEDOIDS_MIN_SAME of the segments, where they differ a clustering no
    costlier than the plain one's (KMEDOIDS_COST_RTOL), and equal
    assignments where the ids agree.  The global, cluster and scratch
    variants (ViT-B/16's N = 392 and past) are held to the plain
    version in every segment: the same ids, and each segment's Lloyd steps
    those the plain steps take to its fixed point.  `variant` forces one
    (the router's by default).  Returns the row and (X, D, l2, steps,
    assign) for timing."""
    from centerclip_tpu_torch.ops import kmedoids_cuda
    from centerclip_tpu_torch.ops.kmedoids import (_assign_step, _update_step,
                                                   fixed_point_steps,
                                                   kmedoids_inputs,
                                                   kmedoids_on_distances)
    X, D, l2 = kmedoids_inputs(points, distance, norm_p, pre_norm)
    a1, m1, steps = kmedoids_cuda.kmedoids_from_distances(
        D, l2, K, iter_limit, id_sort, variant=variant)
    a2, m2 = kmedoids_on_distances(X, D, l2, K, iter_limit=iter_limit,
                                   id_sort=id_sort)
    torch.cuda.synchronize()
    same = (m1 == m2).all(dim=1)
    n_diff, Bs = int((~same).sum()), X.shape[0]

    def cost(meds, assign):
        med_of = torch.gather(meds.long(), 1, assign.long())
        return torch.gather(D.double(), 1, med_of[:, None, :])[:, 0].sum(-1)
    c1, c2 = cost(m1, a1), cost(m2, a2)
    cost_rel = ((c1 - c2).abs() / c2.abs()).max().item()
    st = steps.long()
    # the plain version stops on the batch-mean shift, the kernel at each
    # segment's fixed point: the segments where one more Lloyd step would
    # still move the plain version's medoid set
    nxt = _update_step(D, _assign_step(D, m2.long()), K).sort(dim=1).values
    short = int((nxt != m2.long()).any(dim=1).sum())
    steps_differing = int((fixed_point_steps(D, l2, K, iter_limit)
                           != steps).sum())
    variant = variant or kmedoids_cuda.choose_variant(X.shape[1], K)
    strict = variant != kmedoids_cuda.SHARED
    print(f"kmedoids [{label}] X {tuple(X.shape)} K={K}: segments with "
          f"other ids {n_diff}/{Bs}, max relative cost gap {cost_rel:.3e} "
          f"(tol {KMEDOIDS_COST_RTOL}), Lloyd steps min/mean/max "
          f"{int(st.min())}/{st.float().mean().item():.2f}/{int(st.max())}, "
          f"segments with other steps than the plain version's to their "
          f"fixed point {steps_differing}/{Bs}, segments the plain version "
          f"left short of their fixed point {short}/{Bs}")
    if strict and (n_diff or steps_differing):
        fail(f"k-medoids {variant} variant [{label}]: {n_diff} segments with "
             f"other ids, {steps_differing} with other steps than the plain "
             f"version")
    if n_diff and cost_rel > KMEDOIDS_COST_RTOL:
        fail(f"k-medoids kernel [{label}] found a costlier clustering than "
             f"its plain version")
    if same.float().mean().item() < KMEDOIDS_MIN_SAME:
        fail(f"k-medoids [{label}] ids differ on {n_diff}/{Bs} segments")
    if not torch.equal(a1[same], a2[same]):
        fail(f"k-medoids [{label}] assignments differ where the medoids "
             f"agree")
    row = dict(shape=list(X.shape), max_abs_err=float((m1 != m2).sum()),
               segments_differing=n_diff, max_rel_cost_gap=cost_rel,
               lloyd_steps_mean=st.float().mean().item(),
               segments_other_steps=steps_differing,
               plain_short_of_fixed_point=short)
    return row, (X, D, l2, steps, a1)


def hold_attention_bwd(torch, dev, flush, peaks, label, B, L, H, mask_kind,
                       qkv=None):
    """Kernel B against `attention_bwd_plain` on seeded bf16 qkv
    [B, L, 3 * 64 H] (or the `qkv` given, e.g. one a path recorded) and a
    seeded dO (causal mask if `mask_kind`): within one bf16
    ulp, the share of differing values printed, the autograd Function's
    gradient the kernel's bit for bit; kernel A's forward held and timed
    (beside SDPA) on the way.  Times the kernel, the plain version and
    SDPA's backward.  Returns (B's row, A's row)."""
    from centerclip_tpu_torch.ops import attention_cuda
    mem_rate, bf16_peak, _ = peaks
    D = 64 * H
    gen = torch.Generator(device=dev).manual_seed(B + L)
    if qkv is None:
        qkv = torch.randn((B, L, 3 * D), generator=gen, device=dev).to(
            torch.bfloat16)
    dout = torch.randn((B, L, D), generator=gen, device=dev).to(
        torch.bfloat16)
    mask = (torch.full((L, L), float("-inf"), device=dev).triu(1)
            if mask_kind else None)
    dqkv, _ = attention_cuda.attention_backward(qkv, dout, H, mask)
    ref, _ = attention_cuda.attention_bwd_plain(qkv, dout, H, mask)
    xg = qkv.clone().requires_grad_(True)
    out = attention_cuda.fused_attention(xg, H, mask)
    out.backward(dout)
    # kernel A's forward at the training shape, held as in the serving
    # shapes above
    fwd_ref = attention_cuda.attention_plain(qkv, H, mask)
    torch.cuda.synchronize()
    fwd_err = (out.detach().float() - fwd_ref.float()).abs()
    if not bool((fwd_err <= BF16_ATOL
                 + BF16_RTOL * fwd_ref.float().abs()).all()):
        fail(f"attention [{label}, training] disagrees with its plain "
             f"version")
    del out, fwd_ref
    f_ms = time_ms(lambda: attention_cuda.fused_attention(
        qkv, H, mask), flush=flush)
    f_plain_ms = time_ms(lambda: attention_cuda.attention_plain(
        qkv, H, mask), flush=flush)
    qh, kh, vh = (t.reshape(B, L, H, 64).transpose(1, 2)
                  for t in qkv.split(D, dim=-1))
    f_lib_ms = time_ms(lambda: torch.nn.functional
                       .scaled_dot_product_attention(
                           qh, kh, vh, is_causal=mask is not None),
                       flush=flush)
    del qh, kh, vh
    f_b_ms, f_b_by = bound(qkv.numel() * 2 + B * L * D * 2
                           + (L * L * 4 if mask is not None else 0),
                           4.0 * B * H * L * L * 64, bf16_peak, mem_rate)
    fwd_variant = attention_cuda.choose_variant(qkv.dtype, 64, L)
    fwd_row = dict(shape=list(qkv.shape), variant=fwd_variant,
                   max_abs_err=fwd_err.max().item(),
                   ms=f_ms, plain_ms=f_plain_ms, library_ms=f_lib_ms,
                   bound_ms=f_b_ms, bound_by=f_b_by)
    if fwd_variant == attention_cuda.TENSOR_CORE_LONG:
        fwd_row["occupancy"] = attention_cuda.long_occupancy(qkv.dtype, 64)
    print(f"attention [{label}, training] qkv {tuple(qkv.shape)} bf16 "
          f"H={H}, {fwd_variant} variant{occupancy_note(fwd_row)}: "
          f"max_abs_err {fwd_err.max().item():.3e} (tol "
          f"{BF16_ATOL} + {BF16_RTOL}*|ref|) ms {f_ms:.4f} plain "
          f"{f_plain_ms:.4f} sdpa {f_lib_ms:.4f} bound {f_b_ms:.4f} "
          f"({f_b_by})")
    del fwd_err
    err = (dqkv.float() - ref.float()).abs()
    ok = bool((err <= BF16_ATOL + BF16_RTOL * ref.float().abs()).all())
    differing = (dqkv != ref).float().mean().item()
    passes = torch.equal(xg.grad, dqkv)
    del xg, ref
    ms = time_ms(lambda: attention_cuda.attention_backward(
        qkv, dout, H, mask), flush=flush)
    plain_ms = time_ms(lambda: attention_cuda.attention_bwd_plain(
        qkv, dout, H, mask), flush=flush)
    q, k, v = (t.reshape(B, L, H, 64).transpose(1, 2).detach()
               .requires_grad_(True) for t in qkv.split(D, dim=-1))
    o = torch.nn.functional.scaled_dot_product_attention(
        q, k, v, is_causal=mask is not None)
    do_h = dout.reshape(B, L, H, 64).transpose(1, 2)
    # autograd.grad returns fresh gradients: nothing accumulates into
    # q.grad, k.grad, v.grad from one timed call to the next
    lib_ms = time_ms(lambda: torch.autograd.grad(
        o, (q, k, v), do_h, retain_graph=True), flush=flush)
    del q, k, v, o
    b_ms, b_by = bound(2 * qkv.numel() * 2 + dout.numel() * 2
                       + (L * L * 4 if mask is not None else 0),
                       5 * 2.0 * B * H * L * L * 64, bf16_peak, mem_rate)
    variant = attention_cuda.choose_variant(qkv.dtype, 64, L,
                                            backward=True)
    occupancy = (attention_cuda.long_occupancy(qkv.dtype, 64, backward=True)
                 if variant == attention_cuda.TENSOR_CORE_LONG else None)
    print(f"attention bwd [{label}] qkv {tuple(qkv.shape)} bf16 H={H}, "
          f"{variant} variant{occupancy_note(dict(occupancy=occupancy))}: "
          f"max_abs_err {err.max().item():.3e} (tol "
          f"{BF16_ATOL} + {BF16_RTOL}*|ref|), values differing from the "
          f"plain version {differing:.4%}, Function passes the kernel's "
          f"gradient through: {passes}; ms {ms:.4f} plain {plain_ms:.4f} "
          f"sdpa bwd {lib_ms:.4f} bound {b_ms:.4f} ({b_by}); ms / sdpa "
          f"bwd {ms / lib_ms:.3f}, ms / bound {ms / b_ms:.2f}")
    if not ok:
        fail(f"attention bwd [{label}] disagrees with its plain version")
    if not passes:
        fail(f"attention bwd [{label}]: the autograd Function's gradient "
             f"is not the kernel's")
    row = dict(shape=list(qkv.shape), variant=variant,
               max_abs_err=err.max().item(), share_differing=differing, ms=ms,
               plain_ms=plain_ms, library_ms=lib_ms, vs_library=ms / lib_ms,
               bound_ms=b_ms, bound_by=b_by)
    if occupancy is not None:
        row["occupancy"] = occupancy
    return row, fwd_row


def occupancy_note(row):
    """' (kernel: registers, shared memory per CTA, CTAs per SM; ...)' for
    a row of a long-variant kernel, else ''."""
    occ = row.get("occupancy")
    if not occ:
        return ""
    return " (" + "; ".join(
        f"{k}: {v['registers']} registers, {v['smem_bytes']} B shared "
        f"memory per CTA, {v['ctas_per_sm']} CTAs per SM"
        for k, v in occ.items()) + ")"


def held_layernorm_bwd(torch, label, x, w, dy):
    """Kernel D against `layer_norm_bwd_plain` on x, dy [..., D] (x's
    dtype) and w [D]: dx within BF16_ATOL / BF16_RTOL (bf16) or FP32_ATOL
    / FP32_RTOL (fp32) of the plain dx, dgamma and dbeta within SUM_RTOL
    of the sum of their terms' magnitudes; fails otherwise.  Returns the
    kernel's (dx, dgamma, dbeta), dx's largest error and dgamma's and
    dbeta's."""
    from centerclip_tpu_torch.ops import layernorm_triton
    atol, rtol = ((BF16_ATOL, BF16_RTOL) if x.dtype == torch.bfloat16
                  else (FP32_ATOL, FP32_RTOL))
    dx, dw, db = layernorm_triton.layer_norm_backward(x, w, dy)
    rx, rw, rb = layernorm_triton.layer_norm_bwd_plain(x, w, dy)
    xf = x.reshape(-1, x.shape[-1]).float()
    dyf = dy.reshape(-1, x.shape[-1]).float()
    xhat = (xf - xf.mean(-1, keepdim=True)) * torch.rsqrt(
        xf.var(-1, correction=0, keepdim=True) + 1e-5)
    err_x = (dx.float() - rx.float()).abs()
    ok = bool((err_x <= atol + rtol * rx.float().abs()).all())
    err_wb = 0.0
    for out, ref, terms in ((dw, rw, (dyf * xhat).abs().sum(0)),
                            (db, rb, dyf.abs().sum(0))):
        e = (out - ref).abs()
        ok = ok and bool((e <= SUM_RTOL * terms + 1e-6).all())
        err_wb = max(err_wb, e.max().item())
    if not ok:
        fail(f"layernorm bwd [{label}] disagrees with its plain version")
    return (dx, dw, db), err_x.max().item(), err_wb


def hold_layernorm_bwd(torch, dev, flush, peaks, label, R, D, dtype=None):
    """Kernel D against `layer_norm_bwd_plain` on seeded x, dy [R, D] of
    `dtype` (bf16 by default; dx within one bf16 ulp, fp32 within
    FP32_ATOL / FP32_RTOL; dgamma/dbeta within SUM_RTOL of the sum of the
    terms' magnitudes, the autograd Function's gradients the kernel's, a
    second call equal to the bit, its device launches per call counted);
    kernel C's forward held and timed on the way.  Times the kernel, the
    plain version and ATen's fp32 backward.  Returns (D's row, C's row)."""
    from centerclip_tpu_torch.ops import layernorm_triton
    dtype = dtype or torch.bfloat16
    name = str(dtype).split(".")[-1]
    atol, rtol = ((BF16_ATOL, BF16_RTOL) if dtype == torch.bfloat16
                  else (FP32_ATOL, FP32_RTOL))
    mem_rate, _, fp32_peak = peaks
    gen = torch.Generator(device=dev).manual_seed(R + 1)
    x = (torch.randn((R, D), generator=gen, device=dev) * 3 + 1).to(dtype)
    dy = torch.randn((R, D), generator=gen, device=dev).to(dtype)
    w = torch.randn(D, generator=gen, device=dev) * 0.1 + 1
    b = torch.randn(D, generator=gen, device=dev)
    (dx, dw, db), err_x, err_wb = held_layernorm_bwd(
        torch, label, x, w, dy)
    xs, ws, bs = (t.clone().requires_grad_(True) for t in (x, w, b))
    out = layernorm_triton.layer_norm(xs, ws, bs)
    out.backward(dy)
    # kernel C's forward at the training shape
    fwd_ref = layernorm_triton.layer_norm_plain(x, w, b)
    torch.cuda.synchronize()
    fwd_err = (out.detach().float() - fwd_ref.float()).abs()
    if not bool((fwd_err <= atol + rtol * fwd_ref.float().abs()).all()):
        fail(f"layernorm [{label}, training] disagrees with its plain "
             f"version")
    passes = (torch.equal(xs.grad, dx) and torch.equal(ws.grad, dw)
              and torch.equal(bs.grad, db))
    del xs, ws, bs, out, fwd_ref
    xf, dyf = x.float(), dy.float()
    f_b_ms, f_b_by = layernorm_bound(x, peaks)
    fwd_row = dict(shape=[R, D], dtype=name,
                   max_abs_err=fwd_err.max().item(),
                   **layernorm_row_times(x, w, b, flush),
                   bound_ms=f_b_ms, bound_by=f_b_by)
    print(f"layernorm [{label}, training] x ({R}, {D}) {name}: "
          f"max_abs_err {fwd_err.max().item():.3e} (tol {atol} + "
          f"{rtol}*|ref|) ms {fwd_row['ms']:.4f} plain "
          f"{fwd_row['plain_ms']:.4f} F.layer_norm ({fwd_row['library_params']}"
          f" gamma/beta) {fwd_row['library_ms']:.4f}, on an fp32 copy "
          f"{fwd_row['library_fp32_copy_ms']:.4f} bound {f_b_ms:.4f} "
          f"({f_b_by})")
    del fwd_err
    ms = time_ms(lambda: layernorm_triton.layer_norm_backward(
        x, w, dy), flush=flush)
    plain_ms = time_ms(lambda: layernorm_triton
                       .layer_norm_bwd_plain(x, w, dy), flush=flush)
    _, mean, rstd = torch.ops.aten.native_layer_norm(xf, [D], w, b, 1e-5)
    lib_ms = time_ms(lambda: torch.ops.aten
                     .native_layer_norm_backward(
                         dyf, xf, [D], mean, rstd, w, b,
                         [True, True, True]), flush=flush)
    b_ms, b_by = bound(3 * x.numel() * x.element_size() + 3 * D * 4,
                       16.0 * R * D, fp32_peak, mem_rate)
    again = layernorm_triton.layer_norm_backward(x, w, dy)
    bitwise = all(torch.equal(u, v) for u, v in zip(again, (dx, dw, db)))
    del again
    dev_names = device_launches(torch, lambda: layernorm_triton
                                .layer_norm_backward(x, w, dy))
    print(f"layernorm bwd [{label}] x ({R}, {D}) {name}: dx max_abs_err "
          f"{err_x:.3e} (tol {atol} + {rtol}*|ref|)"
          f", dgamma/dbeta max_abs_err {err_wb:.3e} (tol {SUM_RTOL}*sum"
          f"|terms| + 1e-6), Function passes the kernel's gradients "
          f"through: {passes}, a second call equal to the bit: "
          f"{bitwise}; device launches per call {len(dev_names)} "
          f"{sorted(set(dev_names))}; ms {ms:.4f} plain {plain_ms:.4f} "
          f"native_layer_norm_backward(fp32) {lib_ms:.4f} bound "
          f"{b_ms:.4f} ({b_by})")
    if not bitwise:
        fail(f"layernorm bwd [{label}]: two calls on the same inputs "
             f"differ")
    if not passes:
        fail(f"layernorm bwd [{label}]: the autograd Function's "
             f"gradients are not the kernel's")
    return dict(shape=[R, D], dtype=name,
                max_abs_err=max(err_x, err_wb), ms=ms,
                plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                bound_by=b_by, device_launches_per_call=len(dev_names)), fwd_row


# kernel F's extra rows beyond QUICK_GELU_SHAPES (bf16): (label, rows, width,
# dtype) -- fp32 ViT-B/16 (`--precision fp32`) and fp16
QUICK_GELU_OTHER_DTYPES = (("fp32 ViT-B/16 blocks 7-12", 123648, 3072, "float32"),
                           ("fp16 ViT-B/32 blocks 7-12", 38400, 3072, "float16"))


def hold_quick_gelu(torch, dev, flush, peaks):
    """Kernel F at the MLP's c_fc output shapes (QUICK_GELU_SHAPES in bf16,
    QUICK_GELU_OTHER_DTYPES): its output and x's gradient through
    `quick_gelu_op` equal the eager composition's to the bit, then both
    directions timed beside their byte bound and the eager ops
    (`quick_gelu_times`).  Returns the rows."""
    from centerclip_tpu_torch.ops import quick_gelu as qg
    cases = [(label, R, D, torch.bfloat16) for label, R, D in
             QUICK_GELU_SHAPES] + [(label, R, D, getattr(torch, dt)) for
                                   label, R, D, dt in QUICK_GELU_OTHER_DTYPES]
    rows = []
    for label, R, D, dtype in cases:
        gen = torch.Generator(device=dev).manual_seed(R + D)
        x = (torch.randn((R, D), generator=gen, device=dev) * 4).to(dtype)
        dy = torch.randn((R, D), generator=gen, device=dev).to(dtype)
        xe = x.clone().requires_grad_()
        ye = qg.quick_gelu_plain(xe)
        ye.backward(dy)
        xk = x.clone().requires_grad_()
        yk = qg.quick_gelu_op(xk)
        yk.backward(dy)
        torch.cuda.synchronize()
        bits = torch.int32 if dtype == torch.float32 else torch.int16
        same = (torch.equal(yk.detach().view(bits), ye.detach().view(bits)),
                torch.equal(xk.grad.view(bits), xe.grad.view(bits)))
        if not all(same):
            fail(f"quick_gelu [{label}, {dtype}]: kernel F's output / "
                 f"gradient equal to the eager composition's: {same}")
        del xe, ye, xk, yk
        row = dict(label=label, shape=[R, D],
                   dtype=str(dtype).split(".")[-1], bits_equal=True,
                   **quick_gelu_times(x, dy, flush, peaks))
        print(f"kernel F [{label}] {row['dtype']}: forward "
              f"{row['forward']['ms']:.4f} ms ({row['forward']['of_bound']} "
              f"% of bound; eager {row['forward']['eager_ms']:.4f}), "
              f"backward {row['backward']['ms']:.4f} ms "
              f"({row['backward']['of_bound']} %; eager "
              f"{row['backward']['eager_ms']:.4f}, plain "
              f"{row['backward']['plain_ms']:.4f})")
        rows.append(row)
        del x, dy
        torch.cuda.empty_cache()
    return rows


def layernorm_row_times(x, w, b, flush):
    """`layernorm_times` on x [R, D], which must be one of
    LAYERNORM_FWD_SHAPES (the shapes `bench_ln_kmedoids.py` times too)."""
    R, D = x.numel() // x.shape[-1], x.shape[-1]
    if not any((R, D, x.dtype) == s[1:] for s in LAYERNORM_FWD_SHAPES):
        fail(f"layernorm x ({R}, {D}) {x.dtype} is not one of "
             f"LAYERNORM_FWD_SHAPES")
    return layernorm_times(x, w, b, flush)


def cluster_segments(x, before_frames, after_frames):
    """The patch tokens `x` [B * before_frames, 1 + P, width] a cluster
    layer took, grouped into `after_frames` segments per clip:
    [after_frames * B, before_frames / after_frames * P, width]."""
    from centerclip_tpu_torch.ops.cluster_layer import segment_major
    Bc = x.shape[0] // before_frames
    return segment_major(
        x[:, 1:, :].reshape(Bc, before_frames, -1, x.shape[-1]),
        after_frames, before_frames // after_frames)


def kmedoids_case(torch, flush, peaks, label, x, before_frames,
                  after_frames, K, iters, variant=None):
    """Kernel E held (`hold_kmedoids`) and timed against its plain version
    on the patch tokens `x` a cluster layer took (`cluster_segments`)."""
    return kmedoids_points_case(torch, flush, peaks, label, cluster_segments(
        x, before_frames, after_frames), K, iters, variant)


def kmedoids_points_case(torch, flush, peaks, label, points, K, iters,
                         variant=None):
    """Kernel E held (`hold_kmedoids`) and timed against its plain version
    on [B, N, Dim] points (the router's variant, or `variant`): the row of
    the kernel table at their shape, with the cluster variant's CTAs a
    segment, the Lloyd steps and both bounds (4-byte entries and 32-byte
    sectors)."""
    from centerclip_tpu_torch.ops import kmedoids_cuda
    from centerclip_tpu_torch.ops.kmedoids import kmedoids_on_distances
    row, (X, D, l2, steps, assign) = hold_kmedoids(torch, label, points, K,
                                                   iters, variant=variant)
    B, N = X.shape[:2]
    variant = variant or kmedoids_cuda.choose_variant(N, K)
    cs = kmedoids_cuda.device_cluster_size(X.device, B, N, K) \
        if variant == kmedoids_cuda.CLUSTER else None
    ms = time_ms(lambda: kmedoids_cuda.kmedoids_from_distances(
        D, l2, K, iters, variant=variant), flush=flush)
    plain_ms = time_ms(lambda: kmedoids_on_distances(
        X, D, l2, K, iter_limit=iters), flush=flush)
    b_ms, b_by = kmedoids_bound(K, assign, steps, peaks)
    s_ms, s_by = kmedoids_sector_bound(K, assign, steps, peaks)
    split = {}
    if variant != kmedoids_cuda.SHARED:
        # KKZ, the id sort and the last assignment alone: no Lloyd step
        split["kkz_ms"] = time_ms(
            lambda: kmedoids_cuda.kmedoids_from_distances(
                D, l2, K, 0, variant=variant), flush=flush)
    print(f"kmedoids [{label}] {variant} variant"
          + (f" on {cs} CTAs a segment" if cs else "")
          + f", Lloyd steps mean {row['lloyd_steps_mean']:.2f}: ms "
          f"{ms:.4f} plain {plain_ms:.4f} bound {b_ms:.5f} ({b_by}), by "
          f"sectors {s_ms:.5f} ({s_by})"
          + (f"; with no Lloyd step {split['kkz_ms']:.4f}" if split else ""))
    return dict(row, variant=variant, cluster_size=cs, ms=ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                sector_bound_ms=s_ms, sector_bound_by=s_by, **split)


def vitb16_phase(torch, np, dev, flush, peaks, counters):
    """The fourth main path: ViT-B/16 (the preset msrvtt_vitb16_k6: L = 197
    in blocks 1-6, k-medoids of 2 x 196 = 392 tokens per segment into
    K = 160 before block 7, L = 161 after), encoding a gallery through
    `RetrievalEngine` and training through `Trainer` at batch 128 with
    `remat`; then kernels B and E at their new variants' shapes, and A, C
    and D at the new shapes, against their plain versions."""
    from centerclip_tpu_torch.config import preset
    from centerclip_tpu_torch.models.clip4clip import CLIP4Clip
    from centerclip_tpu_torch.ops import attention_cuda as ac
    from centerclip_tpu_torch.ops import kmedoids_cuda as kc
    from centerclip_tpu_torch.serve import RetrievalEngine
    from centerclip_tpu_torch.train import Trainer
    run = preset(VITB16_PRESET, remat=VITB16_REMAT)
    B, cfg = run.batch_size, run.model
    spec = next(s for s in cfg.cluster_plan() if s is not None)
    N, K = spec.frame_duration * spec.before_cluster_num, spec.cluster_num
    if (N, K) != (392, 160) or kc.choose_variant(N) != kc.GLOBAL:
        fail(f"{VITB16_PRESET} clusters N={N}, K={K}")

    def variants():
        return {"attention_backward": dict(ac.attention_backward
                                           .variant_launches),
                "fused_attention": dict(ac.fused_attention.variant_launches),
                "kmedoids": dict(kc.kmedoids_from_distances.variant_launches)}

    # ---- encode: 64 clips in batches of 32 and one search
    t0 = time.time()
    model = CLIP4Clip(cfg, device=dev, seed=0).eval()
    engine = RetrievalEngine(model, device=dev)
    g = np.random.default_rng(16)
    clips = g.integers(0, 256, (N_CLIPS, 1, FRAMES, 3, RES, RES),
                       dtype=np.uint8)
    masks = np.ones((N_CLIPS, FRAMES), np.int32)
    ids = [f"b16clip{i:03d}" for i in range(N_CLIPS)]

    def batches(lo=0, hi=N_CLIPS):
        for s in range(lo, hi, BATCH):
            yield {"video": clips[s:min(s + BATCH, hi)],
                   "video_mask": masks[s:min(s + BATCH, hi)]}
    engine.build_index(batches(0, 2), ids[:2], quantize="int8")  # warm-up
    engine.search(QUERIES, k=2)
    torch.cuda.synchronize()
    t_setup = time.time() - t0
    enc_x = {}
    hook = first_input_hook(cluster_module(model), enc_x)
    zero_counts(counters)
    t0 = time.time()
    index = engine.build_index(batches(), ids, quantize="int8")
    torch.cuda.synchronize()
    t_build = time.time() - t0
    hits = engine.search(QUERIES, k=5)
    enc_launches = {fn.__name__: fn.launches for fn in counters}
    enc_variants = variants()
    hook.remove()
    gallery = index._codes[:N_CLIPS].float() * index._scales[:N_CLIPS]
    # the same encode again, its shapes seen once: the first one's extra
    # time is what it paid for first calls at a batch of BATCH clips
    t0 = time.time()
    engine.build_index(batches(), ids, quantize="int8")
    torch.cuda.synchronize()
    t_again = time.time() - t0
    print(f"vitb16 encode: {N_CLIPS} clips in {t_build:.3f} s = "
          f"{N_CLIPS / t_build:.2f} clips/s (batches of {BATCH}; set-up and "
          f"warm-up {t_setup:.2f} s), again {t_again:.3f} s = "
          f"{N_CLIPS / t_again:.2f} clips/s; launches {enc_launches}, by "
          f"variant {enc_variants}")
    if tuple(gallery.shape) != (N_CLIPS, 512) or \
            not bool(torch.isfinite(gallery).all()):
        fail("the ViT-B/16 gallery is not finite [64, 512]")
    if any(len(row) != 5 or not all(np.isfinite([h["score"] for h in row]))
           for row in hits):
        fail(f"bad ViT-B/16 hits {hits}")
    # the vision blocks' attention (L = 197, 161) through the long forward
    # only: 12 launches per batch of clips; the queries' text tower (L = 32)
    # through the tensor-core one
    km, fwd = enc_variants["kmedoids"], enc_variants["fused_attention"]
    n_batches = -(-N_CLIPS // BATCH)
    if not km[kc.GLOBAL] or km[kc.SHARED] or km[kc.CLUSTER] or \
            km[kc.SCRATCH] or fwd[ac.CUDA_CORE] or fwd[ac.TF32X3] or \
            fwd[ac.TENSOR_CORE_LONG] != 12 * n_batches or \
            not enc_launches["layer_norm"] or \
            not enc_launches["quick_gelu_forward"] or \
            enc_launches["quick_gelu_backward"]:
        fail(f"the ViT-B/16 encode ran other kernel variants: {enc_variants}")
    del engine, index, gallery, model
    torch.cuda.empty_cache()

    # ---- training at batch 128: warm-up and timed steps, then resume
    t0 = time.time()
    model = CLIP4Clip(cfg, device=dev, seed=0)
    steps = VITB16_WARMUP_STEPS + VITB16_TIMED_STEPS
    trainer = Trainer(run, model, total_steps=steps + 1)
    batch = seeded_batch(np, np.random.default_rng(17), B, cfg.max_frames,
                         cfg.max_words)
    t_setup = time.time() - t0
    train_x = {}
    hook = first_input_hook(cluster_module(model), train_x)
    zero_counts(counters)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    med, step_ms, losses, _ = timed_steps(torch, np, trainer, batch,
                                          VITB16_WARMUP_STEPS,
                                          VITB16_TIMED_STEPS, "ViT-B/16")
    hook.remove()
    trainer.metric_writer = None
    peak = torch.cuda.max_memory_allocated()
    launches = {fn.__name__: fn.launches for fn in counters}
    train_variants = variants()
    print(f"vitb16 training ({VITB16_PRESET}, batch {B}, remat "
          f"{'on' if cfg.remat else 'off'}: {VITB16_REMAT_WHY}; set-up "
          f"{t_setup:.2f} s): losses {[round(x, 6) for x in losses]}, step "
          f"times {[round(x, 3) for x in step_ms]} ms; median of the "
          f"{VITB16_TIMED_STEPS} timed {med:.3f} ms = {B / med * 1e3:.2f} "
          f"clips/s; peak memory allocated {peak / 2**30:.3f} GiB")
    print(f"vitb16 launches during the training steps: {launches}, by "
          f"variant {train_variants}")
    # per step: 12 vision blocks at L = 197 / 161 (the long variants), 12
    # text blocks at L = 32 (the L <= 128 ones), each block's forward twice
    # under remat; one k-medoids launch
    bwd, kmv = train_variants["attention_backward"], train_variants["kmedoids"]
    fwd = train_variants["fused_attention"]
    per_fwd = 2 if cfg.remat else 1
    want_bwd = {ac.TENSOR_CORE_LONG: 12 * steps, ac.TENSOR_CORE: 12 * steps,
                ac.CUDA_CORE: 0, ac.TF32X3: 0}
    want_fwd = {ac.TENSOR_CORE_LONG: 12 * per_fwd * steps,
                ac.TENSOR_CORE: 12 * per_fwd * steps, ac.CUDA_CORE: 0,
                ac.TF32X3: 0}
    if bwd != want_bwd or fwd != want_fwd or \
            kmv != {kc.GLOBAL: steps, kc.SHARED: 0, kc.CLUSTER: 0,
                    kc.SCRATCH: 0}:
        fail(f"the ViT-B/16 training steps ran other kernel variants than "
             f"the long attention variants (forward {want_fwd}, backward "
             f"{want_bwd}) and the global k-medoids: {train_variants}")
    for fn_name, n in launches.items():
        if n == 0:
            fail(f"{fn_name} was never launched on the ViT-B/16 path")
    check_quick_gelu_launches("the ViT-B/16 training steps", launches,
                              steps, per_fwd)

    resumed_step(torch, run, model, trainer, batch, steps + 1, "vitb16")
    del trainer, model, batch
    torch.cuda.empty_cache()

    # ---- kernels at the ViT-B/16 shapes
    bwd_rows, fwd_rows = [], []
    for case in (("ViT-B/16 vision blocks 1-6", B * FRAMES, 197, 12, None),
                 ("ViT-B/16 vision blocks 7-12", B * FRAMES // 2, 161, 12,
                  None)):
        row, fwd_row = hold_attention_bwd(torch, dev, flush, peaks, *case)
        if row["variant"] != ac.TENSOR_CORE_LONG or \
                fwd_row["variant"] != ac.TENSOR_CORE_LONG:
            fail(f"attention at {row['shape']} took {fwd_row['variant']} / "
                 f"{row['variant']}")
        bwd_rows.append(row)
        fwd_rows.append(fwd_row)
    ln_rows, lnf_rows = [], []
    for case in (("ViT-B/16 vision ln_1/ln_2, blocks 1-6",
                  B * FRAMES * 197, 768),
                 ("ViT-B/16 vision ln_1/ln_2, blocks 7-12",
                  B * FRAMES // 2 * 161, 768)):
        row, fwd_row = hold_layernorm_bwd(torch, dev, flush, peaks, *case)
        ln_rows.append(row)
        lnf_rows.append(fwd_row)
    km_rows = [kmedoids_case(torch, flush, peaks, "ViT-B/16 training",
                             train_x.pop("x"), FRAMES, spec.after_frames, K,
                             cfg.cluster.iter_limit),
               kmedoids_case(torch, flush, peaks, "ViT-B/16 encode",
                             enc_x.pop("x"), FRAMES, spec.after_frames, K,
                             cfg.cluster.iter_limit)]
    result = dict(
        preset=VITB16_PRESET, batch=B, remat=cfg.remat, steps=steps,
        step_ms=med, clips_per_s=B / med * 1e3,
        step_ms_all=step_ms, losses=losses,
        peak_memory_bytes=peak, resumed_step_equal=True,
        encode_clips=N_CLIPS, encode_s=t_build,
        encode_clips_per_s=N_CLIPS / t_build,
        encode_again_clips_per_s=N_CLIPS / t_again)
    return result, dict(
        launches=launches, variants=train_variants,
        encode_launches=enc_launches, encode_variants=enc_variants,
        attention_bwd=bwd_rows, attention_fwd=fwd_rows,
        layernorm_bwd=ln_rows, layernorm_fwd=lnf_rows, kmedoids=km_rows)


def long_segment_flags(K):
    """Experiment 62's flags at ViT-B/16 with remat, clustering segments of
    LONG_SEG_FRAMES frames (N = 196 LONG_SEG_FRAMES tokens) into K before
    block 7."""
    return exp62_flags(
        pretrained_clip_name="ViT-B/16", remat="1",
        cluster_num_blocks=["196"] * 6 + [str(K)] * 6,
        target_frames_blocks=["12"] * 6
        + [str(FRAMES // LONG_SEG_FRAMES)] * 6)


def first_inputs_hook(module, store, n):
    """Keep copies of the first `n` inputs `module` takes in
    `store["xs"]`."""
    store["xs"] = []

    def capture(_, args):
        if len(store["xs"]) < n:
            store["xs"].append(args[0].detach().clone())
    return module.register_forward_pre_hook(capture)


class _LengthCounting:
    """Stands in for an attention wrapper: calls it and adds the launches
    the wrapper counted during the call to `counts[L]`, L the qkv's
    sequence length.  The wrapper's own counts (`launches`,
    `variant_launches`), which it updates through its module's name, are
    read and written through to the wrapper."""

    def __init__(self, fn, counter, counts):
        for name, value in (("_fn", fn), ("_counter", counter),
                            ("_counts", counts)):
            object.__setattr__(self, name, value)

    def __call__(self, qkv, *args, **kw):
        before = self._counter.launches
        out = self._fn(qkv, *args, **kw)
        L = int(qkv.shape[1])
        self._counts[L] = self._counts.get(L, 0) \
            + self._counter.launches - before
        return out

    def __getattr__(self, name):
        return getattr(self._fn, name)

    def __setattr__(self, name, value):
        setattr(self._fn, name, value)


@contextlib.contextmanager
def attention_launches_by_length(lengths):
    """Within the block, count kernel A's and B's launches by sequence
    length in `lengths` ({"fwd": {L: n}, "bwd": {L: n}}), from the
    wrappers' own counts around each call."""
    from centerclip_tpu_torch.ops import attention_cuda as ac
    fwd, bwd = ac._forward, ac.attention_backward
    lengths.update(fwd={}, bwd={})
    ac._forward = _LengthCounting(fwd, ac.fused_attention, lengths["fwd"])
    ac.attention_backward = _LengthCounting(bwd, bwd, lengths["bwd"])
    try:
        yield lengths
    finally:
        ac._forward, ac.attention_backward = fwd, bwd


def gallery_encode(torch, np, cfg, dev, counters, seed, prefix, label,
                   read_counts):
    """An encode of N_CLIPS seeded clips (12 frames of RES²) of a fresh
    eval-mode model of `cfg` through `RetrievalEngine.build_index` in
    batches of BATCH, after a 2-clip warm-up and a search; counts zeroed
    just before the encode and read by `read_counts` just after it; then a
    search of QUERIES.  Fails unless the gallery is finite [N_CLIPS, 512]
    and every query has 5 finite hits.  Returns (the result dict, what
    `read_counts` gave, the cluster layer's first input of the encode)."""
    from centerclip_tpu_torch.models.clip4clip import CLIP4Clip
    from centerclip_tpu_torch.serve import RetrievalEngine
    t0 = time.time()
    model = CLIP4Clip(cfg, device=dev, seed=0).eval()
    engine = RetrievalEngine(model, device=dev)
    g = np.random.default_rng(seed)
    clips = g.integers(0, 256, (N_CLIPS, 1, FRAMES, 3, RES, RES),
                       dtype=np.uint8)
    masks = np.ones((N_CLIPS, FRAMES), np.int32)
    ids = [f"{prefix}{i:03d}" for i in range(N_CLIPS)]

    def batches(hi=N_CLIPS):
        for s in range(0, hi, BATCH):
            yield {"video": clips[s:min(s + BATCH, hi)],
                   "video_mask": masks[s:min(s + BATCH, hi)]}
    engine.build_index(batches(2), ids[:2])                 # warm-up
    engine.search(QUERIES, k=2)
    torch.cuda.synchronize()
    t_setup = time.time() - t0
    enc_x = {}
    hook = first_input_hook(cluster_module(model), enc_x)
    zero_counts(counters)
    t0 = time.time()
    index = engine.build_index(batches(), ids)
    torch.cuda.synchronize()
    t_enc = time.time() - t0
    counts = read_counts()
    hook.remove()
    hits = engine.search(QUERIES, k=5)
    gallery = index._codes[:N_CLIPS].float()
    print(f"{label}: {N_CLIPS} clips in {t_enc:.3f} s = "
          f"{N_CLIPS / t_enc:.2f} clips/s (batches of {BATCH}; set-up and "
          f"warm-up {t_setup:.2f} s); counts {counts}")
    if tuple(gallery.shape) != (N_CLIPS, 512) or \
            not bool(torch.isfinite(gallery).all()) or \
            any(len(row) != 5 or not all(np.isfinite([h["score"]
                                                      for h in row]))
                for row in hits):
        fail(f"{label}: the gallery is not finite [64, 512] or the hits are "
             f"bad")
    del engine, index, gallery, model, clips
    torch.cuda.empty_cache()
    return (dict(encode_clips=N_CLIPS, encode_s=t_enc,
                 encode_clips_per_s=N_CLIPS / t_enc), counts,
            enc_x.get("x"))


def main_on_fixture(torch, np, counters, root, name, flags, label):
    """`main(argv)` with `flags` on main's fixture in `root` (its output in
    `root`/`name`), counts zeroed just before; the caller reads them just
    after.  Fails unless it trained one epoch of finite losses (an epoch
    of MAIN_VIDEOS x MAIN_CAPTIONS pairs) and evaluated MAIN_VIDEOS clips.
    Returns the result dict."""
    from centerclip_tpu_torch.main import main as run_main
    from centerclip_tpu_torch.train import evaluate
    evals = []
    evaluate_fn = evaluate.Evaluator.evaluate

    def recording_evaluate(self, *a, **k):
        t = time.time()
        res_ = evaluate_fn(self, *a, **k)
        evals.append((res_, time.time() - t))
        return res_
    out_dir = os.path.join(root, name)
    evaluate.Evaluator.evaluate = recording_evaluate
    try:
        zero_counts(counters)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        best_r1 = run_main(main_argv(root, out_dir, flags=flags))
        torch.cuda.synchronize()
        t_main = time.time() - t0
    finally:
        evaluate.Evaluator.evaluate = evaluate_fn
    peak = torch.cuda.max_memory_allocated()
    with open(os.path.join(out_dir, "tensorboard", "scalars.jsonl")) as f:
        scalars = [json.loads(line) for line in f]
    losses = [r["train/sim_loss"] for r in scalars]
    step_s = [r["train/batch_time"] for r in scalars]
    res1, t_eval = evals[0] if evals else (None, 0.0)
    print(f"{label}: {t_main:.2f} s, {len(losses)} steps, losses {losses}, "
          f"step times {[round(x * 1e3, 3) for x in step_s]} ms; evaluation "
          f"of {MAIN_VIDEOS} clips {t_eval:.3f} s, R@1 "
          f"{res1 and res1['R1']}; peak memory {peak / 2**30:.3f} GiB")
    if len(losses) != MAIN_VIDEOS * MAIN_CAPTIONS // MAIN_BATCH or \
            len(losses) > 4 or not np.isfinite(losses).all() or \
            res1 is None or best_r1 != res1["R1"] or \
            res1["sim_matrix"].shape != (MAIN_VIDEOS, MAIN_VIDEOS) or \
            not np.isfinite(res1["sim_matrix"]).all():
        fail(f"{label}: {len(losses)} steps, losses {losses}, evaluation "
             f"{res1 and res1['R1']}")
    return dict(steps=len(losses), losses=losses,
                step_ms_all=[x * 1e3 for x in step_s], run_s=t_main,
                eval_s=t_eval, eval_clips=MAIN_VIDEOS, R1=res1["R1"],
                peak_memory_bytes=peak)


def long_segments_phase(torch, np, dev, flush, peaks, counters, root):
    """The fourteenth main path: ViT-B/16 at full width on segments of
    LONG_SEG_FRAMES frames, through the flags both CLIs take (no preset:
    the JAX package has none for these schedules), with remat.  (a)
    N = 784 into K = LONG_SEG_K: LONG_SEG_WARMUP_STEPS compared steps
    (kernel E held to its plain version on each one's tokens) and
    LONG_SEG_TIMED_STEPS timed ones at batch 128, an encode of 64 clips
    through `RetrievalEngine.build_index`, and `main` on main's fixture in
    `root` (3 steps, then its evaluation); (b) the same into
    LONG_SEG_WIDE_K, LONG_SEG_WIDE_STEPS steps, so that kernel B runs at
    L = 393 > 256 in a real step; (c) E's cluster variant against its plain
    version at the step's [384, 784, 784], an encode batch's
    [96, 784, 784], three-frame segments' [512, 588, 588], a whole clip's
    [8, 2352, 2352] and on spectral embeddings of 2 clips at N = 784, and
    A and B on (b)'s qkv [384, 393, 2304].  Counts are zeroed before each
    run and read after it; fails unless E ran its cluster variant only and
    B launched at L > 256."""
    from centerclip_tpu_torch import cli
    from centerclip_tpu_torch.models.clip4clip import CLIP4Clip
    from centerclip_tpu_torch.ops import attention_cuda as ac
    from centerclip_tpu_torch.ops import kmedoids_cuda as kc
    from centerclip_tpu_torch.ops import spectral
    from centerclip_tpu_torch.train import Trainer
    fwd_fn, bwd_fn = ac.fused_attention, ac.attention_backward

    def variants():
        return {"attention_backward": dict(bwd_fn.variant_launches),
                "fused_attention": dict(fwd_fn.variant_launches),
                "kmedoids": dict(kc.kmedoids_from_distances.variant_launches)}

    def read_counts():
        """(launches by kernel, variants) since the counts were zeroed."""
        return {fn.__name__: fn.launches for fn in counters}, variants()

    def check_counts(label, launches, by_variant, kmedoids_launches,
                     backward=True):
        launched(label, launches, [k for k in launches if backward
                                   or not k.endswith("backward")])
        kmv = by_variant["kmedoids"]
        if kmv != {kc.SHARED: 0, kc.GLOBAL: 0,
                   kc.CLUSTER: kmedoids_launches, kc.SCRATCH: 0} \
                or not kmedoids_launches or by_variant["fused_attention"][
                    ac.CUDA_CORE]:
            fail(f"{label}: k-medoids ran {kmv}, not its cluster variant "
                 f"alone ({kmedoids_launches} launches), attention "
                 f"{by_variant}")

    def train(K, warmup, timed, label, seed, hold_steps=0, record=None):
        run = cli.parse_args(long_segment_flags(K))
        cfg = run.model
        spec = next(s for s in cfg.cluster_plan() if s is not None)
        N = spec.frame_duration * spec.before_cluster_num
        if (N, spec.cluster_num, cfg.clip_name, cfg.remat) != (
                196 * LONG_SEG_FRAMES, K, "ViT-B/16", True):
            fail(f"{label}: the flags give N={N}, K={spec.cluster_num}, "
                 f"{cfg.clip_name}, remat {cfg.remat}")
        t0 = time.time()
        model = CLIP4Clip(cfg, device=dev, seed=0)
        steps = warmup + timed
        trainer = Trainer(run, model, total_steps=steps)
        batch = seeded_batch(np, np.random.default_rng(seed), run.batch_size,
                             cfg.max_frames, cfg.max_words)
        t_setup = time.time() - t0
        xs, lengths, seen = {}, {}, {}
        hook = first_inputs_hook(cluster_module(model), xs, hold_steps)
        sites = [site for site in kernel_call_sites()
                 if site[2] == "attention_fwd"]
        zero_counts(counters)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with attention_launches_by_length(lengths), \
                recording_kernel_inputs(torch, seen,
                                        lambda: record is not None, sites):
            med, step_ms, losses, _ = timed_steps(torch, np, trainer, batch,
                                                  warmup, timed, label)
        peak = torch.cuda.max_memory_allocated()
        launches, by_variant = read_counts()
        hook.remove()
        B = run.batch_size
        print(f"{label} training (N={N}, K={K}, batch {B}, remat on, set-up "
              f"{t_setup:.2f} s): losses {[round(x, 6) for x in losses]}, "
              f"step times {[round(x, 3) for x in step_ms]} ms; median of "
              f"the {timed} timed {med:.3f} ms = {B / med * 1e3:.2f} clips/s; "
              f"peak memory allocated {peak / 2**30:.3f} GiB; launches "
              f"{launches}, by variant {by_variant}, attention launches by "
              f"L {lengths}")
        check_counts(label, launches, by_variant, steps)
        # per step: 12 vision blocks at L = 197 and 1 + K through the long
        # variants, 12 text blocks at L = 32 through the L <= 128 ones,
        # each block's forward twice under remat
        want_bwd = {ac.TENSOR_CORE_LONG: 12 * steps,
                    ac.TENSOR_CORE: 12 * steps, ac.CUDA_CORE: 0,
                    ac.TF32X3: 0}
        want_fwd = {v: 2 * n for v, n in want_bwd.items()}
        if by_variant["attention_backward"] != want_bwd or \
                by_variant["fused_attention"] != want_fwd or \
                lengths["bwd"].get(1 + K) != 6 * steps:
            fail(f"{label}: attention ran {by_variant}, by L {lengths}")
        if record is not None:
            record.update(seen)
        seen.clear()
        xs = xs["xs"]
        held = [hold_kmedoids(torch, f"{label}, step {i + 1}",
                              cluster_segments(x, spec.before_frames,
                                               spec.after_frames), K,
                              cfg.cluster.iter_limit)[0]
                for i, x in enumerate(xs)]
        del model, trainer, batch
        torch.cuda.empty_cache()
        result = dict(N=N, K=K, batch=B, steps=steps, step_ms=med,
                      clips_per_s=B / med * 1e3, step_ms_all=step_ms,
                      losses=losses, peak_memory_bytes=peak,
                      attention_launches_by_length=lengths, held_steps=held)
        return run, result, (launches, by_variant), xs

    out, paths = {}, {}
    # ---- (a) training: compared and timed steps
    run, out["training"], paths["long_segments_training"], xs = train(
        LONG_SEG_K, LONG_SEG_WARMUP_STEPS, LONG_SEG_TIMED_STEPS,
        "long segments", 41, hold_steps=LONG_SEG_WARMUP_STEPS)
    cfg = run.model
    train_x = xs[0]
    del xs

    # ---- (a) encode: 64 clips in batches of 32 and one search
    out["encode"], (enc_launches, enc_variants), enc_x = gallery_encode(
        torch, np, cfg, dev, counters, 43, "longclip",
        "long segments encode", read_counts)
    check_counts("long segments encode", enc_launches, enc_variants,
                 -(-N_CLIPS // BATCH), backward=False)
    paths["long_segments_encode"] = (enc_launches, enc_variants)

    # ---- (a) main on the fixture: 3 steps of 128, then its evaluation
    out["main"] = main_on_fixture(torch, np, counters, root, "long_segments",
                                  long_segment_flags(LONG_SEG_K),
                                  "long segments main")
    main_launches, main_variants = read_counts()
    print(f"long segments main: launches {main_launches}, by variant "
          f"{main_variants}")
    check_counts("long segments main", main_launches, main_variants,
                 main_variants["kmedoids"][kc.CLUSTER])
    paths["long_segments_main"] = (main_launches, main_variants)
    torch.cuda.empty_cache()

    # ---- (b) K = 392: blocks 7-12 at L = 393, kernel B past 256
    recorded = {}
    _, out["long_attention"], paths["long_attention_training"], _ = train(
        LONG_SEG_WIDE_K, 0, LONG_SEG_WIDE_STEPS, "long attention", 42,
        record=recorded)
    by_length = out["long_attention"]["attention_launches_by_length"]
    past = {key: sum(n for L, n in by_length[key].items() if L > 256)
            for key in ("fwd", "bwd")}
    if not past["bwd"] or not past["fwd"]:
        fail(f"long attention: kernels A and B at L > 256 launched {past}")

    # ---- (c) kernels at these shapes
    K, iters = LONG_SEG_K, cfg.cluster.iter_limit
    S = FRAMES // LONG_SEG_FRAMES
    km_rows = [kmedoids_case(torch, flush, peaks, "long segments, step",
                             train_x, FRAMES, S, K, iters),
               kmedoids_case(torch, flush, peaks, "long segments, encode "
                             "batch", enc_x, FRAMES, S, K, iters),
               kmedoids_case(torch, flush, peaks, "3-frame segments",
                             train_x, FRAMES, FRAMES // 3, K, iters),
               kmedoids_case(torch, flush, peaks, "a whole clip",
                             train_x[:8 * FRAMES], FRAMES, 1, K, iters)]
    # spectral embeddings of 2 clips' segments, the tokens scaled to lie a
    # median SPECTRAL_MEDIAN_SIGMAS sigma apart (the seed's lie so far
    # apart that the heat kernel underflows: W = I)
    two = cluster_segments(train_x[:2 * FRAMES], FRAMES, S).float()
    sigma = cfg.cluster.spectral_sigma
    alpha = SPECTRAL_MEDIAN_SIGMAS * sigma / torch.cdist(two, two).median()
    Q = spectral.spectral_embedding(two * alpha, K, sigma=sigma)
    km_rows.append(kmedoids_points_case(torch, flush, peaks,
                                        "long segments, spectral embedding",
                                        Q, K, iters))
    del train_x, two, Q, enc_x
    shapes = [r["shape"][:2] for r in km_rows]
    if shapes != [[384, 784], [96, 784], [512, 588], [8, 2352], [6, 784]] \
            or any(r["variant"] != kc.CLUSTER for r in km_rows):
        fail(f"long segments: E held at {shapes}, "
             f"{[r['variant'] for r in km_rows]}")
    qkv = next(args[0] for (_, _), (args, _) in recorded.items()
               if args[0].shape[1] == 1 + LONG_SEG_WIDE_K)
    recorded.clear()
    bwd_row, fwd_row = hold_attention_bwd(
        torch, dev, flush, peaks, "long attention, blocks 7-12",
        qkv.shape[0], qkv.shape[1], 12, None, qkv=qkv)
    del qkv
    torch.cuda.empty_cache()
    return out, dict(paths=paths, past_256=past, kmedoids=km_rows,
                     attention_fwd=[fwd_row], attention_bwd=[bwd_row])


def fp32_cluster_hooks(model, chosen, replay):
    """Wrap each cluster module's `_cluster` of `model`: record its outputs
    call by call into `chosen[i]` (module i), or, with `replay` ([0, 0]
    counts the segments whose own choice differed, of all), run its own
    choice and hand back the recorded ones, call by call."""
    mods = [b.tokencluster_inter
            for b in model.clip.visual.transformer.resblocks
            if b.tokencluster_inter is not None]
    for i, mod in enumerate(mods):
        own = mod._cluster
        if replay is None:
            chosen.setdefault(i, [])

            def record(res_tmp, own=own, i=i):
                out = own(res_tmp)
                chosen[i].append(tuple(t.cpu() for t in out))
                return out
            mod._cluster = record
        else:
            calls = iter(list(chosen[i]))

            def replayed(res_tmp, own=own, calls=calls):
                mine = own(res_tmp)[1]
                theirs = next(calls)
                replay[0] += int((mine != theirs[1]).any(dim=1).sum())
                replay[1] += mine.shape[0]
                return theirs
            mod._cluster = replayed


def fp32_cpu_check(torch, np, dev, run, batch):
    """Card against CPU, both in fp32 from the same seeded weights, the
    card's medoid ids replayed on the CPU (its own k-medoids still runs,
    and the segments where it chose otherwise are counted): the 2-clip
    pooled embedding by cosine (FP32_VIDEO_MIN_COS), then one training
    step on the 2 clips by loss (FP32_LOSS_RTOL) and the cosine of every
    trainable gradient of >= TRAIN_GRAD_MIN_NUMEL elements
    (FP32_GRAD_MIN_COS)."""
    from centerclip_tpu_torch.models.clip4clip import CLIP4Clip
    from centerclip_tpu_torch.serve import RetrievalEngine
    from centerclip_tpu_torch.train import build_optimizer, make_train_step
    t0 = time.time()
    small = {k: v[:2] for k, v in batch.items()}
    two = {k: small[k] for k in ("video", "video_mask")}
    torch.set_num_threads(os.cpu_count() or 1)
    card = CLIP4Clip(run.model, device=dev, seed=0)
    weights = {k: v.cpu().clone() for k, v in card.state_dict().items()}

    def cpu_model():
        m = CLIP4Clip(run.model, device="cpu", seed=1)
        m.load_state_dict(weights, strict=True)
        return m

    def one_step(model):
        model.train()
        opt = build_optimizer(run.optim, model, 10,
                              freeze_layer_num=run.freeze_layer_num)
        loss = float(make_train_step(model, opt)(small)["loss"])
        return loss, {n: p.grad.detach().double().cpu().flatten()
                      for n, p in model.named_parameters()
                      if p.requires_grad and p.numel() >= TRAIN_GRAD_MIN_NUMEL}

    # the embedding
    chosen, differing = {}, [0, 0]
    fp32_cluster_hooks(card, chosen, None)
    emb_card = RetrievalEngine(card.eval(), device=dev).embed_video_batches(
        [two])
    cpu = cpu_model()
    fp32_cluster_hooks(cpu, chosen, differing)
    emb_cpu = RetrievalEngine(cpu.eval(), device="cpu").embed_video_batches(
        [two])
    cos_emb = cosines(emb_card, emb_cpu)
    # the training step, from fresh copies of the same weights
    card = CLIP4Clip(run.model, device=dev, seed=0)
    card.load_state_dict(weights, strict=True)
    chosen.clear()
    fp32_cluster_hooks(card, chosen, None)
    l_card, g_card = one_step(card)
    cpu = cpu_model()
    fp32_cluster_hooks(cpu, chosen, differing)
    l_cpu, g_cpu = one_step(cpu)
    rel = abs(l_card - l_cpu) / abs(l_cpu)
    cos = sorted(((n, float((g_card[n] @ g_cpu[n])
                            / (g_card[n].norm() * g_cpu[n].norm())))
                  for n in g_cpu),
                 key=lambda kv: (not math.isnan(kv[1]), kv[1]))
    print(f"fp32 CPU check ({time.time() - t0:.1f} s), the card's medoids "
          f"replayed (segments where the CPU's own choice differs: "
          f"{differing[0]}/{differing[1]}): 2-clip embedding cosine "
          f"{np.round(cos_emb, 7).tolist()} (min {FP32_VIDEO_MIN_COS}); one "
          f"step on 2 clips: loss card {l_card:.7f} cpu {l_cpu:.7f} "
          f"(relative gap {rel:.3e}, tol {FP32_LOSS_RTOL}), gradient cosine "
          f"over {len(cos)} tensors >= {TRAIN_GRAD_MIN_NUMEL} elements: min "
          f"{cos[0][1]:.7f} (min {FP32_GRAD_MIN_COS}), lowest {cos[:3]}")
    if cos_emb.min() < FP32_VIDEO_MIN_COS:
        fail("card and CPU fp32 ViT-B/16 embeddings disagree")
    if not rel <= FP32_LOSS_RTOL:
        fail("card and CPU fp32 ViT-B/16 training losses disagree")
    if not all(c >= FP32_GRAD_MIN_COS for _, c in cos):
        fail(f"card and CPU fp32 ViT-B/16 gradients disagree: {cos[:3]}")
    return dict(embedding_min_cos=float(cos_emb.min()), loss_card=l_card,
                loss_cpu=l_cpu, loss_rel_gap=rel, grad_min_cos=cos[0][1],
                grad_tensors=len(cos), kmedoids_segments_differing=differing[0],
                kmedoids_segments=differing[1])


def hold_attention_fp32(torch, dev, flush, peaks, label, B, L, H, causal,
                        qkv=None, mask=None, time_it=True):
    """Kernels A and B on fp32 qkv [B, L, 3 * 64 H] (seeded, or the `qkv`
    and `mask` a path recorded) and a seeded dO against `attention_plain`
    and `attention_bwd_plain` (FP32_ATOL / FP32_RTOL forward, FP32_BWD_ATOL
    / FP32_BWD_RTOL backward), B's gradient through the autograd Function
    the kernel's to the bit.  With `time_it`, both timed by CUDA events
    (A as a training step runs it, with its log-sum-exp; B from A's output
    and log-sum-exp, as the autograd Function hands them over) beside
    their plain versions and SDPA in fp32 (its backward by
    `torch.autograd.grad`), with two bounds: the operations the function
    needs (4 L^2 hd a head forward, 10 backward) over the card's fp32
    CUDA-core peak (`bound_ffma_ms`), and, as `bound_ms`, the operations
    the variant runs (tf32x3: three TF32 passes, over the TF32 peak; the
    CUDA-core one: over the fp32 peak), each against the bytes over the
    memory rate.  Returns (A's row, B's row)."""
    from centerclip_tpu_torch.ops import attention_cuda as ac
    mem_rate, _, fp32_peak = peaks
    D = 64 * H
    gen = torch.Generator(device=dev).manual_seed(B + L)
    if qkv is None:
        qkv = torch.randn((B, L, 3 * D), generator=gen, device=dev)
        mask = (torch.full((L, L), float("-inf"), device=dev).triu(1)
                if causal else None)
    dout = torch.randn((B, L, D), generator=gen, device=dev)
    xg = qkv.clone().requires_grad_(True)
    out = ac.fused_attention(xg, H, mask)
    out.backward(dout)
    dqkv, _ = ac.attention_backward(qkv, dout, H, mask)
    f_err = hold_close(torch, f"attention fp32 [{label}]", out.detach(),
                       ac.attention_plain(qkv, H, mask), FP32_ATOL, FP32_RTOL)
    b_err = hold_close(torch, f"attention bwd fp32 [{label}]", dqkv,
                       ac.attention_bwd_plain(qkv, dout, H, mask)[0],
                       FP32_BWD_ATOL, FP32_BWD_RTOL)
    if not torch.equal(xg.grad, dqkv):
        fail(f"attention bwd fp32 [{label}]: the autograd Function's "
             f"gradient is not the kernel's")
    del xg, out
    rows = []
    for backward, err in ((False, f_err), (True, b_err)):
        variant = ac.choose_variant(torch.float32, 64, L, backward)
        row = dict(shape=list(qkv.shape), variant=variant, max_abs_err=err)
        if variant == ac.TF32X3:
            row["occupancy"] = ac.long_occupancy(torch.float32, 64, backward)
        rows.append(row)
    fwd, bwd = rows
    note = ""
    if time_it:
        q, k, v = (t.reshape(B, L, H, 64).transpose(1, 2)
                   for t in qkv.split(D, dim=-1))
        mask_bytes = L * L * 4 if mask is not None else 0
        out, lse = ac._forward(qkv, H, mask, lse_out=True)
        fwd.update(
            ms=time_ms(lambda: ac._forward(qkv, H, mask, lse_out=True),
                       flush=flush),
            plain_ms=time_ms(lambda: ac.attention_plain(qkv, H, mask),
                             flush=flush),
            library_ms=time_ms(lambda: torch.nn.functional
                               .scaled_dot_product_attention(
                                   q, k, v, is_causal=mask is not None),
                               flush=flush))
        fwd_bytes = qkv.numel() * 4 + B * L * D * 4 + mask_bytes
        fwd["bound_ms"], fwd["bound_by"] = fp32_attention_bound(
            fwd_bytes, 4.0 * B * H * L * L * 64, fwd["variant"], peaks)
        fwd["bound_ffma_ms"], _ = bound(fwd_bytes, 4.0 * B * H * L * L * 64,
                                        fp32_peak, mem_rate)
        qg, kg, vg = (t.detach().requires_grad_(True) for t in (q, k, v))
        o = torch.nn.functional.scaled_dot_product_attention(
            qg, kg, vg, is_causal=mask is not None)
        do_h = dout.reshape(B, L, H, 64).transpose(1, 2)
        bwd.update(
            ms=time_ms(lambda: ac.attention_backward(qkv, dout, H, mask,
                                                     out=out, lse=lse),
                       flush=flush),
            plain_ms=time_ms(lambda: ac.attention_bwd_plain(
                qkv, dout, H, mask), flush=flush),
            library_ms=time_ms(lambda: torch.autograd.grad(
                o, (qg, kg, vg), do_h, retain_graph=True), flush=flush))
        bwd_bytes = 2 * qkv.numel() * 4 + dout.numel() * 4 + mask_bytes
        bwd["bound_ms"], bwd["bound_by"] = fp32_attention_bound(
            bwd_bytes, 10.0 * B * H * L * L * 64, bwd["variant"], peaks)
        bwd["bound_ffma_ms"], _ = bound(bwd_bytes, 10.0 * B * H * L * L * 64,
                                        fp32_peak, mem_rate)
        del q, k, v, qg, kg, vg, o, out, lse
        for row in rows:
            row["vs_library"] = row["ms"] / row["library_ms"]
        note = (f"; ms {fwd['ms']:.4f} / {bwd['ms']:.4f}, plain "
                f"{fwd['plain_ms']:.4f} / {bwd['plain_ms']:.4f}, sdpa fp32 "
                f"{fwd['library_ms']:.4f} / {bwd['library_ms']:.4f}, bound "
                f"{fwd['bound_ms']:.4f} ({fwd['bound_by']}) / "
                f"{bwd['bound_ms']:.4f} ({bwd['bound_by']}), FFMA bound "
                f"{fwd['bound_ffma_ms']:.4f} / {bwd['bound_ffma_ms']:.4f}, vs "
                f"sdpa {fwd['vs_library']:.3f} / {bwd['vs_library']:.3f}")
    print(f"attention fp32 [{label}] qkv {tuple(qkv.shape)} H={H}"
          f"{' causal' if mask is not None else ''}: forward {fwd['variant']}"
          f"{occupancy_note(fwd)}, max_abs_err {f_err:.3e} (tol {FP32_ATOL} + "
          f"{FP32_RTOL}*|ref|); backward {bwd['variant']}"
          f"{occupancy_note(bwd)}, max_abs_err {b_err:.3e} (tol "
          f"{FP32_BWD_ATOL} + {FP32_BWD_RTOL}*|ref|){note}")
    return fwd, bwd


def fp32_attention_bound(n_bytes, flops, variant, peaks):
    """(ms, "bytes" or "operations") of fp32 attention that needs `flops`
    fp32 operations: tf32x3 runs them three times over (three TF32 passes
    a product) at the TF32 tensor-core peak, the CUDA-core variant once at
    the fp32 peak."""
    from centerclip_tpu_torch.ops import attention_cuda as ac
    mem_rate, _, fp32_peak = peaks
    if variant == ac.TF32X3:
        return bound(n_bytes, 3 * flops, tf32_peak(peaks), mem_rate)
    return bound(n_bytes, flops, fp32_peak, mem_rate)


def hold_attention_fp32_cuda_core(torch, dev):
    """The fp32 CUDA-core variant, which no path runs where tf32x3 takes
    the head_dim (FP32_SHORT_RANGES are empty), forced on the text
    tower's causal [128, 32] at 8 heads of 64 and taken past head_dim 128
    ([4, 40] at 2 heads of 192): A and B against their plain versions
    within FP32_ATOL / FP32_RTOL and FP32_BWD_ATOL / FP32_BWD_RTOL.
    Returns the rows' errors."""
    from centerclip_tpu_torch.ops import attention_cuda as ac
    rows = []
    for B, L, H, hd, causal in ((128, 32, 8, 64, True),
                                (4, 40, 2, 192, False)):
        gen = torch.Generator(device=dev).manual_seed(L + hd)
        qkv = torch.randn((B, L, 3 * H * hd), generator=gen, device=dev)
        dout = torch.randn((B, L, H * hd), generator=gen, device=dev)
        mask = (torch.full((L, L), float("-inf"), device=dev).triu(1)
                if causal else None)
        label = f"fp32 cuda_core [{B}, {L}] hd {hd}"
        f_err = hold_close(torch, label, ac._forward(
            qkv, H, mask, variant=ac.CUDA_CORE), ac.attention_plain(
                qkv, H, mask), FP32_ATOL, FP32_RTOL)
        b_err = hold_close(torch, label + " bwd", ac.attention_backward(
            qkv, dout, H, mask, variant=ac.CUDA_CORE)[0],
            ac.attention_bwd_plain(qkv, dout, H, mask)[0], FP32_BWD_ATOL,
            FP32_BWD_RTOL)
        rows.append(dict(shape=list(qkv.shape), causal=causal,
                         max_abs_err_fwd=f_err, max_abs_err_bwd=b_err))
        print(f"attention {label}: forward max_abs_err {f_err:.3e}, "
              f"backward {b_err:.3e}")
    return rows


def fp32_threshold_rows(torch, dev, flush):
    """Both fp32 variants of A and B by CUDA events at FP32_THRESHOLD_CASES,
    where the short one fits (the times FP32_SHORT_RANGES are set from);
    rows with the variant `choose_variant` takes."""
    from centerclip_tpu_torch.ops import _build, attention_cuda as ac
    rows = []
    for B, L, H, causal in FP32_THRESHOLD_CASES:
        gen = torch.Generator(device=dev).manual_seed(L)
        qkv = torch.randn((B, L, 3 * 64 * H), generator=gen, device=dev)
        dout = torch.randn((B, L, 64 * H), generator=gen, device=dev)
        mask = (torch.full((L, L), float("-inf"), device=dev).triu(1)
                if causal else None)
        row = dict(shape=list(qkv.shape), causal=causal)
        out, lse = ac._forward(qkv, H, mask, variant=ac.TF32X3, lse_out=True)
        for backward, key in ((False, "fwd"), (True, "bwd")):
            row[f"{key}_variant"] = ac.choose_variant(torch.float32, 64, L,
                                                      backward)
            for v in ac.FP32_VARIANTS:
                if v == ac.CUDA_CORE and ac.fp32_short_smem_bytes(
                        L, 64, backward) > _build.MAX_SMEM_BYTES:
                    continue
                # B from tf32x3's output and log-sum-exp, as a training
                # step hands them over (the CUDA-core one takes neither)
                fn = ((lambda v=v: ac.attention_backward(
                          qkv, dout, H, mask, variant=v, out=out, lse=lse))
                      if backward else
                      (lambda v=v: ac._forward(qkv, H, mask, variant=v,
                                               lse_out=True)))
                row[f"{key}_{v}_ms"] = time_ms(fn, flush=flush)
        print(f"attention fp32 variants at qkv {tuple(qkv.shape)}"
              f"{' causal' if causal else ''}: {row}")
        rows.append(row)
        del qkv, dout, out, lse
    return rows


def fp32_vitb16_phase(torch, np, dev, flush, peaks, counters, root):
    """The fifteenth main path: the preset msrvtt_vitb16_k6 with
    `--precision fp32` and remat (L = 197 in blocks 1-6, 161 after the
    cluster layer; kernels A and B on their fp32 variants, the vision
    blocks on tf32x3).  FP32_WARMUP_STEPS + FP32_TIMED_STEPS
    training steps at batch 128 (peak memory), an encode of 64 clips and a
    search, card against CPU (`fp32_cpu_check`), `main(argv)` on main's
    fixture in `root` with `--precision fp32` (3 steps of 128, then its
    evaluation of 48 clips); then A and B against their plain versions on
    the first input of each shape the steps gave them, their rows at
    FP32_ATTENTION_CASES, both fp32 variants' times at
    FP32_THRESHOLD_CASES and the CUDA-core variant held where no path
    takes it (`hold_attention_fp32_cuda_core`).  Counts are zeroed before
    each run and read after it: attention must run its fp32 variants only,
    the vision blocks' on tf32x3 (24 forward and 12 backward launches a
    step with remat, 12 forward launches an encode batch)."""
    from centerclip_tpu_torch import cli
    from centerclip_tpu_torch.config import preset
    from centerclip_tpu_torch.models.clip4clip import CLIP4Clip
    from centerclip_tpu_torch.ops import attention_cuda as ac
    from centerclip_tpu_torch.ops import kmedoids_cuda as kc
    from centerclip_tpu_torch.train import Trainer
    run = preset(VITB16_PRESET, remat=True, precision="fp32",
                 compute_dtype="float32")
    B, cfg = run.batch_size, run.model
    spec = next(s for s in cfg.cluster_plan() if s is not None)
    N, K = spec.frame_duration * spec.before_cluster_num, spec.cluster_num
    text_L = cfg.max_words
    if (N, K, cfg.compute_dtype) != (392, 160, "float32") or \
            ac.choose_variant(torch.float32, 64, 161) != ac.TF32X3 \
            or ac.choose_variant(torch.float32, 64, 161, True) \
            != ac.TF32X3:
        fail(f"fp32 {VITB16_PRESET}: N={N}, K={K}, {cfg.compute_dtype}, or "
             f"L = 161 is not the tf32x3 variant's")
    text_fwd = ac.choose_variant(torch.float32, 64, text_L)
    text_bwd = ac.choose_variant(torch.float32, 64, text_L, backward=True)

    def read_counts():
        """(launches by kernel, attention's by variant, E's by variant)"""
        return ({fn.__name__: fn.launches for fn in counters},
                {fn.__name__: dict(fn.variant_launches)
                 for fn in (ac.fused_attention, ac.attention_backward)},
                dict(kc.kmedoids_from_distances.variant_launches))

    def check(label, launches, by_variant, km, steps, per_fwd, backward):
        """steps: training steps (backward) or encode batches"""
        launched(label, launches, [k for k in launches if backward
                                   or not k.endswith("backward")])
        # 12 vision blocks at L = 197 and 161; in a step also 12 text
        # blocks; no other variant
        fwd, bwd = {ac.TF32X3: 12 * per_fwd * steps}, {}
        if backward:
            fwd[text_fwd] = fwd.get(text_fwd, 0) + 12 * per_fwd * steps
            bwd = {ac.TF32X3: 12 * steps}
            bwd[text_bwd] = bwd.get(text_bwd, 0) + 12 * steps
        for fn_name, want in (("fused_attention", fwd),
                              ("attention_backward", bwd)):
            want = {v: want.get(v, 0) for v in ac.VARIANTS}
            if by_variant[fn_name] != want:
                fail(f"{label}: {fn_name} launched {by_variant[fn_name]}, "
                     f"not {want}")
        if km != {kc.SHARED: 0, kc.GLOBAL: km[kc.GLOBAL], kc.CLUSTER: 0,
                  kc.SCRATCH: 0} or not km[kc.GLOBAL]:
            fail(f"{label}: k-medoids ran {km}, not its global variant "
                 f"alone")

    out, paths = {}, {}
    # ---- training at batch 128: warm-up and timed steps
    t0 = time.time()
    model = CLIP4Clip(cfg, device=dev, seed=0)
    steps = FP32_WARMUP_STEPS + FP32_TIMED_STEPS
    trainer = Trainer(run, model, total_steps=steps)
    batch = seeded_batch(np, np.random.default_rng(51), B, cfg.max_frames,
                         cfg.max_words)
    t_setup = time.time() - t0
    seen = {}
    sites = [site for site in kernel_call_sites()
             if site[2] == "attention_fwd"]
    zero_counts(counters)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with recording_kernel_inputs(torch, seen, sites=sites):
        med, step_ms, losses, _ = timed_steps(
            torch, np, trainer, batch, FP32_WARMUP_STEPS, FP32_TIMED_STEPS,
            "fp32 ViT-B/16")
    peak = torch.cuda.max_memory_allocated()
    launches, by_variant, km = read_counts()
    print(f"fp32 vitb16 training ({VITB16_PRESET} --precision fp32, batch "
          f"{B}, remat on, set-up {t_setup:.2f} s): losses "
          f"{[round(x, 6) for x in losses]}, step times "
          f"{[round(x, 3) for x in step_ms]} ms; median of the "
          f"{FP32_TIMED_STEPS} timed {med:.3f} ms = {B / med * 1e3:.2f} "
          f"clips/s; peak memory allocated {peak / 2**30:.3f} GiB; launches "
          f"{launches}, by variant {by_variant}, k-medoids {km}")
    check("fp32 ViT-B/16 training", launches, by_variant, km, steps, 2,
          True)
    paths["fp32_vitb16_training"] = (launches, dict(by_variant, kmedoids=km))
    out["training"] = dict(preset=VITB16_PRESET, precision="fp32", batch=B,
                           remat=True, steps=steps, step_ms=med,
                           clips_per_s=B / med * 1e3, step_ms_all=step_ms,
                           losses=losses, peak_memory_bytes=peak)
    del trainer, model
    torch.cuda.empty_cache()

    # ---- encode: 64 clips in batches of 32 and one search
    out["encode"], (launches, by_variant, km), _ = gallery_encode(
        torch, np, cfg, dev, counters, 52, "fp32clip", "fp32 vitb16 encode",
        read_counts)
    check("fp32 ViT-B/16 encode", launches, by_variant, km,
          -(-N_CLIPS // BATCH), 1, False)
    paths["fp32_vitb16_encode"] = (launches, dict(by_variant, kmedoids=km))

    # ---- card against CPU
    out["cpu_check"] = fp32_cpu_check(torch, np, dev, run, batch)
    del batch
    torch.cuda.empty_cache()

    # ---- main on the fixture: 3 steps of 128, then its evaluation
    flags = exp62_flags(pretrained_clip_name="ViT-B/16", remat="1",
                        precision="fp32",
                        cluster_num_blocks=["196"] * 6 + ["160"] * 6)
    parsed = cli.parse_args(flags).model
    pspec = next(s for s in parsed.cluster_plan() if s is not None)
    if (parsed.compute_dtype, parsed.clip_name, parsed.remat,
            pspec.frame_duration * pspec.before_cluster_num,
            pspec.cluster_num) != ("float32", "ViT-B/16", True, N, K):
        fail("fp32 main: the flags do not give the preset's model in fp32")
    out["main"] = main_on_fixture(torch, np, counters, root, "fp32_vitb16",
                                  flags, "fp32 vitb16 main")
    launches, by_variant, km = read_counts()
    print(f"fp32 vitb16 main: launches {launches}, by variant {by_variant}, "
          f"k-medoids {km}")
    # the evaluation's forwards run each block once (no remat), its text
    # tower in batches of its own: held by variant, not by count
    bf16 = [by[v] for by in by_variant.values() for v in by
            if v not in ac.FP32_VARIANTS]
    if any(bf16) or not by_variant["fused_attention"][ac.TF32X3] \
            or not by_variant["attention_backward"][ac.TF32X3] or \
            km != {kc.SHARED: 0, kc.GLOBAL: km[kc.GLOBAL], kc.CLUSTER: 0,
                   kc.SCRATCH: 0} or not km[kc.GLOBAL]:
        fail(f"fp32 main: attention ran {by_variant}, k-medoids {km}: not "
             f"the fp32 variants alone, tf32x3 among them, and E's "
             f"global one")
    paths["fp32_vitb16_main"] = (launches, dict(by_variant, kmedoids=km))
    torch.cuda.empty_cache()

    # ---- A and B on the steps' own inputs, then at the rows' shapes
    held = []
    for (_, key), (args, _) in seen.items():
        qkv, H, mask = (list(args) + [None])[:3]
        held.append(hold_attention_fp32(
            torch, dev, flush, peaks, f"fp32 step {key[0]}", qkv.shape[0],
            qkv.shape[1], H, mask is not None, qkv=qkv, mask=mask,
            time_it=False))
    seen.clear()
    if sorted(r["shape"][1] for r, _ in held) != sorted({197, 161, text_L}):
        fail(f"fp32 steps gave attention {[r['shape'] for r, _ in held]}")
    rows = [hold_attention_fp32(torch, dev, flush, peaks, *case)
            for case in FP32_ATTENTION_CASES]
    torch.cuda.empty_cache()
    out["thresholds"] = fp32_threshold_rows(torch, dev, flush)
    out["cuda_core_held"] = hold_attention_fp32_cuda_core(torch, dev)
    torch.cuda.empty_cache()
    return out, dict(paths=paths,
                     attention_fwd=[f for f, _ in rows],
                     attention_bwd=[b for _, b in rows],
                     held_fwd=[f for f, _ in held],
                     held_bwd=[b for _, b in held])


def seg20_flags():
    """Experiment 62's flags at ViT-B/16 with remat on SEG20_FRAMES frames,
    clustered before block 7 into SEG20_SEGMENTS segments of SEG20_K
    medoids (N = 196 SEG20_FRAMES / SEG20_SEGMENTS tokens a segment), at a
    batch of SEG20_BATCH."""
    return exp62_flags(
        pretrained_clip_name="ViT-B/16", remat="1",
        max_frames=str(SEG20_FRAMES), batch_size=str(SEG20_BATCH),
        cluster_num_blocks=["196"] * 6 + [str(SEG20_K)] * 6,
        target_frames_blocks=[str(SEG20_FRAMES)] * 6
        + [str(SEG20_SEGMENTS)] * 6)


def seg20_phase(torch, np, dev, flush, peaks, counters):
    """The sixteenth main path: ViT-B/16 at full width with remat on
    SEG20_FRAMES frames grouped into SEG20_SEGMENTS segments (N = 3920
    tokens a segment, K = SEG20_K), bf16, through the flags both CLIs
    take: an encode of SEG20_ENCODE_CLIPS clips (one batch: 96 segments,
    D 5.9 GB) and a search, and SEG20_WARMUP_STEPS + SEG20_STEPS training
    steps at batch SEG20_BATCH; kernel E held against its plain version on the step's
    and the encode's tokens; then E's rows past N = 3136: the
    step's tokens at K = 160 and 392, as 12-frame segments at K = N =
    2352, and one segment cut to N = 3137.  Counts are zeroed before each
    run and read after it: E must run its cluster variant only.  Last the
    scratch variant, which no path runs, on the step's tokens."""
    from centerclip_tpu_torch import cli
    from centerclip_tpu_torch.models.clip4clip import CLIP4Clip
    from centerclip_tpu_torch.ops import attention_cuda as ac
    from centerclip_tpu_torch.ops import kmedoids_cuda as kc
    from centerclip_tpu_torch.serve import RetrievalEngine
    from centerclip_tpu_torch.train import Trainer
    run = cli.parse_args(seg20_flags())
    cfg = run.model
    spec = next(s for s in cfg.cluster_plan() if s is not None)
    N, K = spec.frame_duration * spec.before_cluster_num, spec.cluster_num
    if (N, K, cfg.clip_name, cfg.remat, run.batch_size) != (
            196 * SEG20_FRAMES // SEG20_SEGMENTS, SEG20_K, "ViT-B/16", True,
            SEG20_BATCH) or kc.choose_variant(N, K) != kc.CLUSTER:
        fail(f"20-frame segments: the flags give N={N}, K={K}, "
             f"{cfg.clip_name}, remat {cfg.remat}")

    def read_counts():
        """(launches by kernel, launches by variant of A, B and E)"""
        return ({fn.__name__: fn.launches for fn in counters},
                {"fused_attention": dict(ac.fused_attention.variant_launches),
                 "attention_backward": dict(
                     ac.attention_backward.variant_launches),
                 "kmedoids": dict(kc.kmedoids_from_distances
                                  .variant_launches)})

    def check(label, launches, by_variant, n, backward):
        launched(label, launches, [k for k in launches if backward
                                   or not k.endswith("backward")])
        km = by_variant["kmedoids"]
        if km != {kc.SHARED: 0, kc.GLOBAL: 0, kc.CLUSTER: n, kc.SCRATCH: 0}:
            fail(f"{label}: k-medoids ran {km}, not its cluster variant "
                 f"alone {n} times")
        for fn_name in ("fused_attention", "attention_backward"):
            if any(by_variant[fn_name][v] for v in ac.FP32_VARIANTS):
                fail(f"{label}: {fn_name} ran an fp32 variant on a bf16 "
                     f"path: {by_variant[fn_name]}")

    out, paths = {}, {}
    # ---- encode: one batch of SEG20_ENCODE_CLIPS clips and a search
    t0 = time.time()
    model = CLIP4Clip(cfg, device=dev, seed=0).eval()
    engine = RetrievalEngine(model, device=dev)
    g = np.random.default_rng(60)
    n = SEG20_ENCODE_CLIPS
    clips = g.integers(0, 256, (n, 1, SEG20_FRAMES, 3, RES, RES),
                       dtype=np.uint8)
    masks = np.ones((n, SEG20_FRAMES), np.int32)
    ids = [f"seg20clip{i:03d}" for i in range(n)]
    engine.build_index([{"video": clips[:1], "video_mask": masks[:1]}],
                       ids[:1])                              # warm-up
    engine.search(QUERIES, k=1)
    torch.cuda.synchronize()
    t_setup = time.time() - t0
    enc_x = {}
    hook = first_input_hook(cluster_module(model), enc_x)
    zero_counts(counters)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    index = engine.build_index([{"video": clips, "video_mask": masks}], ids)
    torch.cuda.synchronize()
    t_enc = time.time() - t0
    launches, by_variant = read_counts()
    peak = torch.cuda.max_memory_allocated()
    hook.remove()
    hits = engine.search(QUERIES, k=5)
    gallery = index._codes[:n].float()
    print(f"20-frame segments encode: {n} clips of {SEG20_FRAMES} frames "
          f"({n * SEG20_SEGMENTS} segments of N={N}) in {t_enc:.3f} s = "
          f"{n / t_enc:.2f} clips/s (one batch; set-up and warm-up "
          f"{t_setup:.2f} s); peak memory {peak / 2**30:.3f} GiB; launches "
          f"{launches}, by variant {by_variant}")
    if tuple(gallery.shape) != (n, 512) or \
            not bool(torch.isfinite(gallery).all()) or \
            any(len(row) != 5 or not all(np.isfinite([h["score"]
                                                      for h in row]))
                for row in hits):
        fail("20-frame segments: the gallery is not finite or the hits are "
             "bad")
    check("20-frame segments encode", launches, by_variant, 1, False)
    paths["seg20_encode"] = (launches, by_variant)
    out["encode"] = dict(encode_clips=n, segments=n * SEG20_SEGMENTS, N=N,
                         K=K, encode_s=t_enc, encode_clips_per_s=n / t_enc,
                         peak_memory_bytes=peak)
    del engine, index, gallery, model, clips
    torch.cuda.empty_cache()

    # ---- training: a warm-up and a timed step at batch SEG20_BATCH
    t0 = time.time()
    model = CLIP4Clip(cfg, device=dev, seed=0)
    steps = SEG20_WARMUP_STEPS + SEG20_STEPS
    trainer = Trainer(run, model, total_steps=steps)
    batch = seeded_batch(np, np.random.default_rng(61), SEG20_BATCH,
                         cfg.max_frames, cfg.max_words)
    t_setup = time.time() - t0
    train_x = {}
    hook = first_input_hook(cluster_module(model), train_x)
    zero_counts(counters)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    med, step_ms, losses, _ = timed_steps(torch, np, trainer, batch,
                                          SEG20_WARMUP_STEPS, SEG20_STEPS,
                                          "20-frame segments")
    peak = torch.cuda.max_memory_allocated()
    launches, by_variant = read_counts()
    hook.remove()
    print(f"20-frame segments training (N={N}, K={K}, batch {SEG20_BATCH}, "
          f"remat on, set-up {t_setup:.2f} s): losses {losses}, step times "
          f"{[round(x, 3) for x in step_ms]} ms; peak memory allocated "
          f"{peak / 2**30:.3f} GiB; launches {launches}, by variant "
          f"{by_variant}")
    check("20-frame segments training", launches, by_variant, steps, True)
    paths["seg20_training"] = (launches, by_variant)
    out["training"] = dict(N=N, K=K, batch=SEG20_BATCH, steps=steps,
                           step_ms=med, step_ms_all=step_ms, losses=losses,
                           peak_memory_bytes=peak)
    del trainer, model, batch
    torch.cuda.empty_cache()

    # ---- E on the path's tokens, then at the rows' shapes
    iters = cfg.cluster.iter_limit
    x = train_x.pop("x")
    points = cluster_segments(x, SEG20_FRAMES, SEG20_SEGMENTS)
    km_rows = [kmedoids_points_case(torch, flush, peaks,
                                    "20-frame segments, step", points, K,
                                    iters),
               kmedoids_case(torch, flush, peaks, "20-frame segments, encode",
                             enc_x.pop("x"), SEG20_FRAMES, SEG20_SEGMENTS, K,
                             iters),
               kmedoids_points_case(torch, flush, peaks,
                                    "20-frame segments, K = 392", points,
                                    392, iters),
               kmedoids_points_case(
                   torch, flush, peaks, "12-frame segments, K = N",
                   cluster_segments(x, SEG20_FRAMES, SEG20_FRAMES // 12)[:8],
                   12 * 196, iters),
               kmedoids_points_case(torch, flush, peaks,
                                    "a segment cut to N = 3137",
                                    points[:1, :3137].contiguous(), K, iters),
               # the scratch variant, which no path runs since the cluster
               # one, held and timed on the step's tokens
               kmedoids_points_case(torch, flush, peaks,
                                    "20-frame segments, step, scratch "
                                    "variant", points, K, iters,
                                    variant=kc.SCRATCH)]
    del x, points
    torch.cuda.empty_cache()
    shapes = [r["shape"][:2] for r in km_rows]
    if shapes != [[SEG20_BATCH * SEG20_SEGMENTS, N],
                  [SEG20_ENCODE_CLIPS * SEG20_SEGMENTS, N],
                  [SEG20_BATCH * SEG20_SEGMENTS, N], [8, 2352], [1, 3137],
                  [SEG20_BATCH * SEG20_SEGMENTS, N]] \
            or [r["variant"] for r in km_rows] != [kc.CLUSTER] * 5 + [
                kc.SCRATCH]:
        fail(f"20-frame segments: E held at {shapes}, "
             f"{[r['variant'] for r in km_rows]}")
    return out, dict(paths=paths, kmedoids=km_rows)


class ScalarLog:
    """Stands in for a Trainer's metric writer: keeps every logged step's
    scalars (n_display 1: every step)."""

    def __init__(self):
        self.rows = []

    def log(self, scalars, step):
        self.rows.append(dict(scalars, step=step))


def timed_steps(torch, np, trainer, batch, warmup, timed, label):
    """`warmup` + `timed` Trainer steps on one host batch, each timed on
    the host clock ending in a device sync; fails on a loss that is not
    finite.  Returns (median ms of the timed steps, every step's ms, every
    step's loss, every step's logged scalars)."""
    log = ScalarLog()
    trainer.metric_writer = log
    step_s, losses = [], []
    for _ in range(warmup + timed):
        t0 = time.time()
        loss, gstep = trainer.train_epoch(0, [batch], n_display=1)
        torch.cuda.synchronize()
        step_s.append(time.time() - t0)
        losses.append(loss)
        if not np.isfinite(loss):
            fail(f"{label}: training loss {loss} at step {gstep} is not "
                 f"finite")
    timed_s = sorted(step_s[warmup:])
    return timed_s[len(timed_s) // 2] * 1e3, [x * 1e3 for x in step_s], \
        losses, log.rows


def resumed_step(torch, run, model, trainer, batch, total_steps, label):
    """Checkpoint `trainer`'s state after epoch 0, resume it into a fresh
    model and Trainer (seed 1), take one more step from each on `batch`
    and fail unless the two models are equal to the bit.  Returns the
    seconds the save and resume took."""
    import tempfile
    from centerclip_tpu_torch.models.clip4clip import CLIP4Clip
    from centerclip_tpu_torch.ops import _build
    from centerclip_tpu_torch.train import Trainer, resume, save_checkpoint
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        t0 = time.time()
        path = save_checkpoint(tmp, trainer.state, epoch=0, best_r1=0.0)
        other = CLIP4Clip(run.model, device=model.device, seed=1)
        trainer2 = Trainer(run, other, total_steps=total_steps)
        _, epoch, _ = resume(path, trainer2.state)
        t_ckpt = time.time() - t0
    # ckpt of epoch 0: the resumed run starts at epoch 1
    if trainer2.state.global_step != trainer.state.global_step or epoch != 1:
        fail(f"the {label} resume did not restore the step counters")
    trainer.train_epoch(1, [batch], n_display=1)
    trainer2.train_epoch(1, [batch], n_display=1)
    other_sd = other.state_dict()
    diff = [k for k, v in model.state_dict().items()
            if not torch.equal(v, other_sd[k])]
    print(f"{label}: checkpoint save + resume {t_ckpt:.2f} s; one more "
          f"step from the trained and the resumed state: {len(diff)} of "
          f"{len(other_sd)} tensors differ")
    if diff:
        fail(f"the {label} resumed step differs: {diff[:5]}")
    return t_ckpt


def seeded_batch(np, g, B, frames, words):
    """A host training batch of B seeded uint8 clips of `frames` frames and
    B seeded token rows of `words`."""
    ids, amask = token_rows(np, g, B, words)
    return {"input_ids": ids, "attention_mask": amask,
            "video": g.integers(0, 256, (B, 1, frames, 3, RES, RES),
                                dtype=np.uint8),
            "video_mask": np.ones((B, frames), np.int32)}


def cluster_module(model):
    """The first block's cluster module of a model's vision tower."""
    return next(b.tokencluster_inter
                for b in model.clip.visual.transformer.resblocks
                if b.tokencluster_inter is not None)


def first_input_hook(module, store):
    """Keep a copy of the first input `module` takes in `store["x"]` (the
    hook returns None: a returned value would replace the input)."""
    def capture(_, args):
        store.setdefault("x", args[0].detach().clone())
    return module.register_forward_pre_hook(capture)


def cosines(a, b):
    import numpy as np
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1)
                              * np.linalg.norm(b, axis=-1))


def path_counts_of(counters, path, backward):
    """(launches by kernel, attention's launches by variant) since the
    counts were zeroed, on a ViT-B/32 path: see attention_variant_counts."""
    return ({fn.__name__: fn.launches for fn in counters},
            attention_variant_counts(path, backward))


def baseline_flags(algo):
    """Experiment 62's flags with `--cluster_algo <algo>`; `deep_cluster`
    with `--deep_cluster 1 --cluster_inter 0` on the same block plans."""
    if algo == "deep_cluster":
        return exp62_flags(cluster_inter="0", deep_cluster="1")
    return exp62_flags(cluster_algo=algo)


@contextlib.contextmanager
def spectral_spans(torch, spans):
    """While active, CUDA events around every `batch_spectral_clustering`
    call and every eigensolve inside one (`spectral.eigenpairs`), appended
    to spans["clustering"] and spans["eigensolve"] as (start, end) pairs:
    the stream's time in each part of the same calls, the host's waits
    inside them included."""
    from centerclip_tpu_torch.ops import spectral

    def timed(name, fn):
        def wrapper(*args, **kwargs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kwargs)
            end.record()
            spans.setdefault(name, []).append((start, end))
            return out
        return wrapper
    saved = spectral.batch_spectral_clustering, spectral.eigenpairs
    spectral.batch_spectral_clustering = timed("clustering", saved[0])
    spectral.eigenpairs = timed("eigensolve", saved[1])
    try:
        yield spans
    finally:
        spectral.batch_spectral_clustering, spectral.eigenpairs = saved


def spans_ms(pairs):
    return [start.elapsed_time(end) for start, end in pairs]


def spectral_call_ms(torch, fn, flush, iters=3, warmup=1):
    """(ms of one call of `fn`, ms of the eigensolve inside that call), by
    CUDA events in the same calls (`spectral_spans`), means over `iters`
    calls, each after an L2 flush and behind a sleep kernel (`time_ms`)."""
    for _ in range(warmup):
        fn()
    whole = eig = 0.0
    for _ in range(iters):
        flush.zero_()
        spans = {}
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        with spectral_spans(torch, spans):
            start.record()
            fn()
            end.record()
        end.synchronize()
        whole += start.elapsed_time(end)
        eig += sum(spans_ms(spans["eigensolve"]))
    return whole / iters, eig / iters


def set_spectral_solver(model, solver):
    """Switch every cluster module of `model` to the spectral `solver`."""
    import dataclasses
    for block in model.clip.visual.transformer.resblocks:
        inter = block.tokencluster_inter
        if inter is not None:
            inter.cfg = dataclasses.replace(inter.cfg, spectral_solver=solver)


def cluster_phase(torch, np, dev, flush, peaks, counters):
    """The sixth main path: the preset lsmdc_vitb32_spectral6 (spectral
    clustering on a KNN graph, 12 -> 6 frames before block 7, K = 49), its
    random vision weights' residual stream scaled
    (`profile_train.scale_vision_stream`) so that the tokens
    it clusters lie a median SPECTRAL_MEDIAN_SIGMAS sigma apart, encoding 64
    clips and training at batch 128 with each solver; the clustering and
    its eigensolve timed by CUDA events inside the same calls, in the steps
    and alone; kernel E held on the spectral embeddings recorded at its
    call site; the card against the CPU (L_sym's eigenvalues; the embedding
    with the card's medoid ids replayed); then the other algorithms at
    experiment 62's flags, each a few training steps and a 2-clip encode
    against the CPU."""
    from centerclip_tpu_torch import cli
    from centerclip_tpu_torch.config import preset
    from centerclip_tpu_torch.models.clip4clip import CLIP4Clip
    from centerclip_tpu_torch.ops import kmedoids_cuda as kc, spectral
    from centerclip_tpu_torch.ops.cluster_layer import segment_major
    from centerclip_tpu_torch.profile_train import scale_vision_stream
    from centerclip_tpu_torch.serve import RetrievalEngine
    from centerclip_tpu_torch.train import Trainer
    run = preset(CLUSTER_PRESET)
    B, cfg = run.batch_size, run.model
    cl = cfg.cluster
    spec = next(s for s in cfg.cluster_plan() if s is not None)
    N, K = spec.frame_duration * spec.before_cluster_num, spec.cluster_num
    if spec.algo != "spectral" or (N, K) != (98, 49) \
            or kc.choose_variant(N) != kc.SHARED \
            or cl.spectral_solver != "eigh":
        fail(f"{CLUSTER_PRESET} clusters N={N}, K={K} by {spec.algo} "
             f"({cl.spectral_solver})")
    sites = ((spectral, "kmedoids", "kmedoids",
              lambda x, *_: tuple(x.shape)),)
    graph = (cl.spectral_sigma, cl.spectral_graph, spec.spectral_knn_k)
    paths = {}

    def segments(x):
        Bc = x.shape[0] // spec.before_frames
        return segment_major(x[:, 1:, :].reshape(
            Bc, spec.before_frames, -1, x.shape[-1]), spec.after_frames,
            spec.frame_duration).float()

    def median_sigmas(x):
        res = segments(x)
        return (torch.cdist(res, res).median() / cl.spectral_sigma).item()

    # ---- the stream's scale, then an encode of 64 clips in batches of 32
    t0 = time.time()
    model = CLIP4Clip(cfg, device=dev, seed=0).eval()
    engine = RetrievalEngine(model, device=dev)
    g = np.random.default_rng(21)
    clips = g.integers(0, 256, (N_CLIPS, 1, FRAMES, 3, RES, RES),
                       dtype=np.uint8)
    masks = np.ones((N_CLIPS, FRAMES), np.int32)
    ids = [f"spclip{i:03d}" for i in range(N_CLIPS)]

    def batches(lo=0, hi=N_CLIPS):
        for s in range(lo, hi, BATCH):
            yield {"video": clips[s:min(s + BATCH, hi)],
                   "video_mask": masks[s:min(s + BATCH, hi)]}
    probe = {}
    hook = first_input_hook(cluster_module(model), probe)
    engine.build_index(batches(0, 2), ids[:2], quantize="int8")  # warm-up
    hook.remove()
    seed_sigmas = median_sigmas(probe.pop("x"))
    alpha = SPECTRAL_MEDIAN_SIGMAS / seed_sigmas
    scale_vision_stream(model, alpha)
    torch.cuda.synchronize()
    t_setup = time.time() - t0
    enc_x, seen, enc_spans = {}, {}, {}
    hook = first_input_hook(cluster_module(model), enc_x)
    zero_counts(counters)
    t0 = time.time()
    with recording_kernel_inputs(torch, seen, sites=sites), \
            spectral_spans(torch, enc_spans):
        index = engine.build_index(batches(), ids, quantize="int8")
        torch.cuda.synchronize()
    t_build = time.time() - t0
    hook.remove()
    paths["spectral_encode"] = path_counts_of(counters, "spectral encode",
                                              backward=False)
    if not paths["spectral_encode"][0]["kmedoids_from_distances"]:
        fail("the spectral encode never launched k-medoids")
    gallery = index._codes[:N_CLIPS].float() * index._scales[:N_CLIPS]
    if tuple(gallery.shape) != (N_CLIPS, 512) or \
            not bool(torch.isfinite(gallery).all()):
        fail("the spectral gallery is not finite [64, 512]")
    enc_clu = sum(spans_ms(enc_spans["clustering"]))
    enc_eig = sum(spans_ms(enc_spans["eigensolve"]))
    print(f"cluster [{CLUSTER_PRESET}] the random weights put the tokens "
          f"block 7's cluster layer takes a median {seed_sigmas:.3f} sigma "
          f"apart (sigma {cl.spectral_sigma}): vision residual stream scaled "
          f"by {alpha:.6f} to {SPECTRAL_MEDIAN_SIGMAS} sigma")
    print(f"cluster [{CLUSTER_PRESET}] encode: {N_CLIPS} clips in "
          f"{t_build:.3f} s = {N_CLIPS / t_build:.2f} clips/s (batches of "
          f"{BATCH}; set-up and warm-up {t_setup:.2f} s), spectral "
          f"clustering {enc_clu:.3f} ms of it ({enc_clu / t_build / 1e3:.1%}),"
          f" eigensolve {enc_eig:.3f} ms; launches "
          f"{paths['spectral_encode'][0]}")

    # ---- card against CPU: L_sym's eigenvalues on the first encode
    # batch's tokens; the embedding of 2 clips with the card's medoid ids
    # replayed on the CPU
    t0 = time.time()
    res = segments(enc_x["x"])
    enc_sigmas = (torch.cdist(res, res).median() / cl.spectral_sigma).item()
    W = spectral.construct_affinity(res, res, sigma=cl.spectral_sigma)
    off_diag = ((W > 0).sum() - W.shape[0] * N).item() / (
        W.shape[0] * N * (N - 1))
    L_card = spectral.normalized_laplacian(res, *graph)
    ev_card = torch.linalg.eigvalsh(L_card)
    ev_sub, vec_sub = spectral.eigenpairs(L_card, K, "subspace")
    if not (L_card.is_cuda and ev_card.is_cuda and ev_sub.is_cuda):
        fail("the spectral eigensolve did not run on the card")
    sub_err = (ev_sub - ev_card[:, :K]).abs().max().item()
    sub_res = torch.linalg.vector_norm(
        L_card @ vec_sub - vec_sub * ev_sub[:, None, :], dim=1).max().item()
    ev_cpu = torch.linalg.eigvalsh(spectral.normalized_laplacian(
        res.cpu(), *graph))
    eig_err = (ev_card.cpu() - ev_cpu).abs().max().item()
    gap = (ev_cpu[:, K] - ev_cpu[:, K - 1]).min().item()
    ev_max = ev_cpu.max().item()
    del W, L_card, vec_sub
    mod = cluster_module(model)
    chosen, differing = [], [0, 0]

    def record(res_tmp, own=mod._cluster):
        out = own(res_tmp)
        chosen.append(tuple(a.cpu() for a in out))
        return out
    mod._cluster = record
    card_video = engine.embed_video_batches(batches(0, 2))
    del mod._cluster
    torch.set_num_threads(os.cpu_count() or 1)
    cpu_model = CLIP4Clip(cfg, device="cpu", seed=1).eval()
    cpu_model.load_state_dict({k: v.cpu() for k, v in
                               model.state_dict().items()}, strict=True)
    cpu_mod = cluster_module(cpu_model)

    def replay(res_tmp, own=cpu_mod._cluster):
        mine = own(res_tmp)[1]
        differing[0] += int((mine != chosen[0][1]).any(dim=1).sum())
        differing[1] += mine.shape[0]
        return chosen[0]
    cpu_mod._cluster = replay
    cpu_video = RetrievalEngine(cpu_model, device="cpu").embed_video_batches(
        batches(0, 2))
    cos_v = cosines(card_video, cpu_video)
    print(f"cluster [{CLUSTER_PRESET}] card vs CPU ({time.time() - t0:.1f} "
          f"s) on {tuple(res.shape)} tokens a median {enc_sigmas:.3f} sigma "
          f"apart: share of nonzero heat-kernel affinities off the diagonal "
          f"{off_diag:.4f}; L_sym eigenvalues max |err| {eig_err:.3e} (tol "
          f"{EIGVAL_ATOL}), smallest gap between eigenvalues {K} and "
          f"{K + 1} {gap:.3e}, largest eigenvalue {ev_max:.4f}; the "
          f"subspace solver's {K} eigenvalues against eigh's on the card: "
          f"max |diff| {sub_err:.3e}, largest residual |L v - lambda v| "
          f"{sub_res:.3e}; video cosine with the card's medoid ids replayed "
          f"{np.round(cos_v, 6).tolist()} (min {VIDEO_MIN_COS}); segments "
          f"where the CPU's own medoids differ {differing[0]}/{differing[1]}")
    if not off_diag > 0 or not ev_max > 1:
        fail("the spectral path clustered tokens out of the heat kernel's "
             "reach (W = I, L_sym = 0)")
    if not eig_err <= EIGVAL_ATOL:
        fail("card and CPU eigenvalues of L_sym disagree")
    if cos_v.min() < VIDEO_MIN_COS:
        fail("card and CPU spectral embeddings disagree")
    del engine, index, gallery, model, cpu_model, cpu_mod, mod
    torch.cuda.empty_cache()

    # ---- training at batch 128 with each solver; the clustering and its
    # eigensolve timed inside the steps
    t0 = time.time()
    model = CLIP4Clip(cfg, device=dev, seed=0)
    scale_vision_stream(model, alpha)
    steps = {"eigh": (CLUSTER_WARMUP_STEPS, CLUSTER_TIMED_STEPS),
             "subspace": (1, CLUSTER_TIMED_STEPS)}
    trainer = Trainer(run, model, total_steps=sum(map(sum, steps.values())))
    batch = seeded_batch(np, np.random.default_rng(22), B, FRAMES,
                         cfg.max_words)
    t_setup = time.time() - t0
    train_x, step_rows = {}, {}
    hook = first_input_hook(cluster_module(model), train_x)
    for solver in spectral.SOLVERS:
        warm, timed = steps[solver]
        set_spectral_solver(model, solver)
        spans = {}
        zero_counts(counters)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with recording_kernel_inputs(torch, seen, sites=sites), \
                spectral_spans(torch, spans):
            med, step_ms, _, _ = timed_steps(torch, np, trainer, batch,
                                             warm, timed, CLUSTER_PRESET)
        peak = torch.cuda.max_memory_allocated()
        launches = path_counts_of(counters, f"spectral training ({solver})",
                                  backward=True)
        if solver == cl.spectral_solver:
            hook.remove()
            paths["spectral_training"] = launches
        launches = launches[0]
        if len(spans["clustering"]) != warm + timed:
            fail(f"{len(spans['clustering'])} spectral clusterings in "
                 f"{warm + timed} steps")
        step_sum = sum(step_ms[warm:])
        clu = sum(spans_ms(spans["clustering"][warm:]))
        eig = sum(spans_ms(spans["eigensolve"][warm:]))
        step_rows[solver] = dict(
            step_ms=med, clips_per_s=B / med * 1e3, step_ms_all=step_ms,
            peak_memory_bytes=peak, clustering_ms=clu / timed,
            eigensolve_ms=eig / timed, clustering_share_of_step=clu / step_sum,
            eigensolve_share_of_step=eig / step_sum,
            eigensolve_share_of_clustering=eig / clu)
        print(f"cluster [{CLUSTER_PRESET}] training, {solver} (batch {B}, "
              f"set-up {t_setup:.2f} s): step times "
              f"{[round(x, 3) for x in step_ms]} ms; median of the {timed} "
              f"timed {med:.3f} ms = {B / med * 1e3:.2f} clips/s; in the "
              f"timed steps spectral clustering {clu / timed:.3f} ms a step "
              f"({clu / step_sum:.1%} of the step), its eigensolve "
              f"{eig / timed:.3f} ms ({eig / step_sum:.1%} of the step, "
              f"{eig / clu:.1%} of the clustering); peak memory allocated "
              f"{peak / 2**30:.3f} GiB; launches {launches}")
        for fn_name, n in launches.items():
            if n == 0:
                fail(f"{fn_name} was never launched on the spectral path "
                     f"({solver})")
    del trainer, model, batch
    torch.cuda.empty_cache()

    # ---- the spectral clustering alone, its eigensolve timed inside it
    spectral_rows = []
    for label, x in (("training", train_x.pop("x")),
                     ("encode", enc_x.pop("x"))):
        res = segments(x)
        for solver in spectral.SOLVERS:
            full_ms, eig_ms = spectral_call_ms(
                torch, lambda: spectral.batch_spectral_clustering(
                    res, K, mode=cl.spectral_graph,
                    knn_k=spec.spectral_knn_k, metric=cl.distance,
                    iter_limit=cl.iter_limit, id_sort=cl.id_sort,
                    correct_sign=cl.svd_correct_sign,
                    sigma=cl.spectral_sigma, solver=solver), flush)
            spectral_rows.append(dict(
                shape=[res.shape[0], N, N], path=label, solver=solver,
                clustering_ms=full_ms, eigensolve_ms=eig_ms,
                eigensolve_share=eig_ms / full_ms))
            print(f"spectral [{label}] L_sym {(res.shape[0], N, N)} {solver}"
                  f" alone: clustering {full_ms:.3f} ms, eigensolve inside "
                  f"it {eig_ms:.3f} ms ({eig_ms / full_ms:.1%})")
        del res

    # ---- kernel E on the spectral embeddings recorded at its call site
    km_rows = [kmedoids_points_case(torch, flush, peaks,
                                    f"spectral embedding {key}", args[0],
                                    args[1], kw.get("iter_limit",
                                                    cl.iter_limit))
               for (_, key), (args, kw) in seen.items()]
    seen.clear()
    eigh_row = step_rows[cl.spectral_solver]
    result = dict(preset=CLUSTER_PRESET, batch=B, step_ms=eigh_row["step_ms"],
                  clips_per_s=eigh_row["clips_per_s"],
                  step_ms_all=eigh_row["step_ms_all"],
                  peak_memory_bytes=eigh_row["peak_memory_bytes"],
                  steps_by_solver=step_rows, stream_scale=alpha,
                  seed_median_sigmas=seed_sigmas, median_sigmas=enc_sigmas,
                  encode_clips=N_CLIPS, encode_s=t_build,
                  encode_clips_per_s=N_CLIPS / t_build,
                  encode_clustering_ms=enc_clu, encode_eigensolve_ms=enc_eig,
                  eigenvalue_max_abs_err=eig_err, eigen_gap_min=gap,
                  eigenvalue_max=ev_max, subspace_vs_eigh_max_abs=sub_err,
                  subspace_residual_max=sub_res,
                  affinity_offdiag_nonzero=off_diag,
                  video_cos_min=float(cos_v.min()),
                  spectral=spectral_rows, baselines={})

    # ---- the other algorithms at experiment 62's block flags
    for algo in BASELINE_ALGOS:
        t0 = time.time()
        brun = cli.parse_args(baseline_flags(algo))
        model = CLIP4Clip(brun.model, device=dev, seed=0)
        trainer = Trainer(brun, model, total_steps=BASELINE_WARMUP_STEPS
                          + BASELINE_TIMED_STEPS)
        batch = seeded_batch(np, np.random.default_rng(23),
                             brun.batch_size, FRAMES, brun.model.max_words)
        t_setup = time.time() - t0
        zero_counts(counters)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        bmed, bms, _, rows = timed_steps(torch, np, trainer, batch,
                                         BASELINE_WARMUP_STEPS,
                                         BASELINE_TIMED_STEPS, algo)
        bpeak = torch.cuda.max_memory_allocated()
        paths[f"{algo}_training"] = path_counts_of(
            counters, f"{algo} training", backward=True)
        launches = paths[f"{algo}_training"][0]
        closs = [r["train/cluster_loss"] for r in rows]
        for fn_name, n in launches.items():
            if (n == 0) != (fn_name == "kmedoids_from_distances"):
                fail(f"{algo} training launched {fn_name} {n} times")
        if not all(np.isfinite(closs)) or \
                any((c > 0) != (algo == "deep_cluster") for c in closs):
            fail(f"{algo}: cluster losses {closs}")
        del trainer
        t1 = time.time()
        two = {k: batch[k][:2] for k in ("video", "video_mask")}
        card_video = RetrievalEngine(model.eval(), device=dev) \
            .embed_video_batches([two])
        cpu_model = CLIP4Clip(brun.model, device="cpu", seed=1).eval()
        cpu_model.load_state_dict({k: v.cpu() for k, v in
                                   model.state_dict().items()}, strict=True)
        cpu_video = RetrievalEngine(cpu_model, device="cpu") \
            .embed_video_batches([two])
        cos = cosines(card_video, cpu_video)
        print(f"cluster [{algo}] (set-up {t_setup:.2f} s): step times "
              f"{[round(x, 3) for x in bms]} ms, median of the "
              f"{BASELINE_TIMED_STEPS} timed {bmed:.3f} ms = "
              f"{brun.batch_size / bmed * 1e3:.2f} clips/s, peak memory "
              f"allocated {bpeak / 2**30:.3f} GiB, cluster losses "
              f"{[round(c, 4) for c in closs]}, launches {launches}; "
              f"2-clip encode card vs CPU ({time.time() - t1:.1f} s) "
              f"cosine {np.round(cos, 6).tolist()} (min {VIDEO_MIN_COS})")
        if cos.min() < VIDEO_MIN_COS:
            fail(f"card and CPU {algo} embeddings disagree")
        result["baselines"][algo] = dict(
            step_ms=bmed, clips_per_s=brun.batch_size / bmed * 1e3,
            step_ms_all=bms, peak_memory_bytes=bpeak, cluster_losses=closs,
            video_cos_min=float(cos.min()))
        del model, cpu_model, batch
        torch.cuda.empty_cache()
    return result, dict(paths=paths, kmedoids=km_rows)


def activity_phase(torch, np, dev, flush, peaks, counters):
    """The seventh main path: the preset activity_vitb32 at the recipe's
    size (60 frames, 77 words, batch 128; k-medoids of 4 x 49 = 196 tokens
    per segment into K = 49 before block 7, 60 -> 15 frames), training
    steps through `Trainer` and an encode of 64 clips pooled by
    `pre_visual_pooling` (`CLIP4Clip.forward`); then A and B at the
    vision blocks' and the text tower's shapes, C and D at the vision
    rows, E on the tokens the first step and the encode clustered, each
    against its plain version."""
    from centerclip_tpu_torch.config import preset
    from centerclip_tpu_torch.models.clip4clip import CLIP4Clip
    from centerclip_tpu_torch.ops import kmedoids_cuda as kc
    from centerclip_tpu_torch.train import Trainer
    run = preset(ACTIVITY_PRESET, remat=ACTIVITY_REMAT)
    B, cfg = run.batch_size, run.model
    T, L_text = cfg.max_frames, cfg.max_words
    spec = next(s for s in cfg.cluster_plan() if s is not None)
    N, K = spec.frame_duration * spec.before_cluster_num, spec.cluster_num
    if (B, T, L_text, N, K) != (128, 60, 77, 196, 49) or \
            kc.choose_variant(N) != kc.SHARED or not cfg.pre_visual_pooling:
        fail(f"{ACTIVITY_PRESET}: batch {B}, {T} frames, {L_text} words, "
             f"N={N}, K={K}")
    paths = {}

    # ---- training at batch 128
    t0 = time.time()
    model = CLIP4Clip(cfg, device=dev, seed=0)
    steps = ACTIVITY_WARMUP_STEPS + ACTIVITY_TIMED_STEPS
    trainer = Trainer(run, model, total_steps=steps)
    batch = seeded_batch(np, np.random.default_rng(60), B, T, L_text)
    t_setup = time.time() - t0
    train_x = {}
    hook = first_input_hook(cluster_module(model), train_x)
    zero_counts(counters)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    med, step_ms, _, _ = timed_steps(torch, np, trainer, batch,
                                     ACTIVITY_WARMUP_STEPS,
                                     ACTIVITY_TIMED_STEPS, ACTIVITY_PRESET)
    hook.remove()
    peak = torch.cuda.max_memory_allocated()
    paths["activity_training"] = path_counts_of(
        counters, "activity training", backward=True)
    launches = paths["activity_training"][0]
    km_variants = dict(kc.kmedoids_from_distances.variant_launches)
    print(f"activity training ({ACTIVITY_PRESET}, batch {B}, {T} frames, "
          f"{L_text} words, remat {'on' if cfg.remat else 'off'}: "
          f"{ACTIVITY_REMAT_WHY}; set-up {t_setup:.2f} s): step times "
          f"{[round(x, 3) for x in step_ms]} ms; median of the "
          f"{ACTIVITY_TIMED_STEPS} timed {med:.3f} ms = "
          f"{B / med * 1e3:.2f} clips/s; peak memory allocated "
          f"{peak / 2**30:.3f} GiB; launches {launches}, k-medoids by "
          f"variant {km_variants}")
    for fn_name, n in launches.items():
        if n == 0:
            fail(f"{fn_name} was never launched on the activity path")
    if km_variants != {kc.SHARED: steps, kc.GLOBAL: 0, kc.CLUSTER: 0,
                       kc.SCRATCH: 0}:
        fail(f"activity k-medoids ran other variants: {km_variants}")
    del trainer, batch
    torch.cuda.empty_cache()

    # ---- encode 64 clips in batches of 32, pooled (pre_visual_pooling)
    model.eval()
    g = np.random.default_rng(61)
    clips = g.integers(0, 256, (N_CLIPS, 1, T, 3, RES, RES), dtype=np.uint8)
    masks = np.ones((N_CLIPS, T), np.int32)
    with torch.inference_mode():                  # warm-up, 2 clips
        model(video=torch.as_tensor(clips[:2]).to(dev),
              video_mask=torch.as_tensor(masks[:2]).to(dev))
    enc_x = {}
    hook = first_input_hook(cluster_module(model), enc_x)
    zero_counts(counters)
    torch.cuda.synchronize()
    t0 = time.time()
    pooled = []
    with torch.inference_mode():
        for s in range(0, N_CLIPS, BATCH):
            pooled.append(model(
                video=torch.as_tensor(clips[s:s + BATCH]).to(dev),
                video_mask=torch.as_tensor(masks[s:s + BATCH]).to(dev)
            )["visual_output"])
        pooled = torch.cat(pooled)
        torch.cuda.synchronize()
    t_enc = time.time() - t0
    hook.remove()
    paths["activity_encode"] = path_counts_of(counters, "activity encode",
                                              backward=False)
    norms = pooled.norm(dim=-1)
    print(f"activity encode: {N_CLIPS} clips of {T} frames in {t_enc:.3f} "
          f"s = {N_CLIPS / t_enc:.2f} clips/s (batches of {BATCH}, "
          f"pooled by pre_visual_pooling to {tuple(pooled.shape)}, norms "
          f"{norms.min().item():.6f}-{norms.max().item():.6f}); launches "
          f"{paths['activity_encode'][0]}")
    if tuple(pooled.shape) != (N_CLIPS, 512) or \
            not bool(torch.isfinite(pooled).all()) or \
            not bool(((norms - 1).abs() < 1e-3).all()):
        fail("the activity encode is not finite, unit [64, 512]")
    if not paths["activity_encode"][0]["kmedoids_from_distances"]:
        fail("the activity encode never launched k-medoids")
    del model, pooled, clips
    torch.cuda.empty_cache()

    # ---- kernels at the activity shapes
    bwd_rows, fwd_rows = [], []
    for case in (("activity vision blocks 1-6", B * T, 50, 12, None),
                 ("activity text", B, L_text, 8, "causal")):
        row, fwd_row = hold_attention_bwd(torch, dev, flush, peaks, *case)
        bwd_rows.append(row)
        fwd_rows.append(fwd_row)
    ln_row, lnf_row = hold_layernorm_bwd(
        torch, dev, flush, peaks, "activity vision ln_1/ln_2, blocks 1-6",
        B * T * 50, 768)
    km_rows = [kmedoids_case(torch, flush, peaks, f"activity {label}",
                             x.pop("x"), T, spec.after_frames, K,
                             cfg.cluster.iter_limit)
               for label, x in (("training", train_x), ("encode", enc_x))]
    result = dict(preset=ACTIVITY_PRESET, batch=B, frames=T, words=L_text,
                  remat=cfg.remat, step_ms=med, clips_per_s=B / med * 1e3,
                  step_ms_all=step_ms, peak_memory_bytes=peak,
                  encode_clips=N_CLIPS, encode_s=t_enc,
                  encode_clips_per_s=N_CLIPS / t_enc)
    return result, dict(paths=paths, attention_bwd=bwd_rows,
                        attention_fwd=fwd_rows, layernorm_bwd=[ln_row],
                        layernorm_fwd=[lnf_row], kmedoids=km_rows)


def write_msrvtt_fixture(np, root):
    """The synthetic MSR-VTT: videos/<id>.npy, videos.fstore (the port's
    FrameStoreWriter), train.csv, test.csv, gallery.csv (GALLERY_ROWS rows
    over the same clips; the csv module) and MSRVTT_data.json.  Returns
    the .fstore's path."""
    import csv
    from centerclip_tpu_torch.data.framestore import FrameStoreWriter
    g = np.random.default_rng(5)
    # zero-padded: the .fstore holds them in the order that
    # preprocess/build_framestore.py reads a folder (names sorted)
    vids = [f"video{i:02d}" for i in range(MAIN_VIDEOS)]
    things = ["a dog", "two cooks", "a red car", "children", "a singer",
              "a cat", "players", "a boat"]
    acts = ["runs on a beach", "cooks pasta, then eats it", "drives at night",
            "play football", "sings on a stage", "sleeps on a sofa",
            "dance in a hall", "sails past a \"lighthouse\""]
    os.makedirs(os.path.join(root, "videos"))
    store = os.path.join(root, "videos.fstore")
    with FrameStoreWriter(store) as w:
        for v in vids:
            frames = g.integers(0, 256, (MAIN_FRAMES, *MAIN_HW, 3),
                                dtype=np.uint8)
            np.save(os.path.join(root, "videos", f"{v}.npy"), frames)
            w.add(v, frames)
    captions = {v: [f"{things[(i + j) % 8]} {acts[(3 * i + j) % 8]}, clip "
                    f"{i} take {j}" for j in range(MAIN_CAPTIONS)]
                for i, v in enumerate(vids)}
    with open(os.path.join(root, "train.csv"), "w", newline="") as f:
        csv.writer(f).writerows([["video_id"]] + [[v] for v in vids])
    with open(os.path.join(root, "test.csv"), "w", newline="") as f:
        csv.writer(f).writerows([["video_id", "sentence"]]
                                + [[v, captions[v][0]] for v in vids])
    # an evaluation gallery of MSR-VTT 1k-A's size: each row one of the
    # clips (in turn) beside one of its captions
    with open(os.path.join(root, "gallery.csv"), "w", newline="") as f:
        csv.writer(f).writerows(
            [["video_id", "sentence"]]
            + [[vids[i % MAIN_VIDEOS], f"{captions[vids[i % MAIN_VIDEOS]][(
                i // MAIN_VIDEOS) % MAIN_CAPTIONS]}, row {i}"]
               for i in range(GALLERY_ROWS)])
    with open(os.path.join(root, "MSRVTT_data.json"), "w") as f:
        json.dump({"sentences": [{"video_id": v, "caption": c}
                                 for v in vids for c in captions[v]],
                   "videos": [{"video_id": v} for v in vids]}, f)
    return store


def main_argv(root, out_dir, extra=(), flags=EXP62_FLAGS):
    """`main`'s argv on the synthetic MSR-VTT in `root` (the .fstore), with
    experiment 62's flags or `flags`."""
    return list(flags) + [
        "--train_csv", os.path.join(root, "train.csv"),
        "--val_csv", os.path.join(root, "test.csv"),
        "--data_path", os.path.join(root, "MSRVTT_data.json"),
        "--pretrained_dir", os.path.join(root, "pretrained"),
        "--features_path", os.path.join(root, "videos.fstore"),
        "--output_dir", out_dir, "--epochs", "1", "--n_display", "1",
        *extra]


def copy_ms(torch, host, dev):
    """CUDA-event time of one host-to-device copy of `host` (mean of 3)."""
    host.to(dev, non_blocking=True)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        host.to(dev, non_blocking=True)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 3


def kernel_call_sites():
    """The model's call sites of kernels A, C and E: (module, attribute,
    kernel row, the key under which the first input of a shape is kept)."""
    from centerclip_tpu_torch.models import layers
    from centerclip_tpu_torch.ops import cluster_layer
    return ((layers, "fused_attention", "attention_fwd",
             lambda qkv, heads, mask=None: (tuple(qkv.shape), mask is None)),
            (layers, "layer_norm", "layernorm_fwd",
             lambda x, *_: (tuple(x.shape), x.dtype)),
            (cluster_layer, "kmedoids", "kmedoids",
             lambda x, *_: tuple(x.shape)))


@contextlib.contextmanager
def recording_kernel_inputs(torch, seen, active=lambda: True, sites=None):
    """Within the block, keep in `seen` a copy of the first input of each
    shape that kernels A, C and E take at the model's call sites (or at
    `sites`, entries as `kernel_call_sites` gives them), while `active()`
    holds.  The copies are made on first sight only."""
    sites = kernel_call_sites() if sites is None else sites
    originals = [(mod, attr, getattr(mod, attr)) for mod, attr, _, _ in sites]

    def recording(fn, kernel, key_of):
        def record(*args, **kw):
            key = (kernel, key_of(*args))
            if active() and key not in seen:
                seen[key] = ([a.detach().clone() if torch.is_tensor(a)
                              else a for a in args], kw)
            return fn(*args, **kw)
        return record
    for mod, attr, kernel, key_of in sites:
        setattr(mod, attr, recording(getattr(mod, attr), kernel, key_of))
    try:
        yield seen
    finally:
        for mod, attr, fn in originals:
            setattr(mod, attr, fn)


def hold_recorded(torch, seen, label, what,
                  kernels=("attention_fwd", "layernorm_fwd", "kmedoids")):
    """Kernels A, C and E against their plain versions on the inputs
    `recording_kernel_inputs` kept, with the kernel phase's tolerances;
    rows by kernel.  With "attention_bwd" and "layernorm_bwd" in
    `kernels`, kernels B and D too, on the same inputs with a seeded
    output gradient (a training step runs each backward at its
    forward's shapes).  Fails if one of `kernels` got no input in
    `what`."""
    from centerclip_tpu_torch.ops import attention_cuda, layernorm_triton
    held = {kernel: [] for kernel in kernels}
    for n, ((kernel, key), (args, kw)) in enumerate(seen.items()):
        case = f"{label} {tuple(args[0].shape)}"
        gen = torch.Generator(device=args[0].device).manual_seed(n)
        if kernel == "attention_fwd":
            qkv, H, mask = (list(args) + [None])[:3]
            err = hold_close(torch, f"attention [{case}]",
                             attention_cuda.fused_attention(qkv, H, mask),
                             attention_cuda.attention_plain(qkv, H, mask),
                             BF16_ATOL, BF16_RTOL)
            row = dict(shape=list(qkv.shape), max_abs_err=err)
            if "attention_bwd" in held:
                dout = torch.randn((*qkv.shape[:-1], qkv.shape[-1] // 3),
                                   generator=gen, device=qkv.device).to(
                                       qkv.dtype)
                err = hold_close(
                    torch, f"attention bwd [{case}]",
                    attention_cuda.attention_backward(qkv, dout, H, mask)[0],
                    attention_cuda.attention_bwd_plain(qkv, dout, H, mask)[0],
                    BF16_ATOL, BF16_RTOL)
                print(f"attention_bwd [{case}]: max_abs_err {err:.3e}")
                held["attention_bwd"].append(dict(shape=list(qkv.shape),
                                                  max_abs_err=err))
        elif kernel == "layernorm_fwd":
            x = args[0]
            atol, rtol = ((BF16_ATOL, BF16_RTOL)
                          if x.dtype == torch.bfloat16
                          else (FP32_ATOL, FP32_RTOL))
            err = hold_close(torch, f"layernorm [{case}]",
                             layernorm_triton.layer_norm(*args),
                             layernorm_triton.layer_norm_plain(*args),
                             atol, rtol)
            dtype = str(x.dtype).split(".")[-1]
            row = dict(shape=list(x.shape), dtype=dtype, max_abs_err=err)
            if "layernorm_bwd" in held:
                dy = torch.randn(x.shape, generator=gen,
                                 device=x.device).to(x.dtype)
                _, err_x, err_wb = held_layernorm_bwd(torch, case, x,
                                                      args[1], dy)
                print(f"layernorm_bwd [{case}]: dx max_abs_err "
                      f"{err_x:.3e}, dgamma/dbeta {err_wb:.3e}")
                held["layernorm_bwd"].append(dict(
                    shape=list(x.shape), dtype=dtype,
                    max_abs_err=max(err_x, err_wb)))
        else:
            row, _ = hold_kmedoids(torch, case, *args, **kw)
        if kernel != "kmedoids":
            print(f"{kernel} [{case}]: max_abs_err "
                  f"{row['max_abs_err']:.3e}")
        held[kernel].append(row)
    for kernel, rows in held.items():
        if not rows:
            fail(f"{what} gave {kernel} no input")
    return held


def main_phase(torch, np, dev, counters, root):
    """The third main path: `centerclip_tpu_torch.main.main` on the
    synthetic MSR-VTT written into `root` (run 1: train + evaluate; run 2:
    eval-only reload), and the host-side check of the two loaders.  The
    fixture, run 1's checkpoint and its evaluation's similarity matrix stay
    for the serve phase (`handoff`)."""
    from centerclip_tpu_torch import cli
    from centerclip_tpu_torch.data.registry import DATALOADER_DICT
    from centerclip_tpu_torch.main import main as run_main
    from centerclip_tpu_torch.models.tokenizer import SimpleTokenizer
    from centerclip_tpu_torch.train import evaluate, loop
    t0 = time.time()
    store = write_msrvtt_fixture(np, root)
    t_fixture = time.time() - t0
    paths = ["--train_csv", os.path.join(root, "train.csv"),
             "--val_csv", os.path.join(root, "test.csv"),
             "--data_path", os.path.join(root, "MSRVTT_data.json"),
             "--pretrained_dir", os.path.join(root, "pretrained")]
    argv = EXP62_FLAGS + paths + [
        "--features_path", store, "--output_dir",
        os.path.join(root, "out"), "--epochs", "1", "--n_display", "1"]

    # what the run hands the model and the evaluator, recorded
    evals, pinned = [], []
    evaluate_fn, to_device = evaluate.Evaluator.evaluate, \
        loop.batch_to_device

    def recording_evaluate(self, *a, **k):
        t = time.time()
        in_eval[0] = True
        try:
            res = evaluate_fn(self, *a, **k)
        finally:
            in_eval[0] = False
        evals.append((res, time.time() - t))
        return res

    def recording_to_device(batch, device):
        pinned.append(all(torch.as_tensor(v).is_pinned()
                          for v in batch.values()))
        return to_device(batch, device)

    # the first input of each shape that kernels A, C and E take in an
    # evaluation (the model's call sites; the ragged batch's shapes are
    # not the kernel phase's), held against the plain versions after the
    # runs.  The training steps' shapes are the training phase's, held
    # there; recording them too would add the copies to the peak memory.
    seen, in_eval = {}, [False]
    evaluate.Evaluator.evaluate = recording_evaluate
    loop.batch_to_device = recording_to_device
    try:
        with recording_kernel_inputs(torch, seen, lambda: in_eval[0]):
            zero_counts(counters)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.time()
            best_r1 = run_main(argv)
            torch.cuda.synchronize()
            t_run1 = time.time() - t0
            launches = {fn.__name__: fn.launches for fn in counters}
            variants = attention_variant_counts("main", backward=True)
            peak = torch.cuda.max_memory_allocated()
            t0 = time.time()
            res2 = run_main(argv + [
                "--do_train", "0", "--output_dir", os.path.join(root, "eval"),
                "--init_model", os.path.join(root, "out", "ckpt.pth.tar")])
            t_run2 = time.time() - t0
    finally:
        evaluate.Evaluator.evaluate = evaluate_fn
        loop.batch_to_device = to_device
    with open(os.path.join(root, "out", "tensorboard",
                           "scalars.jsonl")) as f:
        scalars = [json.loads(line) for line in f]
    out_files = sorted(os.listdir(os.path.join(root, "out")))

    # kernels A, C and E against their plain versions on the inputs the
    # evaluation gave them (these launches come after the counts were
    # read)
    held = hold_recorded(torch, seen, "main evaluation", "the main run's "
                         "evaluation")
    del seen

    # host side: the first eval batch of the .npy and the .fstore loader
    tok = SimpleTokenizer()
    first, t_first = {}, {}
    for kind, extra in (("npy", ["--features_path",
                                 os.path.join(root, "videos"),
                                 "--video_suffix", ".npy"]),
                        ("fstore", ["--features_path", store])):
        cfg = cli.parse_args(EXP62_FLAGS + paths + extra + [
            "--output_dir", os.path.join(root, "unused")])
        t0 = time.time()
        loader, _ = DATALOADER_DICT["msrvtt"]["val"](cfg, tok,
                                                     device=dev)
        first[kind] = next(iter(loader))
        t_first[kind] = time.time() - t0
    same_first = sorted(first["npy"]) == sorted(first["fstore"]) and all(
        torch.equal(torch.as_tensor(first["npy"][k]),
                    torch.as_tensor(first["fstore"][k]))
        for k in first["npy"])
    video = torch.as_tensor(first["fstore"]["video"])
    train_video = torch.empty((MAIN_BATCH, *video.shape[1:]),
                              dtype=video.dtype, pin_memory=True)
    pageable = torch.empty(train_video.shape, dtype=video.dtype)
    video_shape = video.shape[2:]
    if not train_video.is_pinned() or pageable.is_pinned():
        fail("the copy buffers are not pinned and pageable")
    h2d_pinned = copy_ms(torch, train_video, dev)
    h2d_pageable = copy_ms(torch, pageable, dev)
    del first, video, train_video, pageable

    res1, t_eval = evals[0]
    steps = [r["train/batch_time"] for r in scalars]
    losses = [r["train/sim_loss"] for r in scalars]
    med = sorted(steps)[len(steps) // 2]
    data_mean = sum(r["train/data_time"] for r in scalars) / len(scalars)
    print(f"main phase: fixture {t_fixture:.2f} s; run 1 (train + eval) "
          f"{t_run1:.2f} s, {len(steps)} steps, losses {losses}, step times "
          f"{[round(x * 1e3, 3) for x in steps]} ms (Batch (t), ends in a "
          f"read back), Data (t) "
          f"{[round(r['train/data_time'] * 1e3, 3) for r in scalars]} ms; "
          f"batches pinned {pinned}; evaluation of {MAIN_VIDEOS} clips "
          f"{t_eval:.3f} s, R@1 {res1['R1']}; peak memory "
          f"{peak / 2**30:.3f} GiB; run 2 (eval-only reload) {t_run2:.2f} s, "
          f"R@1 {res2['R1']}; files {out_files}")
    print(f"launches during main run 1: {launches}")
    print(f"first eval batch: .npy loader {t_first['npy']:.3f} s, .fstore "
          f"loader {t_first['fstore']:.3f} s, equal to the byte: "
          f"{same_first}; host-to-device copy of one training batch's "
          f"frames ({MAIN_BATCH} x {tuple(video_shape)} uint8): pinned "
          f"{h2d_pinned:.3f} ms, pageable {h2d_pageable:.3f} ms")
    for fn_name, n in launches.items():
        if n == 0:
            fail(f"{fn_name} was never launched on the main path")
    n_steps = MAIN_VIDEOS * MAIN_CAPTIONS // MAIN_BATCH
    if len(steps) != n_steps or not np.isfinite(losses).all():
        fail(f"main run 1 took {len(steps)} steps with losses {losses}")
    if not all(pinned) or len(pinned) != n_steps:
        fail(f"the training batches did not all arrive pinned: {pinned}")
    if best_r1 != res1["R1"] or res1["sim_matrix"].shape != (
            MAIN_VIDEOS, MAIN_VIDEOS) or not np.isfinite(
            res1["sim_matrix"]).all():
        fail("main run 1's evaluation is malformed")
    if not {"ckpt.pth.tar", "ckpt_0", "ckpt_best", "hparams_train.json",
            "log.txt", "tensorboard"} <= set(out_files):
        fail(f"main run 1 wrote {out_files}")
    if not (np.array_equal(res2["sim_matrix"], res1["sim_matrix"])
            and res2["t2v"] == res1["t2v"] and res2["v2t"] == res1["v2t"]):
        fail("the eval-only reload differs from run 1's evaluation")
    if not same_first:
        fail("the .npy and .fstore loaders' first eval batches differ")
    return dict(
        steps=len(steps), batch=MAIN_BATCH, step_ms_median=med * 1e3,
        step_ms_all=[x * 1e3 for x in steps], clips_per_s=MAIN_BATCH / med,
        data_ms_mean=data_mean * 1e3,
        data_ms_all=[r["train/data_time"] * 1e3 for r in scalars],
        losses=losses, batches_pinned=all(pinned), eval_s=t_eval,
        eval_clips=MAIN_VIDEOS, R1=res1["R1"], reload_equal=True,
        peak_memory_bytes=peak, run1_s=t_run1, run2_s=t_run2,
        fixture_s=t_fixture, first_eval_batch_s=t_first,
        npy_equals_fstore=same_first, h2d_ms_pinned=h2d_pinned,
        h2d_ms_pageable=h2d_pageable,
        h2d_pinned_share_of_step=h2d_pinned / (med * 1e3),
        launches=launches, variants=variants, held=held), dict(
        paths=paths, store=store, sim=res1["sim_matrix"],
        ckpt=os.path.join(root, "out", "ckpt.pth.tar"))


def ids_agree(scores, ref_ids, ids, k, atol):
    """The first k of [Q, k + 1] ranked ids equal the reference's wherever
    the reference's neighbouring scores differ by more than atol (a tie's
    order may fall either way).  Returns the number of positions that
    differ outside ties."""
    import numpy as np
    tied = np.abs(np.diff(scores, axis=1)) <= atol              # [Q, k]
    exempt = tied[:, :k] | np.concatenate(
        [np.zeros((len(tied), 1), bool), tied[:, :k - 1]], axis=1)
    return int(((ids[:, :k] != ref_ids[:, :k]) & ~exempt).sum())


def http(method, url, body=None):
    import urllib.request
    req = urllib.request.Request(
        url, data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json"}, method=method)
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=120) as resp:
        out = resp.status, json.loads(resp.read())
    return out + ((time.perf_counter() - t0) * 1e3,)


def serve_phase(torch, np_, dev, counters, root, handoff, flush):
    """The fifth main path: `python -m centerclip_tpu_torch.serve.cli`
    build / query / serve on the main phase's synthetic MSR-VTT and its
    run-1 checkpoint, IVF on the same 48 clips, then the IVF index at
    deployment size and the encode from pinned and pageable memory."""
    import contextlib
    import csv
    import io
    import threading
    import unittest.mock
    from centerclip_tpu_torch import cli
    from centerclip_tpu_torch.data.registry import DATALOADER_DICT
    from centerclip_tpu_torch.models.tokenizer import tokenize_batch
    from centerclip_tpu_torch.serve import IVFVideoIndex, VideoIndex
    from centerclip_tpu_torch.serve import cli as serve_cli
    from centerclip_tpu_torch.serve import engine as engine_mod
    from centerclip_tpu_torch.serve.index import QUERY_BUCKETS
    from centerclip_tpu_torch.serve.http import RetrievalServer

    flags = EXP62_FLAGS + handoff["paths"] + [
        "--features_path", handoff["store"], "--output_dir",
        os.path.join(root, "serve"), "--init_model", handoff["ckpt"]]
    with open(os.path.join(root, "test.csv"), newline="") as f:
        rows = list(csv.reader(f))[1:]
    vids, captions = [r[0] for r in rows], [r[1] for r in rows]
    qfile = os.path.join(root, "queries.txt")
    with open(qfile, "w") as f:
        f.write("".join(c + "\n" for c in captions))
    path = {kind: os.path.join(root, f"gallery_{kind}.npz")
            for kind in ("float32", "int8", "ivf")}

    # what the CLI hands the engine, the server it starts, its warm-up
    pinned, servers, warm, quiet = [], [], [], io.StringIO()
    batches_fn = serve_cli.gallery_batches
    serve_forever, warmup = RetrievalServer.serve_forever, \
        RetrievalServer.warmup

    def recording_batches(*a, **k):
        for b in batches_fn(*a, **k):
            pinned.append(all(t.is_pinned() for t in b.values()))
            yield b

    def recording_warmup(self, *a, **k):
        t0 = time.time()
        in_warmup[0] = True
        try:
            n = warmup(self, *a, **k)
        finally:
            in_warmup[0] = False
        torch.cuda.synchronize()
        warm.append((n, time.time() - t0))
        return n

    def handing_over(self):
        servers.append(self)
        serve_forever(self)

    def run(argv):
        with contextlib.redirect_stdout(quiet):
            return serve_cli.main(argv + flags)

    # the first input of each shape that kernels A, C and E take on this
    # path (gallery batch padded on the card, the query batches, the
    # warm-up's), held against the plain versions after the counts are read;
    # a query's input replaces the warm-up's (its token ids are all 1)
    seen, seen_warm, in_warmup = {}, {}, [False]
    serve_cli.gallery_batches = recording_batches
    RetrievalServer.warmup = recording_warmup
    RetrievalServer.serve_forever = handing_over
    try:
        with recording_kernel_inputs(torch, seen,
                                     lambda: not in_warmup[0]), \
                recording_kernel_inputs(torch, seen_warm,
                                        lambda: in_warmup[0]):
            zero_counts(counters)
            torch.cuda.synchronize()
            t0 = time.time()
            f32 = run(["build", "--index_path", path["float32"], "--quantize",
                       "float32"])
            torch.cuda.synchronize()
            t_build = time.time() - t0
            t0 = time.time()
            results = run(["query", "--index_path", path["float32"],
                           "--queries_file", qfile, "--topk",
                           str(MAIN_VIDEOS)])
            t_query = time.time() - t0
            printed = [json.loads(line)
                       for line in quiet.getvalue().splitlines()
                       if line.startswith('{"query"')]
            run(["build", "--index_path", path["int8"], "--quantize", "int8"])
            th = threading.Thread(target=serve_cli.main, daemon=True, args=(
                ["serve", "--index_path", path["int8"], "--port", "0",
                 "--topk", "5"] + flags,))
            t0 = time.time()
            th.start()
            while not servers and th.is_alive() and time.time() - t0 < 300:
                time.sleep(0.05)
            if not servers:
                fail("serve/cli.py serve did not start its server")
            server = servers[0]
            t_listen = time.time() - t0
            base = "http://%s:%d" % server.address
            health = http("GET", base + "/healthz")
            body = {"queries": QUERIES, "k": 5}
            first = http("POST", base + "/search", body)
            steady = [http("POST", base + "/search", body)
                      for _ in range(HTTP_REPEATS)]
            engine = server.engine
            direct = engine.search(QUERIES, k=5)
            server._httpd.shutdown()
            th.join(timeout=60)
            server._httpd.server_close()
            ivf48 = run(["build", "--index_path", path["ivf"], "--index_type",
                         "ivf", "--n_clusters", "8", "--nprobe", "8",
                         "--quantize", "int8"])
            torch.cuda.synchronize()
            launches = {fn.__name__: fn.launches for fn in counters}
            variants = attention_variant_counts("serve CLI", backward=False)
    finally:
        serve_cli.gallery_batches = batches_fn
        RetrievalServer.warmup = warmup
        RetrievalServer.serve_forever = serve_forever
    seen_warm.update(seen)
    held = hold_recorded(torch, seen_warm, "serve CLI", "the serve CLI path")
    del seen, seen_warm

    # first and steady search at batch sizes no call ran before: unpadded
    # (the engine's bucket padding switched off), then as the engine runs
    # them, padded to buckets the warm-up ran
    ids, _, _ = tokenize_batch(engine.tokenizer, captions,
                               max_words=engine.max_words)
    unwarmed = {"unpadded": {}, "padded": {}}
    for n in UNWARMED_QUERIES:
        for kind in unwarmed:
            times = []
            with unittest.mock.patch.object(
                    engine_mod, "_next_bucket",
                    (lambda m: m) if kind == "unpadded"
                    else engine_mod._next_bucket):
                for _ in range(1 + SEARCH_REPEATS):
                    t0 = time.perf_counter()
                    engine.search_token_ids(ids[:n], k=5)
                    times.append((time.perf_counter() - t0) * 1e3)
            unwarmed[kind][n] = dict(
                first_ms=times[0],
                steady_ms=sorted(times[1:])[SEARCH_REPEATS // 2])

    # the float32 gallery's answers against the Evaluator's similarity
    sim = handoff["sim"]
    col = {v: j for j, v in enumerate(f32.video_ids)}

    def against(rows):
        """The CLI's rankings held to `rows` of the Evaluator's similarity:
        the largest score difference, and the pairs ranked against it by
        more than the tolerance (ranked above another, the Evaluator's
        score may not be lower by more than SERVE_SCORE_ATOL)."""
        err, wrong = 0.0, 0
        for i, ranked in zip(rows, results):
            cols = [col[r["video_id"]] for r in ranked]
            if sorted(cols) != list(range(MAIN_VIDEOS)):
                fail(f"query {i} did not rank every clip once: {cols}")
            ref = sim[i, cols]
            err = max(err, float(np_.abs(
                np_.array([r["score"] for r in ranked]) - ref).max()))
            wrong += int(np_.triu(ref[None, :] - ref[:, None]
                                  > SERVE_SCORE_ATOL, 1).sum())
        return err, wrong
    score_err, misordered = against(range(MAIN_VIDEOS))
    # the control: each query's ranking held to the next query's row (a
    # wrong query path) must fail the same check
    control_err, control_misordered = against(
        [(i + 1) % MAIN_VIDEOS for i in range(MAIN_VIDEOS)])
    # what the ordering check can see: each query's spread of the 48
    # Evaluator scores and the pairs more than the tolerance apart
    spread = float(np_.median(sim.max(1) - sim.min(1)))
    pairs_apart = int(sum(np_.triu(np_.abs(r[None, :] - r[:, None])
                                   > SERVE_SCORE_ATOL, 1).sum()
                          for r in sim))
    # the IVF index on the same 48 clips at nprobe = K against flat (int8),
    # both searched with the same query embeddings
    with torch.inference_mode():
        q48 = engine._embed_text(ids)[:MAIN_VIDEOS]
        fs, fi = (t.cpu().numpy() for t in engine.index.search_device(
            q48, IVF_K + 1))
        vs, vi = (t.cpu().numpy() for t in ivf48.search_device(
            q48, IVF_K + 1))
    tol48 = IVF_SCORE_RTOL * np_.abs(fs).max()
    ivf48_differ = ids_agree(fs, fi, vi, IVF_K, tol48)
    ivf48_err = float(np_.abs(vs - fs).max())

    steady_ms = [r[2] for r in steady]
    steady_mean = sum(steady_ms) / len(steady_ms)
    print(f"serve CLI: build (float32, 48 clips from the pinned loader) "
          f"{t_build:.3f} s, query of {len(captions)} captions (top "
          f"{MAIN_VIDEOS}) {t_query:.3f} s; batches pinned {pinned}; "
          f"scores against the Evaluator: max |err| {score_err:.4e} (tol "
          f"{SERVE_SCORE_ATOL}), pairs ordered against it by more than the "
          f"tol {misordered}; the Evaluator's scores: median spread per "
          f"query {spread:.4f}, pairs more than the tol apart {pairs_apart}; "
          f"control (each ranking held to the next query's row): max |err| "
          f"{control_err:.4e}, pairs ordered against it {control_misordered}")
    print(f"serve CLI: int8 daemon listening after {t_listen:.3f} s, "
          f"warm-up {warm} (buckets, s); /healthz {health[1]}; first "
          f"/search after warm-up {first[2]:.3f} ms (server took_ms "
          f"{first[1]['took_ms']}), steady {steady_mean:.3f} ms (mean of "
          f"{HTTP_REPEATS}, host clock, 4 queries, k=5); search at sizes no "
          f"call ran before, unpadded and padded to warmed buckets (first, "
          f"median of {SEARCH_REPEATS} more, host clock, ms): {unwarmed}")
    print(f"serve CLI: IVF (8 cells, nprobe 8) on the 48 clips against flat "
          f"int8: {ivf48_differ} ids differ outside ties, max |score err| "
          f"{ivf48_err:.3e} (tol {tol48:.3e})")
    print(f"launches during the serve CLI path: {launches}")
    for fn_name in ("fused_attention", "layer_norm",
                    "kmedoids_from_distances", "quick_gelu_forward"):
        if launches[fn_name] == 0:
            fail(f"{fn_name} was never launched on the serve CLI path")
    if len(pinned) != 3 or not all(pinned):
        fail(f"the CLI's gallery batches did not all arrive pinned: {pinned}")
    if f32.video_ids != vids or len(results) != MAIN_VIDEOS \
            or len(printed) != MAIN_VIDEOS:
        fail("serve CLI build / query returned the wrong gallery or rows")
    if score_err > SERVE_SCORE_ATOL or misordered:
        fail("the serve CLI's answers disagree with the Evaluator's "
             "similarity")
    if pairs_apart == 0:
        fail("no two of the Evaluator's scores for a query are more than "
             "the tolerance apart: the ordering check compares nothing")
    if control_err <= SERVE_SCORE_ATOL and not control_misordered:
        fail("the check passes a ranking held to the wrong query's scores")
    if health[0] != 200 or not health[1]["ok"] or \
            health[1]["videos"] != MAIN_VIDEOS:
        fail(f"/healthz answered {health}")
    if first[0] != 200 or first[1]["results"] != direct or any(
            r[0] != 200 or r[1]["results"] != direct for r in steady):
        fail("POST /search differs from engine.search on the same index")
    if not warm or warm[0][0] != len(QUERY_BUCKETS):
        fail(f"the server's warm-up ran {warm}")
    if ivf48_differ or ivf48_err > tol48:
        fail("IVF at full probe differs from flat on the 48 clips")

    # ------------------------------------------- IVF at deployment size
    g = torch.Generator(device=dev).manual_seed(0)
    centers = torch.randn((IVF_CELLS, IVF_D), generator=g, device=dev)
    centers /= centers.norm(dim=1, keepdim=True)
    noise = 0.25 / IVF_D ** 0.5

    def draw(n):
        which = torch.randint(IVF_CELLS, (n,), generator=g, device=dev)
        return centers[which] + noise * torch.randn((n, IVF_D), generator=g,
                                                    device=dev)
    emb, q = draw(IVF_N), draw(IVF_QUERIES)
    q = q / q.norm(dim=1, keepdim=True)
    gallery_ids = [str(i) for i in range(IVF_N)]
    torch.cuda.synchronize()
    t0 = time.time()
    flat = VideoIndex(emb, gallery_ids, quantize="int8")
    torch.cuda.synchronize()
    t_flat = time.time() - t0
    t0 = time.time()
    ivf = IVFVideoIndex(emb, gallery_ids, quantize="int8",
                        n_clusters=IVF_CELLS, iters=IVF_ITERS)
    torch.cuda.synchronize()
    t_ivf = time.time() - t0
    del emb
    fs, fi = (t.cpu().numpy() for t in flat.search_device(q, IVF_K + 1))
    recall = {}
    for p in IVF_NPROBES:
        ai = ivf.search_device(q, IVF_K, nprobe=p)[1].cpu().numpy()
        recall[p] = float(np_.mean([len(set(a) & set(e[:IVF_K])) / IVF_K
                                    for a, e in zip(ai, fi)]))
    vs, vi = (t.cpu().numpy() for t in ivf.search_device(
        q, IVF_K + 1, nprobe=IVF_CELLS))
    tol = IVF_SCORE_RTOL * np_.abs(fs).max()
    full_differ = ids_agree(fs, fi, vi, IVF_K, tol)
    full_err = float(np_.abs(vs - fs).max())
    search_ms = {}
    for b in (1, IVF_QUERIES):
        qb = q[:b]
        search_ms[f"flat_b{b}"] = time_ms(
            lambda: flat.search_device(qb, IVF_K), flush)
        for p in IVF_NPROBES:
            search_ms[f"ivf{p}_b{b}"] = time_ms(
                lambda: ivf.search_device(qb, IVF_K, nprobe=p), flush)
    flat_bound = IVF_N * (IVF_D + 4) / card_peaks(
        torch.cuda.get_device_name(0))[0] * 1e3
    new = draw(IVF_ADD)
    torch.cuda.synchronize()
    t0 = time.time()
    ivf.add(new, [f"new{i}" for i in range(IVF_ADD)])
    torch.cuda.synchronize()
    t_add = time.time() - t0
    _, top = ivf.search(new.cpu().numpy(), k=1)
    self_top1 = ivf.lookup(top[:, 0]) == [f"new{i}" for i in range(IVF_ADD)]
    layout = dict(capacity=ivf.capacity, regroups=ivf.regroups,
                  rows=len(ivf))
    del flat, ivf, centers, q, new, gallery_ids
    torch.cuda.empty_cache()
    print(f"IVF at {IVF_N} x {IVF_D} int8, {IVF_CELLS} cells, {IVF_ITERS} "
          f"Lloyd steps (drawn on the card): build {t_ivf:.3f} s (flat "
          f"{t_flat:.3f} s), capacity {layout['capacity']}; recall@{IVF_K} "
          f"against flat {recall}; nprobe {IVF_CELLS}: {full_differ} ids "
          f"differ outside ties, max |score err| {full_err:.3e} (tol "
          f"{tol:.3e}); device ms per search {search_ms} (flat's bound "
          f"{flat_bound:.4f} ms: the int8 gallery and its scales read "
          f"once); add {IVF_ADD} rows {t_add * 1e3:.3f} ms, regroups "
          f"{layout['regroups']}, each its own top-1: {self_top1}")
    if full_differ or full_err > tol:
        fail("IVF at nprobe = K differs from flat at 1M rows")
    if layout["regroups"] != 0 or not self_top1 or \
            layout["rows"] != IVF_N + IVF_ADD:
        fail(f"the live add went wrong: {layout}, self top-1 {self_top1}")

    # ------------------------------- encode rate, pinned and pageable
    cfg = cli.parse_args(flags)
    loader, _ = DATALOADER_DICT["msrvtt"]["val"](cfg, engine.tokenizer,
                                                 device=dev)
    first_batch = next(iter(loader))
    gal = {k: first_batch[k] for k in ("video", "video_mask")}
    pageable = {k: v.clone() for k, v in gal.items()}
    if not all(v.is_pinned() for v in gal.values()) or any(
            v.is_pinned() for v in pageable.values()):
        fail("the encode's batches are not pinned and pageable")
    n_clips = gal["video_mask"].shape[0]
    enc = {"pinned": [], "pageable": []}
    out = {}
    for _ in range(ENCODE_REPEATS):
        for kind, b in (("pinned", gal), ("pageable", pageable)):
            torch.cuda.synchronize()
            t0 = time.time()
            out[kind] = engine.embed_video_batches([b])
            enc[kind].append(time.time() - t0)
    rate = {k: n_clips / min(v) for k, v in enc.items()}
    print(f"encode of {n_clips} clips (one batch, host clock, best of "
          f"{ENCODE_REPEATS}): pinned {rate['pinned']:.2f} clips/s, "
          f"pageable {rate['pageable']:.2f} clips/s; equal: "
          f"{np_.array_equal(out['pinned'], out['pageable'])}")
    if not np_.array_equal(out["pinned"], out["pageable"]):
        fail("the pinned and the pageable encode differ")
    return dict(
        build_s=t_build, query_s=t_query, batches_pinned=pinned,
        evaluator_max_abs_err=score_err, evaluator_atol=SERVE_SCORE_ATOL,
        misordered_pairs=misordered, evaluator_median_spread=spread,
        evaluator_pairs_apart=pairs_apart, control_max_abs_err=control_err,
        control_misordered_pairs=control_misordered, listen_s=t_listen,
        warmup_buckets=warm[0][0], warmup_s=warm[0][1],
        first_request_ms=first[2], first_request_took_ms=first[1]["took_ms"],
        steady_request_ms=steady_mean, unwarmed_search_ms=unwarmed,
        ivf48_ids_differing=ivf48_differ, ivf48_max_abs_err=ivf48_err,
        ivf=dict(n=IVF_N, d=IVF_D, cells=IVF_CELLS, iters=IVF_ITERS,
                 build_s=t_ivf, flat_build_s=t_flat, recall_at_10=recall,
                 full_probe_ids_differing=full_differ,
                 full_probe_max_abs_err=full_err, search_ms=search_ms,
                 flat_bound_ms=flat_bound, add_rows=IVF_ADD,
                 add_ms=t_add * 1e3, **layout),
        encode_clips=n_clips,
        encode_clips_per_s=rate, encode_s_all=enc,
        launches=launches, variants=variants, held=held)


def exp62_flags(**changes):
    """scripts/msrvtt.sh's `common` + experiment 62 flags with `--<flag>
    <value>` replaced or appended (a list of values replaces all of a
    flag's values, as `--cluster_num_blocks` takes 12; None removes a
    switch such as `--loose_type`).  Nothing is written to the output
    directory: the flags are only parsed."""
    flags = EXP62_FLAGS + ["--output_dir", "extra_phases"]
    for flag, value in changes.items():
        name = "--" + flag
        values = value if isinstance(value, list) else [value]
        if value is None:
            flags.remove(name)
        elif name in flags:
            i = flags.index(name) + 1
            end = i
            while end < len(flags) and not flags[end].startswith("--"):
                end += 1
            flags[i:end] = values
        else:
            flags += [name, *values]
    return flags


def raw_counts(counters):
    """(launches by kernel, attention's launches by variant) since the
    counts were zeroed, with no check on the variants (for a path that runs
    no attention)."""
    from centerclip_tpu_torch.ops import attention_cuda as ac
    return ({fn.__name__: fn.launches for fn in counters},
            {fn.__name__: dict(fn.variant_launches)
             for fn in (ac.fused_attention, ac.attention_backward)})


def launched(label, launches, expected):
    """Fail unless exactly the kernels in `expected` launched."""
    for fn_name, n in launches.items():
        if (n > 0) != (fn_name in expected):
            fail(f"{label}: {fn_name} launched {n} times (expected "
                 f"{'some' if fn_name in expected else 'none'})")


def train_steps_of(torch, np, counters, flags, warmup, timed, label,
                   seed):
    """Build experiment 62's model with `flags` changed, take `warmup` +
    `timed` Trainer steps at batch 128 on a seeded batch, counts zeroed
    before them; fails unless kernels A-F launched (attention on its
    tensor-core variants).  Returns (run, model, trainer, batch, result
    dict, path counts)."""
    from centerclip_tpu_torch import cli
    from centerclip_tpu_torch.models.clip4clip import CLIP4Clip
    from centerclip_tpu_torch.train import Trainer
    t0 = time.time()
    run = cli.parse_args(flags)
    model = CLIP4Clip(run.model, device="cuda", seed=0)
    trainer = Trainer(run, model, total_steps=warmup + timed + 1)
    batch = seeded_batch(np, np.random.default_rng(seed), run.batch_size,
                         FRAMES, run.model.max_words)
    t_setup = time.time() - t0
    zero_counts(counters)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    med, step_ms, losses, _ = timed_steps(torch, np, trainer, batch, warmup,
                                          timed, label)
    peak = torch.cuda.max_memory_allocated()
    counts = path_counts_of(counters, f"{label} training", backward=True)
    B = run.batch_size
    print(f"{label} training (batch {B}, set-up {t_setup:.2f} s): losses "
          f"{[round(x, 6) for x in losses]}, step times "
          f"{[round(x, 3) for x in step_ms]} ms; median of the {timed} "
          f"timed {med:.3f} ms = {B / med * 1e3:.2f} clips/s; peak memory "
          f"allocated {peak / 2**30:.3f} GiB; launches {counts[0]}")
    launched(f"{label} training", counts[0], counts[0].keys())
    return run, model, trainer, batch, dict(
        batch=B, step_ms=med, clips_per_s=B / med * 1e3, step_ms_all=step_ms,
        losses=losses, peak_memory_bytes=peak), counts


def encode_and_search(torch, np, dev, counters, model, seed, label):
    """`RetrievalEngine.build_index` over N_CLIPS seeded clips in batches of
    BATCH (a 2-clip warm-up first), then one search of the 4 queries,
    counts zeroed before the build.  Fails on a gallery that is not finite
    or on bad hits.  Returns (result dict, path counts, engine)."""
    from centerclip_tpu_torch.serve import RetrievalEngine
    engine = RetrievalEngine(model.eval(), device=dev)
    g = np.random.default_rng(seed)
    clips = g.integers(0, 256, (N_CLIPS, 1, FRAMES, 3, RES, RES),
                       dtype=np.uint8)
    masks = np.ones((N_CLIPS, FRAMES), np.int32)
    ids = [f"clip{i:03d}" for i in range(N_CLIPS)]

    def batches(hi=N_CLIPS):
        for s in range(0, hi, BATCH):
            yield {"video": clips[s:min(s + BATCH, hi)],
                   "video_mask": masks[s:min(s + BATCH, hi)]}
    engine.build_index(batches(2), ids[:2])
    engine.search(QUERIES, k=2)
    zero_counts(counters)
    torch.cuda.synchronize()
    t0 = time.time()
    index = engine.build_index(batches(), ids)
    torch.cuda.synchronize()
    t_enc = time.time() - t0
    t0 = time.time()
    hits = engine.search(QUERIES, k=5)
    t_search = time.time() - t0
    counts = path_counts_of(counters, f"{label} encode", backward=False)
    gallery = index._codes[:N_CLIPS].float()
    dim = model.cfg.arch["embed_dim"]
    print(f"{label} encode: {N_CLIPS} clips in {t_enc:.3f} s = "
          f"{N_CLIPS / t_enc:.2f} clips/s (batches of {BATCH}), gallery "
          f"{tuple(gallery.shape)}; search of {len(QUERIES)} queries "
          f"{t_search * 1e3:.2f} ms; top hits "
          f"{[row[0]['video_id'] for row in hits]}; launches {counts[0]}")
    if tuple(gallery.shape) != (N_CLIPS, dim) or \
            not bool(torch.isfinite(gallery).all()):
        fail(f"{label}: the gallery is not finite [{N_CLIPS}, {dim}]")
    for row in hits:
        scores = [h["score"] for h in row]
        if len({h["video_id"] for h in row}) != 5 \
                or not all(np.isfinite(scores)) \
                or scores != sorted(scores, reverse=True):
            fail(f"{label}: bad hits {row}")
    return dict(encode_clips=N_CLIPS, encode_s=t_enc,
                encode_clips_per_s=N_CLIPS / t_enc,
                search_ms=t_search * 1e3), counts, engine


def card_vs_cpu(torch, np, model, batch, label):
    """The 2-clip pooled embedding of `model` on the card against the same
    weights on the CPU, by cosine (VIDEO_MIN_COS)."""
    from centerclip_tpu_torch.models.clip4clip import CLIP4Clip
    from centerclip_tpu_torch.serve import RetrievalEngine
    t0 = time.time()
    two = {k: batch[k][:2] for k in ("video", "video_mask")}
    card = RetrievalEngine(model.eval(), device="cuda") \
        .embed_video_batches([two])
    torch.set_num_threads(os.cpu_count() or 1)
    cpu_model = CLIP4Clip(model.cfg, device="cpu", seed=1).eval()
    cpu_model.load_state_dict({k: v.cpu() for k, v in
                               model.state_dict().items()}, strict=True)
    cpu = RetrievalEngine(cpu_model, device="cpu").embed_video_batches([two])
    cos = cosines(card, cpu)
    print(f"{label}: 2-clip encode card vs CPU ({time.time() - t0:.1f} s) "
          f"cosine {np.round(cos, 6).tolist()} (min {VIDEO_MIN_COS})")
    if cos.min() < VIDEO_MIN_COS:
        fail(f"card and CPU {label} embeddings disagree")
    return float(cos.min())


def headers_phase(torch, np, dev, flush, peaks, counters):
    """The eighth main path: the similarity headers at experiment 62's
    flags (ViT-B/32, kmediods++ 12 -> 6 frames, K = 49, bf16 towers, batch
    128).  seqTransf: HEADERS_WARMUP_STEPS + HEADERS_TIMED_STEPS training
    steps, a checkpoint-and-resume step equal to the uninterrupted one, an
    encode of 64 clips through `RetrievalEngine` (the header before the
    pooling) and a search.  tightTransf (loose_type off): the same steps
    (128 x 128 pairs of 7 tokens through the 4-layer fp32 cross model),
    peak memory, `Evaluator.evaluate` on 64 clips; then the tightTransf
    logits of CROSS_GALLERY texts x CROSS_GALLERY videos from seeded cached
    features ([1000, 1, 512], [1000, 6, 512]) with `cross_chunk_size`
    CROSS_CHUNK, timed, its peak memory, and a 64-row block across a chunk
    boundary and the ragged tail held to the unchunked block
    (CROSS_BLOCK_ATOL).  The header blocks run no attention kernel (their
    attention is the JAX package's plain fp32 path); their LayerNorms take
    kernels C and D in fp32, held against the plain version at the training
    shapes, and C also on the first input of each shape the encode, the
    evaluation and the logits (the last whole chunk and the ragged tail,
    run again) gave it."""
    import dataclasses
    from centerclip_tpu_torch.train import Evaluator
    paths, result = {}, {}
    steps = (HEADERS_WARMUP_STEPS, HEADERS_TIMED_STEPS)

    # ---- seqTransf: training, resume, encode and search
    run, model, trainer, batch, res, paths["seqTransf_training"] = \
        train_steps_of(torch, np, counters,
                       exp62_flags(sim_header="seqTransf"), *steps,
                       "seqTransf", seed=70)
    res["resume_s"] = resumed_step(torch, run, model, trainer, batch,
                                   sum(steps) + 1, "seqTransf")
    del trainer
    # kernel C's inputs off the towers' rows: the first of each shape on
    # the encode, the tightTransf evaluation and the 1k x 1k logits, held
    # against the plain version after each run's counts are read
    ln_site = [s for s in kernel_call_sites() if s[2] == "layernorm_fwd"]
    seen, held_rows = {}, []
    with recording_kernel_inputs(torch, seen, sites=ln_site):
        enc, paths["seqTransf_encode"], engine = encode_and_search(
            torch, np, dev, counters, model, 71, "seqTransf")
    held_rows += hold_recorded(torch, seen, "seqTransf encode",
                               "the seqTransf encode",
                               ("layernorm_fwd",))["layernorm_fwd"]
    launched("seqTransf encode", paths["seqTransf_encode"][0],
             ("fused_attention", "layer_norm", "kmedoids_from_distances",
              "quick_gelu_forward"))
    result["seqTransf"] = dict(res, **enc)
    del model, engine, batch
    torch.cuda.empty_cache()

    # ---- tightTransf: training, evaluation
    run, model, trainer, batch, res, paths["tightTransf_training"] = \
        train_steps_of(torch, np, counters,
                       exp62_flags(sim_header="tightTransf",
                                   loose_type=None), *steps,
                       "tightTransf", seed=72)
    cfg = run.model
    if cfg.loose_type or cfg.cross_num_hidden_layers != 4:
        fail(f"tightTransf: loose_type {cfg.loose_type}, "
             f"{cfg.cross_num_hidden_layers} cross layers")
    del trainer
    torch.cuda.empty_cache()
    model.eval()
    zero_counts(counters)
    seen.clear()
    t0 = time.time()
    with recording_kernel_inputs(torch, seen, sites=ln_site):
        ev = Evaluator(model).evaluate(
            {k: v[s:s + BATCH] for k, v in batch.items()}
            for s in range(0, N_EVAL_CLIPS, BATCH))
    t_eval = time.time() - t0
    paths["tightTransf_eval"] = path_counts_of(counters, "tightTransf eval",
                                               backward=False)
    held_rows += hold_recorded(torch, seen, "tightTransf eval",
                               "the tightTransf evaluation",
                               ("layernorm_fwd",))["layernorm_fwd"]
    seen.clear()
    sim = ev["sim_matrix"]
    print(f"tightTransf evaluation of {N_EVAL_CLIPS} clips ({t_eval:.2f} s, "
          f"all pairs through the cross model): R@1 {ev['R1']:.4f} (random "
          f"weights), logits {sim.min():.4f}..{sim.max():.4f}")
    if sim.shape != (N_EVAL_CLIPS, N_EVAL_CLIPS) or \
            not np.isfinite(sim).all() or sim.std() == 0:
        fail("the tightTransf evaluation gave a bad similarity matrix")
    res.update(eval_s=t_eval, eval_R1=ev["R1"])

    # ---- tightTransf logits of 1000 x 1000 cached features, chunked
    n, D = CROSS_GALLERY, cfg.arch["embed_dim"]
    gen = torch.Generator(device=dev).manual_seed(73)
    seq = torch.randn((n, 1, D), generator=gen, device=dev)
    vis = torch.randn((n, cfg.final_frames, D), generator=gen, device=dev)
    vmask = torch.ones((n, cfg.final_frames), dtype=torch.int32, device=dev)
    model.cfg = dataclasses.replace(cfg, cross_chunk_size=CROSS_CHUNK)
    with torch.inference_mode():
        model.cross_similarity(seq[:CROSS_CHUNK], vis[:CROSS_CHUNK],
                               vmask[:CROSS_CHUNK])          # warm-up
        zero_counts(counters)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        full = model.cross_similarity(seq, vis, vmask)
        torch.cuda.synchronize()
        t_1k = time.time() - t0
        peak_1k = torch.cuda.max_memory_allocated()
        paths["tightTransf_logits_1k"] = raw_counts(counters)
        # rows 936-999: across the chunk boundary at 960 and the ragged
        # tail of 40 rows, scored unchunked
        # the last whole chunk and the ragged tail again, C's first input
        # of each shape kept (the timed run's rows: the same chunks)
        with recording_kernel_inputs(torch, seen, sites=ln_site):
            model.cross_similarity(seq[-(CROSS_CHUNK + n % CROSS_CHUNK):],
                                   vis, vmask)
        model.cfg = dataclasses.replace(cfg, cross_chunk_size=0)
        lo = n - CROSS_CHUNK
        block = model.cross_similarity(seq[lo:], vis, vmask)
        block_err = (block - full[lo:]).abs().max().item()
    model.cfg = cfg
    held_rows += hold_recorded(torch, seen, "tightTransf logits 1k",
                               "the tightTransf logits",
                               ("layernorm_fwd",))["layernorm_fwd"]
    del seen
    counts_1k = paths["tightTransf_logits_1k"][0]
    # per (text, video) pair: 7 tokens through 4 blocks (qkv, out, MLP
    # 2 x 4 matmuls of 512 x 2048) and the pooler; fp32 without TF32
    L = 1 + cfg.final_frames
    flop = 2.0 * n * n * (cfg.cross_num_hidden_layers * L * (
        12 * D * D + 2 * L * D) + D * D)
    print(f"tightTransf logits {n} x {n} (chunks of {CROSS_CHUNK} texts, "
          f"{L} tokens a pair): {t_1k:.3f} s, {n * n / t_1k:.0f} pairs/s, "
          f"{flop / t_1k / 1e12:.2f} TFLOP/s of {flop / 1e12:.1f} TFLOP; "
          f"peak memory allocated {peak_1k / 2**30:.3f} GiB; rows "
          f"{lo}-{n - 1} unchunked vs chunked max_abs_err {block_err:.3e} "
          f"(tol {CROSS_BLOCK_ATOL}); launches {counts_1k}")
    if tuple(full.shape) != (n, n) or not bool(torch.isfinite(full).all()):
        fail("the 1000 x 1000 tightTransf logits are not finite")
    if block_err > CROSS_BLOCK_ATOL:
        fail("a chunked tightTransf block differs from the unchunked one")
    launched("tightTransf 1k x 1k logits", counts_1k,
             ("layer_norm", "quick_gelu_forward"))
    res.update(logits_1k_s=t_1k, logits_1k_pairs_per_s=n * n / t_1k,
               logits_1k_tflop=flop / 1e12,
               logits_1k_peak_memory_bytes=peak_1k,
               chunk_block_max_abs_err=block_err)
    result["tightTransf"] = res
    del model, batch, seq, vis, full, block
    torch.cuda.empty_cache()

    # ---- kernels C and D on the header blocks' fp32 rows
    B = run.batch_size
    ln_rows = [hold_layernorm_bwd(torch, dev, flush, peaks, label, R, D,
                                  torch.float32)
               for label, R in (("seqTransf blocks (fp32)",
                                 B * cfg.final_frames),
                                ("cross blocks (fp32)", B * B * L))]
    return result, dict(paths=paths, layernorm_bwd=[r for r, _ in ln_rows],
                        layernorm_fwd=[f for _, f in ln_rows] + held_rows)


def towers_phase(torch, np, dev, flush, peaks, counters):
    """The ninth main path: the other towers.  `--linear_patch 3d` at
    experiment 62's flags: TOWERS_WARMUP_STEPS + TOWERS_TIMED_STEPS
    training steps at batch 128 (kernels A-F), the patchify alone
    (CUDA events: the port's matmul beside `F.conv3d` on the same inputs,
    and its bound), a 2-clip encode card vs CPU.  RN50 (cluster
    off, as the JAX package's tests/test_resnet.py): an encode of 64 clips
    of 12 frames through `RetrievalEngine` (embed dim 1024, fp32 tower with
    cuDNN's TF32 off) and a search (A and C in the text tower, no E), a
    2-clip encode card vs CPU."""
    from centerclip_tpu_torch.models.clip import (CLIP_MEAN, CLIP_STD,
                                                  patchify_3d)
    mem_rate, bf16_peak, _ = peaks
    paths, result = {}, {}
    steps = (TOWERS_WARMUP_STEPS, TOWERS_TIMED_STEPS)

    # ---- the 3-D patchify
    run, model, trainer, batch, res, paths["patch3d_training"] = \
        train_steps_of(torch, np, counters, exp62_flags(linear_patch="3d"),
                       *steps, "3-D patchify", seed=80)
    del trainer
    torch.cuda.empty_cache()
    w = model.clip.visual.conv2.weight.detach()
    u8 = torch.as_tensor(batch["video"]).to(dev).reshape(-1, 3, RES, RES)
    mean = torch.tensor(CLIP_MEAN, device=dev)[:, None, None]
    std = torch.tensor(CLIP_STD, device=dev)[:, None, None]
    video = (u8.float() / 255.0 - mean) / std
    del u8
    bf16 = torch.bfloat16
    P = w.shape[-1]

    def conv3d():
        """The same function as one cuDNN call (the JAX package's
        `lax.conv`)."""
        x5 = video.reshape(-1, FRAMES, *video.shape[1:]).transpose(1, 2)
        out = torch.nn.functional.conv3d(x5.to(bf16), w.to(bf16),
                                         stride=(1, P, P), padding=(1, 0, 0))
        return out.permute(0, 2, 3, 4, 1).reshape(video.shape[0], -1,
                                                  w.shape[0])
    with torch.inference_mode():
        out = patchify_3d(video, w, FRAMES, bf16)
        err = hold_close(torch, "the 3-D patchify against F.conv3d",
                         out.float(), conv3d().float(), BF16_ATOL, BF16_RTOL)
        ms = time_ms(lambda: patchify_3d(video, w, FRAMES, bf16),
                     flush=flush)
        conv_ms = time_ms(conv3d, flush=flush)
    BT, O = video.shape[0], w.shape[0]
    b_ms, b_by = bound(video.numel() * 4 + w.numel() * 4 + out.numel() * 2,
                       2.0 * BT * out.shape[1] * O * w[0].numel(), bf16_peak,
                       mem_rate)
    print(f"3-D patchify [{BT}, 3, {RES}, {RES}] fp32 -> {tuple(out.shape)} "
          f"bf16 (kernel {tuple(w.shape)}): {ms:.4f} ms (one matmul), "
          f"F.conv3d {conv_ms:.4f} ms (max_abs_err {err:.3e}), bound "
          f"{b_ms:.4f} ({b_by}); the step's median {res['step_ms']:.3f} ms")
    res.update(patchify_ms=ms, patchify_conv3d_ms=conv_ms,
               patchify_bound_ms=b_ms, patchify_bound_by=b_by,
               patchify_shape=list(video.shape))
    del video, out
    res["video_cos_min"] = card_vs_cpu(torch, np, model, batch,
                                       "3-D patchify")
    result["patch3d"] = res
    del model, batch
    torch.cuda.empty_cache()

    # ---- RN50: encode and search
    from centerclip_tpu_torch import cli
    from centerclip_tpu_torch.models.clip4clip import CLIP4Clip
    rrun = cli.parse_args(exp62_flags(pretrained_clip_name="RN50",
                                      cluster_inter="0"))
    t0 = time.time()
    model = CLIP4Clip(rrun.model, device=dev, seed=0)
    t_setup = time.time() - t0
    if torch.backends.cudnn.allow_tf32 is not False or \
            torch.backends.cuda.matmul.allow_tf32 is not False:
        fail("TF32 is on for the ResNet tower's convolutions")
    enc, paths["rn50_encode"], engine = encode_and_search(
        torch, np, dev, counters, model, 81, "RN50")
    launched("RN50 encode", paths["rn50_encode"][0],
             ("fused_attention", "layer_norm", "quick_gelu_forward"))
    two = seeded_batch(np, np.random.default_rng(82), 2, FRAMES, 32)
    enc.update(set_up_s=t_setup, video_cos_min=card_vs_cpu(
        torch, np, model, two, "RN50"))
    result["rn50"] = enc
    del model, engine
    torch.cuda.empty_cache()
    return result, dict(paths=paths)


def preprocess_phase(torch, np, dev, flush, peaks, counters, root):
    """The tenth main path: the preprocess tools.  `build_framestore` over
    the main phase's seeded .npy videos must write the .fstore (and its
    .json) the main phase wrote, byte for byte; `visualize_clusters --mode
    mask --save_ids 1` and `--mode overlay` on a seeded .npy video of
    VIS_FRAMES frames (segments of 2: [6, 98, 3072] fp32 pixel tokens,
    K = VIS_K, iter_limit 60) on the card: kernel E must launch and its ids
    must equal the plain version's on the card, on the same tokens."""
    import filecmp
    from centerclip_tpu_torch.ops.kmedoids import batch_fast_kmedoids
    from centerclip_tpu_torch.preprocess import (build_framestore,
                                                 visualize_clusters as vc)
    result = {}
    # ---- the FrameStore of the main phase's videos
    out = os.path.join(root, "rebuilt.fstore")
    t0 = time.time()
    n = build_framestore.main(["--input_root", os.path.join(root, "videos"),
                               "--output", out])
    t_pack = time.time() - t0
    same = [filecmp.cmp(os.path.join(root, "videos.fstore") + ext,
                        out + ext, shallow=False) for ext in ("", ".json")]
    size = os.path.getsize(out)
    print(f"preprocess build_framestore: {n} videos, {size} bytes in "
          f"{t_pack:.2f} s ({size / t_pack / 2**20:.1f} MiB/s); equal to "
          f"the main phase's .fstore byte for byte: {same[0]}, its .json: "
          f"{same[1]}")
    if n != MAIN_VIDEOS or not all(same):
        fail("build_framestore wrote another .fstore than the main phase's")
    result.update(framestore_videos=n, framestore_bytes=size,
                  framestore_s=t_pack)

    # ---- visualize_clusters on the card
    g = np.random.default_rng(90)
    frames = g.integers(0, 256, (VIS_FRAMES, RES, RES, 3), dtype=np.uint8)
    video = os.path.join(root, "visualize.npy")
    np.save(video, frames)
    counts, times = None, {}
    for mode in ("mask", "overlay"):
        out_dir = os.path.join(root, f"visualize_{mode}")
        zero_counts(counters)
        t0 = time.time()
        vc.main(["--video", video, "--output_dir", out_dir, "--mode", mode,
                 "--max_frames", str(VIS_FRAMES), "--cluster_num",
                 str(VIS_K), "--segment_frames", str(VIS_FRAMES // 2),
                 "--save_ids", "1"])
        torch.cuda.synchronize()
        times[mode] = time.time() - t0
        c = raw_counts(counters)
        launched(f"visualize_clusters --mode {mode}", c[0],
                 ("kmedoids_from_distances",))
        counts = c if counts is None else (
            {k: v + c[0][k] for k, v in counts[0].items()}, counts[1])
        written = len(os.listdir(out_dir))
        print(f"visualize_clusters --mode {mode}: {times[mode]:.2f} s, "
              f"{written} files; launches {c[0]}")
        if written < 2 * VIS_FRAMES:
            fail(f"visualize_clusters --mode {mode} wrote {written} files")
    ids = np.load(os.path.join(root, "visualize_mask", "ids_0.npy"))
    tokens, _ = vc.pixel_tokens(frames, VIS_FRAMES // 2)
    x = torch.from_numpy(tokens).to(dev)
    _, plain = batch_fast_kmedoids(x, VIS_K, iter_limit=vc.KMEDOIDS_ITER_LIMIT)
    differ = int((plain.cpu().numpy() != ids).any(axis=1).sum())
    print(f"visualize_clusters medoid ids {ids.shape}: the kernel's vs the "
          f"plain version's on the card, segments with other ids {differ}")
    if differ:
        fail("visualize_clusters' medoid ids differ from the plain "
             "version's")
    km_row = kmedoids_points_case(torch, flush, peaks,
                                  "visualize_clusters pixel tokens", x,
                                  VIS_K, vc.KMEDOIDS_ITER_LIMIT)
    result.update(visualize_s=times, medoid_segments_differing=differ)
    return result, dict(paths={"visualize_clusters": counts},
                        kmedoids=[km_row])


def kernel_counters():
    """Kernels A-F's wrappers, each counting its launches."""
    from centerclip_tpu_torch.ops import (attention_cuda, kmedoids_cuda,
                                          layernorm_triton, quick_gelu)
    return (attention_cuda.fused_attention,
            attention_cuda.attention_backward, layernorm_triton.layer_norm,
            layernorm_triton.layer_norm_backward,
            kmedoids_cuda.kmedoids_from_distances,
            quick_gelu.quick_gelu_forward, quick_gelu.quick_gelu_backward)


def check_quick_gelu_launches(label, launches, steps, per_fwd):
    """Fail unless kernel F launched once a block each way in each of
    `steps` training steps of a CLIP with 12 vision and 12 text blocks
    (the forward `per_fwd` times a step: 2 under remat)."""
    want = {"quick_gelu_forward": 24 * per_fwd * steps,
            "quick_gelu_backward": 24 * steps}
    got = {k: launches[k] for k in want}
    if got != want:
        fail(f"{label}: kernel F launched {got}, not {want}")


def first_batches(loader, n):
    """The first `n` batches of a loader (its producer then stops)."""
    it = iter(loader)
    try:
        return [next(it) for _ in range(n)]
    finally:
        it.close()


@contextlib.contextmanager
def recording_ln_bwd_streams(torch, streams):
    """Record the stream of every launch of kernel D (at its ticket
    buffer's lookup, once per launch)."""
    from centerclip_tpu_torch.ops import layernorm_triton as ln
    tickets = ln._tickets

    def recording(device, n):
        streams.append(torch.cuda.current_stream(device).cuda_stream)
        return tickets(device, n)
    ln._tickets = recording
    try:
        yield
    finally:
        ln._tickets = tickets


def parallel_steps(torch, cfg, batches, counters, label, dev,
                   timed=PARALLEL_TIMED):
    """Build experiment 62's model from `cfg`'s seed, wrap it as `cfg` says
    (the Trainer: unwrapped without a process group, DDP, or FSDP, on the
    tensor-parallel slices with `--tensor_parallel`), take
    PARALLEL_STEPS compared steps on `batches` (counts zeroed before, read
    after; kernel D's streams recorded) and `timed` timed ones.
    Returns the steps' losses, the whole parameters after the compared
    steps (on the host, gathered), step 1's clipped gradients (whole), the
    counts, D's streams, the median step and the peak memory."""
    from centerclip_tpu_torch.models.clip4clip import CLIP4Clip
    from centerclip_tpu_torch.ops import layernorm_triton as ln
    from centerclip_tpu_torch.parallel import axes_of, fetch_replicated
    from centerclip_tpu_torch.train import Trainer
    from centerclip_tpu_torch.train.loop import make_train_step
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = CLIP4Clip(cfg.model, device=dev, seed=cfg.seed)
    trainer = Trainer(cfg, model, total_steps=PARALLEL_STEPS + PARALLEL_TIMED)
    step = make_train_step(trainer.module, trainer.optimizer)
    streams, losses, grads1 = [], [], None
    zero_counts(counters)
    torch.cuda.synchronize()
    with recording_ln_bwd_streams(torch, streams):
        for i, b in enumerate(batches):
            losses.append(float(step(b)["loss"]))
            if i == 0:
                grads1 = fetch_replicated({n: p.grad for n, p in
                                           model.named_parameters()
                                           if p.grad is not None},
                                          axes_of(model))
    torch.cuda.synchronize()
    counts = path_counts_of(counters, label, backward=True)
    params = fetch_replicated(model.state_dict(), axes_of(model))
    dirty = int(ln._ticket_buffers[dev].abs().sum())
    print(f"{label}: compared steps done, losses {losses}", flush=True)
    step_s = []
    for i in range(timed):
        t0 = time.time()
        float(step(batches[i % len(batches)])["loss"])
        step_s.append(time.time() - t0)
    peak = torch.cuda.max_memory_allocated()
    del trainer, model, step
    torch.cuda.empty_cache()
    default = torch.cuda.default_stream(dev).cuda_stream
    return dict(losses=losses, params=params, grads1=grads1, counts=counts,
                d_streams=sorted(set(streams)), d_launches=len(streams),
                d_on_default_stream=set(streams) == {default},
                d_tickets_dirty=dirty,
                step_ms=sorted(step_s)[len(step_s) // 2] * 1e3,
                step_ms_all=[x * 1e3 for x in step_s], peak_bytes=peak)


def differing(torch, a, b):
    """Names whose tensors differ between two state dicts, with the largest
    absolute difference of each."""
    return {k: float((a[k].float() - b[k].float()).abs().max())
            for k in a if not torch.equal(a[k], b[k])}


def length_ratio(a, b):
    """|a| / |b| (1 where both are zero)."""
    na, nb = float(a.double().norm()), float(b.double().norm())
    return 1.0 if na == nb else (na / nb if nb else float("inf"))


def held_to_one_process(r, loss, grads):
    """A wrapped run's first step (`parallel_steps`) against the
    one-process step's loss and whole gradients: the relative loss
    difference and each gradient's cosine, beside the run's own
    numbers."""
    cos = {k: float(cosines(r["grads1"][k].double().reshape(1, -1),
                            grads[k].double().reshape(1, -1))[0])
           for k in grads}
    # a cosine is blind to a gradient's scale: each length's ratio too
    ratio = {k: length_ratio(r["grads1"][k], grads[k]) for k in grads}
    return dict(
        loss=r["losses"][0], loss_one_process=loss,
        loss_rel=abs(r["losses"][0] - loss) / abs(loss),
        grad_keys_equal=sorted(r["grads1"]) == sorted(grads),
        grad_min_cos=min(cos.values()),
        grad_worst=sorted(cos.items(), key=lambda kv: kv[1])[:3],
        grad_norm_worst=max(ratio.items(), key=lambda kv: abs(kv[1] - 1)),
        **{k: v for k, v in r.items()
           if k not in ("params", "grads1", "losses")})


def parallel_leg_single(torch, np, root, out_path):
    """Leg (a), one NCCL rank: the unwrapped steps before the process
    group exists, then DDP and FSDP from the same init on the same
    batches, then `main` under FSDP (rank 0's evaluation and checkpoint)
    and its eval-only reload."""
    from centerclip_tpu_torch import cli, parallel
    from centerclip_tpu_torch.data.registry import DATALOADER_DICT
    from centerclip_tpu_torch.main import main as run_main
    from centerclip_tpu_torch.models.tokenizer import SimpleTokenizer
    from centerclip_tpu_torch.train import evaluate
    dev = torch.device("cuda", 0)
    counters = kernel_counters()
    out = os.path.join(root, "parallel_out")
    cfg = cli.parse_args(main_argv(root, out))
    loader, _, _ = DATALOADER_DICT["msrvtt"]["train"](cfg, SimpleTokenizer(),
                                                      device=dev)
    batches = first_batches(loader, PARALLEL_STEPS)
    runs = {"unwrapped": parallel_steps(torch, cfg, batches, counters,
                                        "parallel unwrapped", dev)}
    ref = runs["unwrapped"]
    torch.save({"loss": ref["losses"][0], "grads": ref["grads1"]},
               os.path.join(root, "parallel_ref.pt"))
    parallel.init_distributed()
    for label, extra in (("ddp", ["--data_parallel", "1"]),
                         ("fsdp", ["--data_parallel", "1", "--fsdp", "1"])):
        runs[label] = parallel_steps(
            torch, cli.parse_args(main_argv(root, out, extra)), batches,
            counters, f"parallel {label}", dev)
    result = {}
    for label, r in runs.items():
        result[label] = {k: v for k, v in r.items()
                         if k not in ("params", "grads1")}
        if label != "unwrapped":
            result[label]["params_differing"] = differing(
                torch, r["params"], ref["params"])
            result[label]["losses_equal"] = r["losses"] == ref["losses"]
            result[label]["grads1_differing"] = differing(
                torch, r["grads1"], ref["grads1"])
    del runs, ref

    # `main` under FSDP on one rank: train, rank 0 evaluates the gathered
    # parameters and writes; then the eval-only reload of its export
    evals = []
    evaluate_fn = evaluate.Evaluator.evaluate

    def recording_evaluate(self, *a, **k):
        evals.append(evaluate_fn(self, *a, **k))
        return evals[-1]
    evaluate.Evaluator.evaluate = recording_evaluate
    try:
        zero_counts(counters)
        t0 = time.time()
        best = run_main(main_argv(root, out, ["--data_parallel", "1",
                                              "--fsdp", "1"]))
        t_main = time.time() - t0
        counts = path_counts_of(counters, "parallel main", backward=True)
        # the export reloads in a run of one process (no process group)
        os.environ.pop("WORLD_SIZE")
        run_main(main_argv(root, os.path.join(root, "parallel_eval"), [
            "--do_train", "0", "--init_model",
            os.path.join(out, "ckpt.pth.tar")]))
    finally:
        evaluate.Evaluator.evaluate = evaluate_fn
    with open(os.path.join(out, "tensorboard", "scalars.jsonl")) as f:
        steps = [json.loads(line)["train/batch_time"] * 1e3 for line in f]
    res1, res2 = evals
    result["main_fsdp"] = dict(
        counts=counts, run_s=t_main, R1=res1["R1"], best_r1=best,
        step_ms_all=steps, files=sorted(os.listdir(out)),
        reload_equal=bool(np.array_equal(res1["sim_matrix"],
                                         res2["sim_matrix"])
                          and res1["t2v"] == res2["t2v"]))
    with open(out_path, "w") as f:
        json.dump(result, f)


def parallel_leg_gloo(torch, np, root, out_path):
    """Leg (b), GLOO_RANKS ranks sharing cuda:0 over gloo at 64 clips a
    rank: which collectives gloo takes on CUDA tensors, then the first
    step under DDP (and under FSDP where gloo takes its collectives)
    against leg (a)'s one-process step at batch 128."""
    from centerclip_tpu_torch import cli, parallel
    from centerclip_tpu_torch.data.registry import DATALOADER_DICT
    from centerclip_tpu_torch.models.tokenizer import SimpleTokenizer
    import torch.distributed as dist
    dev = torch.device("cuda", 0)
    parallel.init_distributed(dev, backend="gloo")
    rank, world = dist.get_rank(), dist.get_world_size()
    x = torch.full((4, 8), float(rank + 1), device=dev)
    probes = {
        "all_reduce": lambda: dist.all_reduce(x.clone()),
        "all_gather": lambda: dist.all_gather(
            [torch.empty_like(x) for _ in range(world)], x),
        "all_gather_into_tensor": lambda: dist.all_gather_into_tensor(
            x.new_empty((4 * world, 8)), x),
        "reduce_scatter_tensor": lambda: dist.reduce_scatter_tensor(
            x.new_empty((4 // world, 8)), x)}
    gloo_cuda = {}
    for name, probe in probes.items():
        # which collectives gloo's CUDA path has: a refusal is the answer
        try:
            probe()
            torch.cuda.synchronize()
            gloo_cuda[name] = "ok"
        except (RuntimeError, ValueError) as e:
            gloo_cuda[name] = str(e).strip().splitlines()[0][:300]
    print(f"parallel gloo rank {rank}: gloo on CUDA tensors {gloo_cuda}",
          flush=True)
    ref = torch.load(os.path.join(root, "parallel_ref.pt"))
    counters = kernel_counters()
    out = os.path.join(root, "parallel_gloo_out")
    cfg = cli.parse_args(main_argv(root, out, ["--data_parallel",
                                               str(world)]))
    loader, _, _ = DATALOADER_DICT["msrvtt"]["train"](cfg, SimpleTokenizer(),
                                                      device=dev)
    batch = first_batches(loader, 1)
    result = {"gloo_cuda": gloo_cuda, "rank_rows": len(batch[0]["input_ids"])}
    strategies = [("ddp", [])]
    if gloo_cuda["all_gather_into_tensor"] == gloo_cuda[
            "reduce_scatter_tensor"] == "ok":
        strategies.append(("fsdp", ["--fsdp", "1"]))
    for label, extra in strategies:
        print(f"parallel gloo rank {rank}: {label}", flush=True)
        # one timed step: two ranks sharing a card show no speed
        r = parallel_steps(torch, cli.parse_args(main_argv(
            root, out, ["--data_parallel", str(world)] + extra)), batch,
            counters, f"parallel gloo {label}", dev, timed=1)
        result[label] = held_to_one_process(r, ref["loss"], ref["grads"])
    if rank == 0:
        with open(out_path, "w") as f:
            json.dump(result, f)
    parallel.process_barrier("gloo_leg_done")
    dist.destroy_process_group()


@contextlib.contextmanager
def recording_cluster(torch, store, replay=None, shard=(0, 1)):
    """Keep the first input of the vision cluster layer and the first
    (assign, medoid ids) its k-medoids returned (kernel E's).  With
    `replay` (another run's store) the layer then takes that run's ids
    instead, the clips of data shard `shard` = (index, count) of them, so
    that a medoid that rounding flipped does not change the tokens the
    later blocks see; the segments whose own ids differed are counted in
    `store["medoid_segments_differing"]`, the share of its picks that the
    other run did not pick in `store["medoid_ids_differing"]`."""
    from centerclip_tpu_torch.ops import cluster_layer
    cls = cluster_layer.TokenClusterInter
    forward, cluster = cls.forward, cls._cluster

    def recording_forward(self, x, *a, **k):
        store.setdefault("input", x.detach().clone())
        return forward(self, x, *a, **k)

    def recording_cluster_ids(self, res_tmp):
        assign, meds = cluster(self, res_tmp)
        store.setdefault("assign", assign.clone())
        store.setdefault("medoids", meds.clone())
        if replay is None:
            return assign, meds
        S, (d, n) = self.spec.after_frames, shard

        def rows(t):
            # segment-major [S * B, ...]; the loader deals the global
            # batch's clips to the shards in turn: clips d, d + n, ...
            t = t.reshape(S, -1, n, *t.shape[1:])[:, :, d]
            return t.reshape(-1, *t.shape[2:])
        assign, own = rows(replay["assign"]), meds
        meds = rows(replay["medoids"])
        store.setdefault("medoid_segments_differing",
                         int((own != meds).any(-1).sum()))
        # ids are sorted: a medoid moved shifts the later positions, so
        # count the picks that are not in the other run's set
        store.setdefault("medoid_ids_differing", float(
            (own[:, :, None] != meds[:, None, :]).all(-1).float().mean()))
        return assign, meds
    cls.forward, cls._cluster = recording_forward, recording_cluster_ids
    try:
        yield store
    finally:
        cls.forward, cls._cluster = forward, cluster


def differing_on_ranks(torch, tensors):
    """The names in `tensors` (the same names on every rank) whose bytes
    are not the same on every rank (a SHA-256 of each, compared)."""
    import hashlib
    import torch.distributed as dist
    mine = {k: hashlib.sha256(t.detach().cpu().contiguous().reshape(-1)
                              .view(torch.uint8)
                              .numpy().tobytes()).hexdigest()
            for k, t in tensors.items()}
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, mine)
    return sorted(k for k in mine if any(e[k] != mine[k] for e in every))


def equal_on_ranks(torch, t, group=None):
    """True when `t` is equal to the bit on every rank of `group`."""
    import torch.distributed as dist
    parts = [torch.empty_like(t)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return all(torch.equal(parts[0], p) for p in parts[1:])


def grouped_steps(torch, root, out, flags, counters, label, dev, ref,
                  timed=PARALLEL_TIMED, seen=None):
    """A tensor- or pipeline-parallel run of `parallel_steps` on the rows
    the registry's loader gives this rank's model or pipe group under
    `flags`, held to the one-process step `ref` (`held_to_one_process`)
    with `ref`'s medoid ids replayed (`recording_cluster`; its "clusters"
    store), with whether the ranks of each group clustered the same tokens
    into the same medoids and in how many segments the group's own ids
    differed from `ref`'s.  With `seen`, the first input of each shape that
    A, C and E took is kept there (`recording_kernel_inputs`)."""
    import torch.distributed as dist
    from centerclip_tpu_torch import cli
    from centerclip_tpu_torch.data.registry import DATALOADER_DICT
    from centerclip_tpu_torch.models.tokenizer import SimpleTokenizer
    cfg = cli.parse_args(main_argv(root, out, flags))
    loader, _, _ = DATALOADER_DICT["msrvtt"]["train"](
        cfg, SimpleTokenizer(), device=dev)
    batch = first_batches(loader, 1)
    tp = int(cfg.tensor_parallel) * int(cfg.model.pipeline_parallel)
    shard = (dist.get_rank() // tp, dist.get_world_size() // tp)
    store = {}
    with recording_cluster(torch, store, ref["clusters"], shard), \
            recording_kernel_inputs(torch, {} if seen is None else seen,
                                    lambda: seen is not None):
        r = parallel_steps(torch, cfg, batch, counters, label, dev,
                           timed=timed)
    res = held_to_one_process(r, ref["losses"][0], ref["grads1"])
    # every rank's step held to the one-process step, not rank 0's alone
    by_rank = [None] * dist.get_world_size()
    dist.all_gather_object(by_rank, {k: res[k] for k in (
        "loss_rel", "grad_keys_equal", "grad_min_cos", "grad_norm_worst")})
    res["held_by_rank"] = by_rank
    if int(cfg.model.pipeline_parallel) > 1:
        # every parameter is replicated over the pipe and data groups
        res["params_differing_on_ranks"] = differing_on_ranks(
            torch, r["params"])
    # the Trainer's mesh is gone with its model: compare over a model (or
    # pipe) group of the same ranks, made here
    group = model_group(torch, tp)
    res.update(rank_rows=len(batch[0]["input_ids"]),
               cluster_input_equal=equal_on_ranks(torch, store["input"],
                                                  group),
               medoids_equal=equal_on_ranks(torch, store["medoids"], group),
               cluster_input_shape=list(store["input"].shape),
               medoid_segments_differing=store["medoid_segments_differing"],
               medoid_ids_differing=store["medoid_ids_differing"],
               medoid_segments=int(store["medoids"].shape[0]))
    return res


def clustered_steps(torch, cfg, batches, counters, label, dev, **kw):
    """`parallel_steps` with the cluster layer's first ids kept, under
    "clusters", for `grouped_steps` to replay."""
    store = {}
    with recording_cluster(torch, store):
        r = parallel_steps(torch, cfg, batches, counters, label, dev, **kw)
    r["clusters"] = {k: store[k] for k in ("assign", "medoids")}
    return r


def model_group(torch, tp):
    """This rank's model (or pipe) group of a (world / tp, tp) mesh: ranks
    i * tp .. i * tp + tp - 1 (every rank makes every group)."""
    import torch.distributed as dist
    world, rank = dist.get_world_size(), dist.get_rank()
    mine = None
    for i in range(world // tp):
        g = dist.new_group(list(range(i * tp, (i + 1) * tp)))
        if rank // tp == i:
            mine = g
    return mine


def parallel_leg_tp_gloo(torch, np, root, out_path):
    """Leg (b'), TP_GLOO_RANKS gloo ranks sharing cuda:0 as a (data 1,
    model TP_GLOO_RANKS) mesh at TP_GLOO_BATCH clips: each rank first takes
    the one-process step on the same batch (before the process group
    exists), then TP and TP + SP (one compared and one timed step each),
    held to it by TP_LOSS_RTOL and TP_GRAD_MIN_COS; the ranks' cluster
    inputs and medoid ids compared to the bit; every rank's counts handed
    to rank 0."""
    from centerclip_tpu_torch import cli, parallel
    from centerclip_tpu_torch.data.registry import DATALOADER_DICT
    from centerclip_tpu_torch.models.tokenizer import SimpleTokenizer
    import torch.distributed as dist
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    counters = kernel_counters()
    out = os.path.join(root, "parallel_tp_gloo_out")
    batch_flags = ["--batch_size", str(TP_GLOO_BATCH)]
    cfg = cli.parse_args(main_argv(root, out, batch_flags))
    loader, _, _ = DATALOADER_DICT["msrvtt"]["train"](cfg, SimpleTokenizer(),
                                                      device=dev)
    ref = clustered_steps(torch, cfg, first_batches(loader, 1), counters,
                          "parallel tp gloo unwrapped", dev, timed=1)
    parallel.init_distributed(dev, backend="gloo")
    world = dist.get_world_size()
    result = {"unwrapped": {k: v for k, v in ref.items()
                            if k not in ("params", "grads1", "clusters")}}
    for label, extra in (("tp", []), ("tp_sp", ["--sequence_parallel", "1"])):
        print(f"parallel tp gloo rank {dist.get_rank()}: {label}",
              flush=True)
        result[label] = grouped_steps(
            torch, root, out, batch_flags + ["--tensor_parallel", str(world)]
            + extra, counters, f"parallel tp gloo {label}", dev, ref,
            timed=1)
    ranks = [None] * world
    dist.all_gather_object(ranks, result)
    if dist.get_rank() == 0:
        with open(out_path, "w") as f:
            json.dump(ranks, f)
    parallel.process_barrier("tp_gloo_leg_done")
    dist.destroy_process_group()


def parallel_leg_pp_gloo(torch, np, root, out_path):
    """Leg (b''), PP_GLOO_RANKS gloo ranks sharing cuda:0 as a (data 1, pipe
    PP_GLOO_RANKS) mesh at TP_GLOO_BATCH clips: each rank first takes the
    one-process step on the same batch (before the process group exists),
    then the first step under pipeline parallelism (one compared and one
    timed step), held to it by TP_LOSS_RTOL and TP_GRAD_MIN_COS (see
    PP_GLOO_RANKS); the stages' cluster inputs and medoid ids and the
    parameters after the step compared to the bit; A, C and E held
    against their plain versions on the first input of each shape the
    step gave them on this rank, B and D on the same inputs; every rank's
    counts and rows handed to rank 0."""
    from centerclip_tpu_torch import cli, parallel
    from centerclip_tpu_torch.data.registry import DATALOADER_DICT
    from centerclip_tpu_torch.models.tokenizer import SimpleTokenizer
    import torch.distributed as dist
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    counters = kernel_counters()
    out = os.path.join(root, "parallel_pp_gloo_out")
    batch_flags = ["--batch_size", str(TP_GLOO_BATCH)]
    cfg = cli.parse_args(main_argv(root, out, batch_flags))
    loader, _, _ = DATALOADER_DICT["msrvtt"]["train"](cfg, SimpleTokenizer(),
                                                      device=dev)
    ref = clustered_steps(torch, cfg, first_batches(loader, 1), counters,
                          "parallel pp gloo unwrapped", dev, timed=1)
    parallel.init_distributed(dev, backend="gloo")
    world, rank = dist.get_world_size(), dist.get_rank()
    print(f"parallel pp gloo rank {rank}: pp", flush=True)
    seen = {}
    res = grouped_steps(torch, root, out, batch_flags + [
        "--pipeline_parallel", str(world)], counters, "parallel pp gloo",
        dev, ref, timed=1, seen=seen)
    res["held"] = hold_recorded(torch, seen, f"pp gloo rank {rank}",
                                "the pipelined step", ALL_KERNELS)
    result = {"unwrapped": {k: v for k, v in ref.items()
                            if k not in ("params", "grads1", "clusters")},
              "pp": res}
    ranks = [None] * world
    dist.all_gather_object(ranks, result)
    if rank == 0:
        with open(out_path, "w") as f:
            json.dump(ranks, f)
    parallel.process_barrier("pp_gloo_leg_done")
    dist.destroy_process_group()


def collective_bandwidth(torch, dev, world, mib=256, iters=5):
    """NCCL's all-reduce and all-gather over the ranks on `mib` MiB of
    fp32 (the size of a ViT-B/32 step's ~0.6 GB of gradients, in a few
    buckets): median ms by CUDA events after a warm-up, and the bus
    bandwidth in GB/s (nccl-tests' convention: all-reduce moves
    2 (n - 1) / n of the bytes per rank, all-gather (n - 1) / n)."""
    import torch.distributed as dist
    n = mib << 18
    x = torch.ones(n, device=dev)
    out = x.new_empty(n * world)
    res = {}
    for name, fn, factor in (
            ("all_reduce", lambda: dist.all_reduce(x), 2 * (world - 1) / world),
            ("all_gather", lambda: dist.all_gather_into_tensor(out, x),
             (world - 1) / world)):
        fn()
        times = []
        for _ in range(iters):
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        ms = sorted(times)[iters // 2]
        nbytes = n * 4 * (world if name == "all_gather" else 1)
        res[name] = dict(ms=ms, bus_gbps=nbytes * factor / ms / 1e6)
    return dict(mib=mib, **res)


def parallel_leg_multi(torch, np, root, out_path):
    """Leg (c), one NCCL rank per card of a machine with several
    (`chip_smoke.py --gpus N`): each rank first takes the one-process
    step at the global batch of 128 on its own card (before the process
    group exists), then the first step under DDP and under FSDP at
    128 / N rows a rank, held to it as leg (b) is, and on each mesh of
    TP_MULTI_MESHES and PP_MULTI_MESHES, held to it as legs (b') and
    (b'') are; then `main --fsdp 1` over the N ranks (the ranks encode the
    evaluation, rank 0 scores it and writes)."""
    from centerclip_tpu_torch import cli, parallel
    from centerclip_tpu_torch.data.registry import DATALOADER_DICT
    from centerclip_tpu_torch.main import main as run_main
    from centerclip_tpu_torch.models.tokenizer import SimpleTokenizer
    world = int(os.environ["WORLD_SIZE"])
    dev = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    torch.cuda.set_device(dev)
    counters = kernel_counters()
    out = os.path.join(root, "parallel_multi_out")
    tok = SimpleTokenizer()
    cfg = cli.parse_args(main_argv(root, out))
    loader, _, _ = DATALOADER_DICT["msrvtt"]["train"](cfg, tok, device=dev)
    ref = clustered_steps(torch, cfg, first_batches(loader, 1), counters,
                          "parallel multi unwrapped", dev)
    parallel.init_distributed()
    rank = parallel.mesh.process_index()
    bandwidth = collective_bandwidth(torch, dev, world)
    dp = main_argv(root, out, ["--data_parallel", str(world)])
    loader, _, _ = DATALOADER_DICT["msrvtt"]["train"](cli.parse_args(dp),
                                                      tok, device=dev)
    batch = first_batches(loader, 1)
    result = {"rank_rows": len(batch[0]["input_ids"]),
              "bandwidth": bandwidth, "unwrapped": {
        k: v for k, v in ref.items()
        if k not in ("params", "grads1", "clusters")}}
    for label, extra in (("ddp", []), ("fsdp", ["--fsdp", "1"])):
        r = parallel_steps(torch, cli.parse_args(dp + extra), batch,
                           counters, f"parallel multi {label}", dev)
        result[label] = held_to_one_process(r, ref["losses"][0],
                                            ref["grads1"])
    for label, extra in TP_MULTI_MESHES + PP_MULTI_MESHES:
        result[label] = grouped_steps(
            torch, root, out, ["--data_parallel", str(world)] + extra,
            counters, f"parallel multi {label}", dev, ref)
    main_out = os.path.join(root, "parallel_multi_main")
    zero_counts(counters)
    t0 = time.time()
    run_main(main_argv(root, main_out, ["--data_parallel", str(world),
                                        "--fsdp", "1"]))
    result["main_fsdp"] = dict(
        run_s=time.time() - t0, counts=path_counts_of(
            counters, "parallel multi main", backward=True))
    if rank == 0:
        with open(os.path.join(main_out, "log.txt")) as f:
            log = f.read()
        result["main_fsdp"].update(
            files=sorted(os.listdir(main_out)),
            logged_processes=f"processes: {world}" in log,
            evaluated="Text-to-Video: R@1" in log)
        with open(out_path, "w") as f:
            json.dump(result, f)


MULTI_MAIN_FLAGS = {
    "multi_main_tp": ["--tensor_parallel", "2", "--sequence_parallel", "1"],
    "multi_main_pp": ["--pipeline_parallel", "2"]}


def multi_main_run(torch, root, leg):
    """`main <MULTI_MAIN_FLAGS[leg]>` over the N ranks of leg (c) (the ranks
    encode the evaluation, rank 0 scores it and writes); its run time and
    counts, and on rank 0 its log's checks and its export loaded with
    `strict=True` into a model of one process."""
    from centerclip_tpu_torch import cli
    from centerclip_tpu_torch.main import main as run_main
    from centerclip_tpu_torch.models.clip4clip import CLIP4Clip
    world = int(os.environ["WORLD_SIZE"])
    dev = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    torch.cuda.set_device(dev)
    counters = kernel_counters()
    main_out = os.path.join(root, f"parallel_{leg}")
    argv = main_argv(root, main_out, ["--data_parallel", str(world)]
                     + MULTI_MAIN_FLAGS[leg])
    zero_counts(counters)
    gathers = {}
    t0 = time.time()
    with recording_gathers(gathers):
        run_main(argv)
    result = dict(run_s=time.time() - t0, counts=path_counts_of(
        counters, f"parallel multi {leg}", backward=True),
        eval_gather_s=[b - a for a, b in gathers["gathers"]])
    if int(os.environ["RANK"]) == 0:
        with open(os.path.join(main_out, "log.txt")) as f:
            log = f.read()
        model = CLIP4Clip(cli.parse_args(argv).model, device=dev, seed=1)
        sd = torch.load(os.path.join(main_out, "ckpt.pth.tar"),
                        map_location=dev, weights_only=False)["state_dict"]
        model.load_state_dict(sd, strict=True)
        in_proj = sd["clip.visual.transformer.resblocks.0.attn.in_proj_weight"]
        result.update(files=sorted(os.listdir(main_out)),
                      logged_processes=f"processes: {world}" in log,
                      evaluated="Text-to-Video: R@1" in log,
                      export_reloads_strict=True,
                      export_in_proj_shape=list(in_proj.shape),
                      export=os.path.join(main_out, "ckpt.pth.tar"))
    return result


def parallel_leg_multi_main_tp(torch, np, root, out_path):
    """Leg (c)'s TP run of `main` (`multi_main_run`)."""
    result = multi_main_run(torch, root, "multi_main_tp")
    if int(os.environ["RANK"]) == 0:
        with open(out_path, "w") as f:
            json.dump(result, f)


def parallel_leg_multi_main_pp(torch, np, root, out_path):
    """Leg (c)'s PP run of `main` (`multi_main_run`)."""
    result = multi_main_run(torch, root, "multi_main_pp")
    if int(os.environ["RANK"]) == 0:
        with open(out_path, "w") as f:
            json.dump(result, f)


@contextlib.contextmanager
def recording_gathers(store):
    """Within the block, append to `store["gathers"]` the host-clock
    (start, end) of each `torch.distributed.gather_object` call (the
    spread evaluation's gather of the features to rank 0)."""
    import torch.distributed as dist
    gather_fn = dist.gather_object
    store.setdefault("gathers", [])

    def timed(*a, **k):
        t0 = time.time()
        out = gather_fn(*a, **k)
        store["gathers"].append((t0, time.time()))
        return out
    dist.gather_object = timed
    try:
        yield store
    finally:
        dist.gather_object = gather_fn


def parallel_leg_multi_eval(torch, np, root, out_path):
    """The evaluation of leg (c)'s PP export on the GALLERY_ROWS rows of
    gallery.csv, twice: by `main --do_train 0` over the N ranks (each
    loads and encodes every N-th batch of the recipe's 128, rank 0
    scores), then, once its process group is gone, by `main --do_train
    0` in rank 0's process alone while the other ranks exit; the metrics
    and similarity matrices compared, with the seconds of each run and of
    its phase 1.  Every rank first encodes one batch, so that neither run
    pays the first launches; in the spread run each rank notes when its
    phase 1 began, when it reached the gather to rank 0 and when the
    gather returned (host clock).  (A second `init_process_group` in one
    torchrun worker failed to connect on the card, so each launch makes
    one process group.)"""
    from centerclip_tpu_torch import cli
    from centerclip_tpu_torch.data.registry import DATALOADER_DICT
    from centerclip_tpu_torch.main import main as run_main
    from centerclip_tpu_torch.models.clip4clip import CLIP4Clip
    from centerclip_tpu_torch.models.tokenizer import SimpleTokenizer
    from centerclip_tpu_torch.train.evaluate import Evaluator
    dev = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    torch.cuda.set_device(dev)
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    export = os.path.join(root, "parallel_multi_main_pp", "ckpt.pth.tar")
    flags = ["--do_train", "0", "--init_model", export,
             "--val_csv", os.path.join(root, "gallery.csv")]
    argv = main_argv(root, os.path.join(root, "parallel_eval_spread"), flags)
    cfg = cli.parse_args(argv)
    model = CLIP4Clip(cfg.model, device=dev, seed=1)
    sd = torch.load(export, map_location=dev, weights_only=False)
    model.load_state_dict(sd["state_dict"], strict=True)
    slots = DATALOADER_DICT["msrvtt"]
    test_fn = slots["test"] if slots["test"] is not None else slots["val"]
    loader, rows = test_fn(cfg, SimpleTokenizer(), device=dev)
    Evaluator(model.eval()).cache_features(first_batches(loader, 1))
    del model, sd
    marks = {}
    cache_fn = Evaluator.cache_features

    def timed_cache(self, *a, **k):
        marks["enter"] = time.time()
        out = cache_fn(self, *a, **k)
        marks["exit"] = time.time()
        with open(os.path.join(root, f"eval_marks_{rank}.json"), "w") as f:
            json.dump(marks, f)
        return out
    Evaluator.cache_features = timed_cache
    try:
        with recording_gathers(marks):
            t0 = time.time()
            spread = run_main(argv)
            spread_s = time.time() - t0
    finally:
        Evaluator.cache_features = cache_fn
    if rank != 0:
        return
    # every rank wrote its marks before main's closing barrier
    by_rank = []
    for r in range(world):
        with open(os.path.join(root, f"eval_marks_{r}.json")) as f:
            by_rank.append(json.load(f))
    first = min(m["enter"] for m in by_rank)
    # the same evaluation in a run of one process (no process group)
    os.environ.pop("WORLD_SIZE")
    t0 = time.time()
    alone = run_main(main_argv(root, os.path.join(root, "parallel_eval"),
                               flags))
    alone_s = time.time() - t0
    result = dict(
        ranks=world, rows=rows, spread_s=spread_s, alone_s=alone_s,
        spread_infer_s=spread["infer_time"],
        alone_infer_s=alone["infer_time"],
        # by rank: its phase 1's start after the first rank's, its own
        # loading and encoding, and its wait in the gather
        spread_phase1_by_rank=[dict(
            start_after_first_s=m["enter"] - first,
            own_s=m["gathers"][0][0] - m["enter"],
            gather_s=m["gathers"][0][1] - m["gathers"][0][0])
            for m in by_rank],
        t2v_alone=alone["t2v"],
        t2v_spread=spread["t2v"], v2t_alone=alone["v2t"],
        v2t_spread=spread["v2t"], metrics_equal=(
            alone["t2v"] == spread["t2v"] and alone["v2t"] == spread["v2t"]),
        sim_max_abs_diff=float(np.abs(alone["sim_matrix"]
                                      - spread["sim_matrix"]).max()),
        shape=list(spread["sim_matrix"].shape))
    with open(out_path, "w") as f:
        json.dump(result, f, default=lambda o: o.tolist()
                  if hasattr(o, "tolist") else float(o))


def multi_gpu_main(n: int) -> int:
    """`chip_smoke.py --gpus N`: leg (c) alone on N cards (build, main's
    fixture, one torchrun launch of N ranks); prints the cards, the
    checks, a `{"multi_gpu": ...}` line and last the `{"ok": ...}` line."""
    import numpy as np
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < n:
        print(f"chip_smoke: needs {n} CUDA devices", file=sys.stderr)
        return 2
    import tempfile
    from centerclip_tpu_torch.ops import _build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    print("\n".join(smi))
    t0 = time.time()
    _build.build(_build.KERNEL_SOURCES + _build.HOST_SOURCES, force=True)
    print(f"built in {time.time() - t0:.2f} s")
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as root:
        write_msrvtt_fixture(np, root)
        res, t_leg = torchrun_leg(n, "multi", root)
        main_tp, t_main_tp = torchrun_leg(n, "multi_main_tp", root)
        main_pp, t_main_pp = torchrun_leg(n, "multi_main_pp", root)
        ev, t_eval = torchrun_leg(n, "multi_eval", root)
        serve_dp = serve_data_parallel(torch, np, root, main_pp["export"],
                                       n)
    un = res["unwrapped"]
    bw = res["bandwidth"]
    print(f"NCCL over {n} cards, {bw['mib']} MiB fp32 a rank: all_reduce "
          f"{bw['all_reduce']['ms']:.3f} ms ({bw['all_reduce']['bus_gbps']:.1f}"
          f" GB/s bus), all_gather {bw['all_gather']['ms']:.3f} ms "
          f"({bw['all_gather']['bus_gbps']:.1f} GB/s bus)")
    print(f"one process, batch {MAIN_BATCH}, one card: median step "
          f"{un['step_ms']:.3f} ms, peak {un['peak_bytes'] / 2**30:.3f} GiB")
    for label in ("ddp", "fsdp"):
        r = res[label]
        print(f"multi {label}, {n} NCCL ranks x {res['rank_rows']} clips "
              f"({smi[0]}): loss {r['loss']} vs one process "
              f"{r['loss_one_process']} (rel {r['loss_rel']:.3e}, tol "
              f"{PARALLEL_LOSS_RTOL}); gradient cosine min "
              f"{r['grad_min_cos']:.6f} (min {PARALLEL_GRAD_MIN_COS}); "
              f"median step {r['step_ms']:.3f} ms = "
              f"{un['step_ms'] / r['step_ms']:.2f}x the one-card step; peak "
              f"{r['peak_bytes'] / 2**30:.3f} GiB; kernel D on streams "
              f"{r['d_streams']}, tickets dirty {r['d_tickets_dirty']}")
        if r["loss_rel"] > PARALLEL_LOSS_RTOL or not r["grad_keys_equal"] \
                or r["grad_min_cos"] < PARALLEL_GRAD_MIN_COS:
            fail(f"multi {label} differs from the one-process step")
        if not r["d_on_default_stream"] or r["d_tickets_dirty"]:
            fail(f"multi {label}: kernel D left the compute stream")
        launched(f"multi {label}", r["counts"][0], r["counts"][0].keys())
    ddp = res["ddp"]
    for label, _ in TP_MULTI_MESHES:
        r = res[label]
        print(f"multi {label}, {n} NCCL ranks x {r['rank_rows']} clips a "
              f"model group ({smi[0]}): loss {r['loss']} vs one process "
              f"{r['loss_one_process']} (rel {r['loss_rel']:.3e}, tol "
              f"{TP_LOSS_RTOL}); gradient cosine min {r['grad_min_cos']:.6f}"
              f" (min {TP_GRAD_MIN_COS}; worst {r['grad_worst']}); median "
              f"step {r['step_ms']:.3f} ms (DDP {ddp['step_ms']:.3f}, one "
              f"card {un['step_ms']:.3f}); peak "
              f"{r['peak_bytes'] / 2**30:.3f} GiB (DDP "
              f"{ddp['peak_bytes'] / 2**30:.3f}); cluster input "
              f"{r['cluster_input_shape']} equal on the model group "
              f"{r['cluster_input_equal']}, medoid ids {r['medoids_equal']}"
              f", segments whose ids differ from the one-process step's "
              f"{r['medoid_segments_differing']} of {r['medoid_segments']}"
              f", ids {r['medoid_ids_differing']:.4f} (replayed)")
        check_tp_run(f"multi {label}", r)
    for label, _ in PP_MULTI_MESHES:
        r = res[label]
        print(f"multi {label}, {n} NCCL ranks x {r['rank_rows']} clips a "
              f"pipe group ({smi[0]}): loss {r['loss']} vs one process "
              f"{r['loss_one_process']} (rel {r['loss_rel']:.3e}, tol "
              f"{TP_LOSS_RTOL}); gradient cosine min {r['grad_min_cos']:.6f}"
              f" (min {TP_GRAD_MIN_COS}; worst {r['grad_worst']}); "
              f"gradient length ratio furthest from 1 "
              f"{r['grad_norm_worst']} (tol {TP_GRAD_NORM_RTOL:.4f}); by "
              f"rank {r['held_by_rank']}; parameters differing between the "
              f"ranks {r['params_differing_on_ranks']}; median "
              f"step {r['step_ms']:.3f} ms (DDP {ddp['step_ms']:.3f}, one "
              f"card {un['step_ms']:.3f}); peak "
              f"{r['peak_bytes'] / 2**30:.3f} GiB (DDP "
              f"{ddp['peak_bytes'] / 2**30:.3f}); cluster input "
              f"{r['cluster_input_shape']} equal on the pipe group "
              f"{r['cluster_input_equal']}, medoid ids {r['medoids_equal']}"
              f", segments whose ids differ from the one-process step's "
              f"{r['medoid_segments_differing']} of {r['medoid_segments']}"
              f" (replayed); launches {r['counts'][0]}")
        check_tp_run(f"multi {label}", r)
    m = res["main_fsdp"]
    print(f"main --data_parallel {n} --fsdp 1: {m['run_s']:.2f} s, rank 0 "
          f"logged processes {m['logged_processes']}, evaluated "
          f"{m['evaluated']}, files {m['files']}")
    launched("multi main", m["counts"][0], m["counts"][0].keys())
    if not (m["logged_processes"] and m["evaluated"]
            and {"ckpt.pth.tar", "ckpt_0"} <= set(m["files"])):
        fail("multi main's log, evaluation or checkpoint is missing")
    m = main_tp
    print(f"main --data_parallel {n} --tensor_parallel 2 --sequence_parallel"
          f" 1: {m['run_s']:.2f} s ({t_main_tp:.1f} s with the launch), "
          f"rank 0 logged processes {m['logged_processes']}, evaluated "
          f"{m['evaluated']}, files {m['files']}, export reloads strict "
          f"{m['export_reloads_strict']} (in_proj "
          f"{m['export_in_proj_shape']})")
    launched("multi main tp", m["counts"][0], m["counts"][0].keys())
    if not (m["logged_processes"] and m["evaluated"]
            and {"ckpt.pth.tar", "ckpt_0"} <= set(m["files"])
            and m["export_in_proj_shape"] == [2304, 768]):
        fail("multi main tp's log, evaluation or export is wrong")
    m = main_pp
    print(f"main --data_parallel {n} --pipeline_parallel 2: "
          f"{m['run_s']:.2f} s ({t_main_pp:.1f} s with the launch; its "
          f"evaluation's gathers to rank 0 after training "
          f"{[round(x, 4) for x in m['eval_gather_s']]} s), rank 0 "
          f"logged processes "
          f"{m['logged_processes']}, evaluated {m['evaluated']}, files "
          f"{m['files']}, export reloads strict {m['export_reloads_strict']}")
    by_rank = [{k: round(v, 4) for k, v in m.items()}
               for m in ev["spread_phase1_by_rank"]]
    print(f"evaluation of its export on {ev['rows']} gallery rows "
          f"({ev['shape']} similarity, batches of {MAIN_BATCH}; "
          f"{smi[0]}): the eval-only `main` in one process "
          f"{ev['alone_s']:.3f} s (phase 1 {ev['alone_infer_s']:.3f} s), "
          f"spread over {ev['ranks']} ranks {ev['spread_s']:.3f} s (phase "
          f"1 on rank 0 {ev['spread_infer_s']:.3f} s; by rank {by_rank}; "
          f"{t_eval:.1f} s with the launch); metrics equal "
          f"{ev['metrics_equal']} (t2v "
          f"{ {k: v for k, v in ev['t2v_spread'].items() if k != 'cols'} }"
          f"), similarity max abs diff "
          f"{ev['sim_max_abs_diff']:.3e}")
    launched("multi main pp", m["counts"][0], m["counts"][0].keys())
    if not (m["logged_processes"] and m["evaluated"]
            and {"ckpt.pth.tar", "ckpt_0"} <= set(m["files"])
            and m["export_reloads_strict"]):
        fail("multi main pp's log, evaluation or export is wrong")
    if not ev["metrics_equal"] or ev["sim_max_abs_diff"] > SERVE_SCORE_ATOL:
        fail("the evaluation spread over the ranks differs from rank 0's")
    one, many = serve_dp["cards"][1], serve_dp["cards"][n]
    print(f"serve CLI build --data_parallel {n} ({smi[0]}): "
          f"{serve_dp['clips']} clips, {one['clips_per_s']:.2f} clips/s on "
          f"one card, {many['clips_per_s']:.2f} on {n} (the second build "
          f"each, host clock, in batches of {SERVE_MULTI_BATCH}): loading "
          f"{one['load_s']:.4f} s / {many['load_s']:.4f} s, the cards' "
          f"encode {one['encode_s']:.4f} s / {many['encode_s']:.4f} s "
          f"({one['encode_clips_per_s']:.2f} / "
          f"{many['encode_clips_per_s']:.2f} clips/s); the loaded batches "
          f"encoded again to {one['gallery_clips']} clips: "
          f"{one['gallery_clips_per_s']:.2f} clips/s on one card, "
          f"{many['gallery_clips_per_s']:.2f} on {n}; codes max abs diff "
          f"{serve_dp['codes_max_abs_diff']:.3e}; query scores max abs diff "
          f"{serve_dp['scores_max_abs_diff']:.3e} (tol {SERVE_SCORE_ATOL}), "
          f"ranked ids equal in {serve_dp['ids_equal']} of "
          f"{serve_dp['queries']} queries, unequal only where the scores "
          f"tie within the tolerance: {serve_dp['ids_consistent']}; IVF "
          f"refused: {serve_dp['ivf_refused']}")
    if serve_dp["scores_max_abs_diff"] > SERVE_SCORE_ATOL \
            or not serve_dp["ids_consistent"] or not serve_dp["ivf_refused"]:
        fail(f"the serve CLI over {n} cards differs from one card")
    print(json.dumps({"multi_gpu": dict(cards=smi, leg_s=t_leg,
                                        main_tp=main_tp, main_pp=main_pp,
                                        evaluation=ev,
                                        serve_data_parallel=serve_dp, **{
        k: v for k, v in res.items()})}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def serve_data_parallel(torch, np, root, ckpt, n):
    """The serve CLI on main's fixture from checkpoint `ckpt`, in this
    process: `build` (float32, one gallery batch of SERVE_MULTI_BATCH
    clips) twice on one card and twice with `--data_parallel n`, each
    encode timed (host clock, all cards synchronised) in two parts: the
    loading of its batches, and `embed_video_batches` on the loaded
    batches, once and repeated to about GALLERY_ROWS clips; `query` of
    the 48 captions (top 10) from each index;
    then `build --index_type ivf --data_parallel n`, which must raise.
    Returns the rates, the differences and the checks."""
    import csv
    import io
    from centerclip_tpu_torch.serve import cli as serve_cli
    from centerclip_tpu_torch.serve import engine as engine_mod
    flags = main_argv(root, os.path.join(root, "serve_dp"), [
        "--init_model", ckpt, "--batch_size_val", str(SERVE_MULTI_BATCH)])
    with open(os.path.join(root, "test.csv"), newline="") as f:
        captions = [r[1] for r in list(csv.reader(f))[1:]]
    qfile = os.path.join(root, "serve_dp_queries.txt")
    with open(qfile, "w") as f:
        f.write("".join(c + "\n" for c in captions))
    embed = engine_mod.RetrievalEngine.embed_video_batches
    times = []

    def synced(self, fn):
        t0 = time.time()
        out = fn()
        for d in self.devices:
            torch.cuda.synchronize(d)
        return out, time.time() - t0

    def timed_embed(self, batches):
        # the host's share (read, decode, pin) apart from the cards':
        # encode the loaded batches, then them again and again, a gallery
        # of about GALLERY_ROWS clips
        loaded, load_s = synced(self, lambda: list(batches))
        out, encode_s = synced(self, lambda: embed(self, loaded))
        reps = -(-GALLERY_ROWS // len(out))
        _, gallery_s = synced(self, lambda: embed(self, loaded * reps))
        times.append(dict(clips=len(out), seconds=load_s + encode_s,
                          load_s=load_s, encode_s=encode_s,
                          gallery_clips=len(out) * reps,
                          gallery_encode_s=gallery_s))
        return out
    engine_mod.RetrievalEngine.embed_video_batches = timed_embed
    quiet = io.StringIO()
    built, ranked, rate = {}, {}, {}
    try:
        with contextlib.redirect_stdout(quiet):
            for cards in (1, n):
                path = os.path.join(root, f"gallery_dp{cards}.npz")
                argv = ["--data_parallel", str(cards)] + flags
                for _ in range(2):
                    built[cards] = serve_cli.main(
                        ["build", "--index_path", path] + argv)
                t = times[-1]
                rate[cards] = dict(
                    t, clips_per_s=t["clips"] / t["seconds"],
                    encode_clips_per_s=t["clips"] / t["encode_s"],
                    gallery_clips_per_s=t["gallery_clips"]
                    / t["gallery_encode_s"])
                ranked[cards] = serve_cli.main(
                    ["query", "--index_path", path, "--queries_file", qfile,
                     "--topk", "10"] + argv)
            try:
                serve_cli.main(["build", "--index_path", os.path.join(
                    root, "gallery_dp_ivf.npz"), "--index_type", "ivf",
                    "--data_parallel", str(n)] + flags)
                ivf_refused = False
            except ValueError:
                ivf_refused = True
    finally:
        engine_mod.RetrievalEngine.embed_video_batches = embed
    one, many = ranked[1], ranked[n]
    ids_equal, consistent, diff = 0, True, 0.0
    for a, b in zip(one, many):
        ia, ib = [r["video_id"] for r in a], [r["video_id"] for r in b]
        sa = np.array([r["score"] for r in a])
        sb = np.array([r["score"] for r in b])
        diff = max(diff, float(np.abs(sa - sb).max()))
        ids_equal += ia == ib
        for i, (x, y) in enumerate(zip(ia, ib)):
            # a position may hold another id only where its neighbours'
            # scores lie within the tolerance of its own
            near = [j for j in (i - 1, i + 1) if 0 <= j < len(sa)
                    and abs(sa[j] - sa[i]) <= SERVE_SCORE_ATOL]
            if x != y and not near:
                consistent = False
    return dict(clips=len(built[n]), cards={1: rate[1], n: rate[n]},
                devices=[str(d) for d in built[n].devices],
                codes_max_abs_diff=float((built[n]._codes.cpu()
                                          - built[1]._codes.cpu()).abs()
                                         .max()),
                scores_max_abs_diff=diff, ids_equal=ids_equal,
                queries=len(one), ids_consistent=consistent,
                ivf_refused=ivf_refused)


def torchrun_leg(nproc, leg, root):
    """Run `chip_smoke.py --parallel-leg <leg>` under
    `python -m torch.distributed.run` with `nproc` processes (its own
    session, killed whole on the time limit); fails if any rank fails.
    Returns the leg's JSON and its wall time."""
    out_path = os.path.join(root, f"parallel_{leg}.json")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", str(nproc), os.path.abspath(__file__),
           "--parallel-leg", leg, root, out_path]
    t0 = time.time()
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    try:
        log, _ = proc.communicate(timeout=PARALLEL_TIMEOUT)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, 9)
        log, _ = proc.communicate()
        fail(f"parallel leg {leg} ran past {PARALLEL_TIMEOUT} s:\n"
             f"{log[-4000:]}")
    lines = [ln for ln in log.splitlines()
             if ln.startswith(("attention launches", "parallel"))]
    for ln in lines:
        print(f"  [{leg}] {ln}")
    if proc.returncode != 0:
        fail(f"parallel leg {leg} exited {proc.returncode}:\n{log[-6000:]}")
    with open(out_path) as f:
        return json.load(f), time.time() - t0


# kernels A-D at the per-rank shapes of leg (c)'s meshes at the global
# batch of 128: (2, 2) gives a model group 64 clips, (1, 4) 128; vision
# blocks 1-6 (12 frames, L = 50), the text tower (32 tokens, causal), and
# under SP the token chunks ceil(50 / tp) and 32 / tp
TP_ATTENTION_CASES = (("tp 2, vision blocks 1-6", 768, 50, 6, None),
                      ("tp 4, vision blocks 1-6", 1536, 50, 3, None),
                      ("tp 2, text", 64, 32, 4, "causal"),
                      ("tp 4, text", 128, 32, 2, "causal"))
TP_LAYERNORM_CASES = (("tp 2 + SP, vision ln_1/ln_2 blocks 1-6",
                       768 * 25, 768),
                      ("tp 4 + SP, vision ln_1/ln_2 blocks 1-6",
                       1536 * 13, 768),
                      ("tp 2 + SP, text ln_1/ln_2", 64 * 16, 512),
                      ("tp 4 + SP, text ln_1/ln_2", 128 * 8, 512))


def kernel_rows(torch, dev, flush, peaks, attention_cases,
                layernorm_cases):
    """Kernels A and B at `attention_cases`' shapes (TP_ATTENTION_CASES:
    the local heads; PP_ATTENTION_CASES: the microbatches) and C and D at
    `layernorm_cases`' rows, each against its plain version and timed
    beside SDPA or ATen (`hold_attention_bwd`, `hold_layernorm_bwd`); rows
    by kernel."""
    rows = {k: [] for k in ("attention_fwd", "attention_bwd",
                            "layernorm_fwd", "layernorm_bwd")}
    for case in attention_cases:
        row, fwd_row = hold_attention_bwd(torch, dev, flush, peaks, *case)
        rows["attention_bwd"].append(dict(row, label=case[0]))
        rows["attention_fwd"].append(dict(fwd_row, label=case[0]))
    for case in layernorm_cases:
        row, fwd_row = hold_layernorm_bwd(torch, dev, flush, peaks, *case)
        rows["layernorm_bwd"].append(dict(row, label=case[0]))
        rows["layernorm_fwd"].append(dict(fwd_row, label=case[0]))
    return rows


def check_tp_run(label, r, ranks=None):
    """Fail a tensor- or pipeline-parallel run (`grouped_steps`) whose
    step on any rank differs from the one-process step beyond
    TP_LOSS_RTOL / TP_GRAD_MIN_COS / TP_GRAD_NORM_RTOL, whose ranks hold
    other parameters after a pipelined step, whose model group clustered
    different tokens or picked other medoids, whose kernel D left the
    compute stream, or in which a kernel did not launch (on every rank in
    `ranks`, else this one)."""
    for i, h in enumerate(r["held_by_rank"]):
        if h["loss_rel"] > TP_LOSS_RTOL or not h["grad_keys_equal"] \
                or h["grad_min_cos"] < TP_GRAD_MIN_COS \
                or abs(h["grad_norm_worst"][1] - 1) > TP_GRAD_NORM_RTOL:
            fail(f"{label} rank {i} differs from the one-process step: "
                 f"{h}")
    if r.get("params_differing_on_ranks"):
        fail(f"{label}: parameters differ between the ranks after the "
             f"step: {r['params_differing_on_ranks'][:5]}")
    if not (r["cluster_input_equal"] and r["medoids_equal"]):
        fail(f"{label}: the ranks of a model group clustered differently")
    if not r["d_on_default_stream"] or r["d_tickets_dirty"]:
        fail(f"{label}: kernel D left the compute stream")
    for i, rr in enumerate(ranks or [r]):
        launched(f"{label} rank {i}", rr["counts"][0],
                 rr["counts"][0].keys())


def parallel_phase(torch, np, root, smi):
    """The eleventh to thirteenth main paths (see PARALLEL_STEPS,
    TP_GLOO_BATCH and PP_GLOO_RANKS): leg (a) on one NCCL rank, leg (b) on
    GLOO_RANKS gloo ranks sharing the card, leg (b') on TP_GLOO_RANKS gloo
    ranks as a model group, leg (b'') on PP_GLOO_RANKS as a pipe group;
    their checks, times and counts, and the rows of A, C and E held on
    leg (b'')'s shapes."""
    torch.cuda.empty_cache()
    single, t_single = torchrun_leg(1, "single", root)
    paths = {}
    unwrapped = single["unwrapped"]
    for label in ("ddp", "fsdp"):
        r = single[label]
        paths[f"parallel_{label}"] = tuple(r["counts"])
        print(f"parallel {label}, one NCCL rank, {smi}: losses {r['losses']}"
              f" (unwrapped {unwrapped['losses']}, equal "
              f"{r['losses_equal']}); parameters differing after "
              f"{PARALLEL_STEPS} steps {r['params_differing']}; step-1 "
              f"gradients differing {r['grads1_differing']}; median step "
              f"{r['step_ms']:.3f} ms (unwrapped {unwrapped['step_ms']:.3f}"
              f", overhead {r['step_ms'] - unwrapped['step_ms']:+.3f} ms); "
              f"peak {r['peak_bytes'] / 2**30:.3f} GiB (unwrapped "
              f"{unwrapped['peak_bytes'] / 2**30:.3f}); kernel D launches "
              f"{r['d_launches']} on streams {r['d_streams']}, tickets "
              f"dirty {r['d_tickets_dirty']}")
        if not r["losses_equal"] or r["params_differing"] \
                or r["grads1_differing"]:
            fail(f"parallel {label} differs from the unwrapped steps")
        if not r["d_on_default_stream"] or r["d_tickets_dirty"]:
            fail(f"parallel {label}: kernel D left the compute stream or "
                 f"its tickets dirty")
        launched(f"parallel {label}", r["counts"][0], r["counts"][0].keys())
    m = single["main_fsdp"]
    paths["parallel_main_fsdp"] = tuple(m["counts"])
    print(f"parallel main --fsdp 1 on one rank: {m['run_s']:.2f} s, step "
          f"times {[round(x, 3) for x in m['step_ms_all']]} ms, R@1 "
          f"{m['R1']}, reload equal {m['reload_equal']}, files "
          f"{m['files']}")
    launched("parallel main", m["counts"][0], m["counts"][0].keys())
    if not m["reload_equal"] or m["best_r1"] != m["R1"] or not {
            "ckpt.pth.tar", "ckpt_0"} <= set(m["files"]):
        fail("parallel main's evaluation, checkpoint or reload is wrong")
    gloo, t_gloo = torchrun_leg(GLOO_RANKS, "gloo", root)
    print(f"gloo on CUDA tensors: {gloo['gloo_cuda']}")
    for label in ("ddp", "fsdp"):
        if label not in gloo:
            print(f"parallel gloo {label}: not run, gloo refuses its "
                  f"collectives on CUDA tensors")
            continue
        r = gloo[label]
        paths[f"parallel_gloo_{label}"] = tuple(r["counts"])
        print(f"parallel gloo {label}, {GLOO_RANKS} ranks x "
              f"{gloo['rank_rows']} clips on one card: loss {r['loss']} vs "
              f"one process {r['loss_one_process']} (rel "
              f"{r['loss_rel']:.3e}, tol {PARALLEL_LOSS_RTOL}); gradient "
              f"cosine min {r['grad_min_cos']:.6f} (min "
              f"{PARALLEL_GRAD_MIN_COS}; worst {r['grad_worst']}); one "
              f"timed step {r['step_ms']:.3f} ms (two processes on one "
              f"card: no multi-GPU speed)")
        if r["loss_rel"] > PARALLEL_LOSS_RTOL or not r["grad_keys_equal"] \
                or r["grad_min_cos"] < PARALLEL_GRAD_MIN_COS:
            fail(f"parallel gloo {label} differs from the one-process step")
        if not r["d_on_default_stream"] or r["d_tickets_dirty"]:
            fail(f"parallel gloo {label}: kernel D left the compute stream")
        launched(f"parallel gloo {label}", r["counts"][0],
                 r["counts"][0].keys())
    tp_ranks, t_tp = torchrun_leg(TP_GLOO_RANKS, "tp_gloo", root)
    tp = tp_ranks[0]
    for label in ("tp", "tp_sp"):
        r = tp[label]
        paths[f"parallel_gloo_{label}"] = tuple(r["counts"])
        print(f"parallel gloo {label}, ({TP_GLOO_RANKS} ranks, data 1 x "
              f"model {TP_GLOO_RANKS}) x {r['rank_rows']} clips on one "
              f"card: loss {r['loss']} vs one process "
              f"{r['loss_one_process']} (rel {r['loss_rel']:.3e}, tol "
              f"{TP_LOSS_RTOL}); gradient cosine min "
              f"{r['grad_min_cos']:.6f} (min {TP_GRAD_MIN_COS}; worst "
              f"{r['grad_worst']}); cluster input "
              f"{r['cluster_input_shape']} equal on the ranks "
              f"{r['cluster_input_equal']}, medoid ids "
              f"{r['medoids_equal']}, segments whose ids differ from the "
              f"one-process step's {r['medoid_segments_differing']} of "
              f"{r['medoid_segments']}, ids "
              f"{r['medoid_ids_differing']:.4f} (replayed); launches by "
              f"rank "
              f"{[rr[label]['counts'][0] for rr in tp_ranks]}; one timed "
              f"step {r['step_ms']:.3f} ms, peak "
              f"{r['peak_bytes'] / 2**30:.3f} GiB")
        check_tp_run(f"parallel gloo {label}", r,
                     [rr[label] for rr in tp_ranks])
    pp_ranks, t_pp = torchrun_leg(PP_GLOO_RANKS, "pp_gloo", root)
    r = pp_ranks[0]["pp"]
    paths["parallel_gloo_pp"] = tuple(r["counts"])
    print(f"parallel gloo pp, ({PP_GLOO_RANKS} ranks, data 1 x pipe "
          f"{PP_GLOO_RANKS}) x {r['rank_rows']} clips on one card: loss "
          f"{r['loss']} vs one process {r['loss_one_process']} (rel "
          f"{r['loss_rel']:.3e}, tol {TP_LOSS_RTOL}); gradient cosine min "
          f"{r['grad_min_cos']:.6f} (min {TP_GRAD_MIN_COS}; worst "
          f"{r['grad_worst']}); gradient length ratio furthest from 1 "
          f"{r['grad_norm_worst']} (tol {TP_GRAD_NORM_RTOL:.4f}); by rank "
          f"{r['held_by_rank']}; parameters differing between the ranks "
          f"after the step {r['params_differing_on_ranks']}; cluster input "
          f"{r['cluster_input_shape']} "
          f"equal on the stages {r['cluster_input_equal']}, medoid ids "
          f"{r['medoids_equal']}, segments whose ids differ from the "
          f"one-process step's {r['medoid_segments_differing']} of "
          f"{r['medoid_segments']} (replayed); launches by rank "
          f"{[rr['pp']['counts'][0] for rr in pp_ranks]}; one timed step "
          f"{r['step_ms']:.3f} ms (one process "
          f"{pp_ranks[0]['unwrapped']['step_ms']:.3f}), peak "
          f"{r['peak_bytes'] / 2**30:.3f} GiB (one process "
          f"{pp_ranks[0]['unwrapped']['peak_bytes'] / 2**30:.3f}); A-E "
          f"held on the inputs rank 0 gave them: "
          f"{ {k: [row['shape'] for row in v] for k, v in r['held'].items()} }")
    check_tp_run("parallel gloo pp", r, [rr["pp"] for rr in pp_ranks])
    summary = dict(card=smi, single_s=t_single, gloo_s=t_gloo,
                   tp_gloo_s=t_tp, pp_gloo_s=t_pp, gloo_cuda=gloo["gloo_cuda"])
    summary["gloo_pp"] = dict(
        rank_rows=r["rank_rows"], loss_rel=r["loss_rel"],
        grad_min_cos=r["grad_min_cos"], grad_worst=r["grad_worst"],
        grad_norm_worst=r["grad_norm_worst"], held_by_rank=r["held_by_rank"],
        params_differing_on_ranks=r["params_differing_on_ranks"],
        step_ms=r["step_ms"], peak_bytes=r["peak_bytes"],
        unwrapped_step_ms=pp_ranks[0]["unwrapped"]["step_ms"],
        unwrapped_peak_bytes=pp_ranks[0]["unwrapped"]["peak_bytes"],
        cluster_input_equal=r["cluster_input_equal"],
        medoids_equal=r["medoids_equal"],
        medoid_segments_differing=r["medoid_segments_differing"],
        medoid_ids_differing=r["medoid_ids_differing"],
        launches_by_rank=[rr["pp"]["counts"][0] for rr in pp_ranks])
    for label in ("tp", "tp_sp"):
        r = tp[label]
        summary[f"gloo_{label}"] = dict(
            rank_rows=r["rank_rows"], loss_rel=r["loss_rel"],
            grad_min_cos=r["grad_min_cos"], grad_worst=r["grad_worst"],
            step_ms=r["step_ms"], peak_bytes=r["peak_bytes"],
            cluster_input_equal=r["cluster_input_equal"],
            medoids_equal=r["medoids_equal"],
            medoid_segments_differing=r["medoid_segments_differing"],
            medoid_ids_differing=r["medoid_ids_differing"],
            launches_by_rank=[rr[label]["counts"][0] for rr in tp_ranks])
    summary["gloo_tp_unwrapped"] = dict(
        step_ms=tp["unwrapped"]["step_ms"],
        peak_bytes=tp["unwrapped"]["peak_bytes"],
        loss=tp["unwrapped"]["losses"][0])
    for label in ("unwrapped", "ddp", "fsdp"):
        r = single[label]
        summary[label] = dict(step_ms=r["step_ms"],
                              step_ms_all=r["step_ms_all"],
                              peak_bytes=r["peak_bytes"], losses=r["losses"])
    for label in ("ddp", "fsdp"):
        summary[label]["overhead_ms"] = (single[label]["step_ms"]
                                         - unwrapped["step_ms"])
        if label in gloo:
            g = gloo[label]
            summary[f"gloo_{label}"] = dict(
                loss_rel=g["loss_rel"], grad_min_cos=g["grad_min_cos"],
                step_ms=g["step_ms"], peak_bytes=g["peak_bytes"])
    summary["main_fsdp"] = {k: v for k, v in m.items() if k != "counts"}
    return summary, paths, pp_ranks[0]["pp"]["held"]


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from centerclip_tpu_torch.ops import (_build, attention_cuda,
                                          kmedoids_cuda, layernorm_triton)
    from centerclip_tpu_torch.config import flagship_config
    from centerclip_tpu_torch.serve import RetrievalEngine

    t_start = time.time()
    phase_s, last = {}, [t_start]

    def phase_done(label):
        """Record the time since the previous phase ended."""
        now = time.time()
        phase_s[label] = now - last[0]
        last[0] = now
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi)
    name = torch.cuda.get_device_name(0)
    print(f"device: {name} (count {torch.cuda.device_count()}), torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}")
    if torch.backends.cuda.matmul.allow_tf32 is not False:
        fail("TF32 matmuls are on")
    peaks = card_peaks(name)
    mem_rate, bf16_peak, _ = peaks
    dev = torch.device("cuda")

    # ---------------------------------------------------------------- build
    t0 = time.time()
    report = _build.build(_build.KERNEL_SOURCES + _build.HOST_SOURCES,
                          force=True)
    print(f"built {sorted(report)} in {time.time() - t0:.2f} s")
    for src, out in sorted(report.items()):
        for line in out.splitlines():
            if "registers" in line:
                print(f"  {src}: {line.strip()}")
    phase_done("build")

    # ----------------------------------------------------- serving (main path)
    cfg = flagship_config()
    t0 = time.time()
    model = build_model(cfg, dev, seed=0)
    # the model builder sets the JAX package's fp32 numerics: PyTorch's
    # default lets cuDNN run fp32 convolutions in TF32
    if torch.backends.cudnn.allow_tf32 is not False or \
            torch.backends.cuda.matmul.allow_tf32 is not False:
        fail("TF32 is on after the model builder ran (cuDNN "
             f"{torch.backends.cudnn.allow_tf32}, cuBLAS "
             f"{torch.backends.cuda.matmul.allow_tf32})")
    engine = RetrievalEngine(model, device=dev)
    g = np.random.default_rng(0)
    clips = g.integers(0, 256, (N_CLIPS, 1, FRAMES, 3, RES, RES),
                       dtype=np.uint8)
    masks = np.ones((N_CLIPS, FRAMES), np.int32)
    video_ids = [f"clip{i:03d}" for i in range(N_CLIPS)]
    print(f"set-up (weights, {N_CLIPS} clips) {time.time() - t0:.2f} s")

    def batches(lo=0, hi=N_CLIPS):
        for s in range(lo, hi, BATCH):
            yield {"video": clips[s:min(s + BATCH, hi)],
                   "video_mask": masks[s:min(s + BATCH, hi)]}

    # warm-up on a 2-clip gallery (CUDA loads each kernel module at first
    # launch): not counted, not timed
    engine.build_index(batches(0, 2), video_ids[:2], quantize="int8")
    engine.search(QUERIES, k=2)
    torch.cuda.synchronize()

    # capture the main path's k-medoids input for the kernel phase
    captured = {}
    cluster_mod = cluster_module(model)
    hook = first_input_hook(cluster_mod, captured)

    counters = kernel_counters()
    serving_kernels = ("fused_attention", "layer_norm",
                       "kmedoids_from_distances", "quick_gelu_forward")
    zero_counts(counters)
    torch.cuda.synchronize()
    t0 = time.time()
    index = engine.build_index(batches(), video_ids, quantize="int8")
    torch.cuda.synchronize()
    t_build = time.time() - t0
    t0 = time.time()
    hits = engine.search(QUERIES, k=5)
    t_search = time.time() - t0
    launches = {fn.__name__: fn.launches for fn in counters}
    serving_variants = attention_variant_counts("serving", backward=False)
    hook.remove()
    print(f"gallery encode: {N_CLIPS} clips in {t_build:.3f} s = "
          f"{N_CLIPS / t_build:.2f} clips/s (batches of {BATCH}, host "
          f"clock, copies from host included)")
    t0 = time.time()
    for _ in range(SEARCH_REPEATS):
        engine.search(QUERIES, k=5)
    t_steady = (time.time() - t0) / SEARCH_REPEATS
    print(f"search: {len(QUERIES)} queries, k=5: {t_search * 1e3:.2f} ms in "
          f"the counted run, {t_steady * 1e3:.2f} ms per query batch over "
          f"{SEARCH_REPEATS} more (host clock, tokenising included)")
    print(f"launches during the serving phase: {launches}")
    launched("the serving path", launches, serving_kernels)
    gallery = index._codes[:N_CLIPS].float() * index._scales[:N_CLIPS]
    if tuple(gallery.shape) != (N_CLIPS, 512) or \
            not bool(torch.isfinite(gallery).all()):
        fail(f"gallery is not finite [{N_CLIPS}, 512]")
    for q, row in zip(QUERIES, hits):
        ids = [h["video_id"] for h in row]
        scores = [h["score"] for h in row]
        if len(ids) != 5 or len(set(ids)) != 5 \
                or not all(i in video_ids for i in ids) \
                or not all(np.isfinite(scores)) \
                or scores != sorted(scores, reverse=True):
            fail(f"bad hits for {q!r}: {row}")
    print(f"top hit per query: {[row[0] for row in hits]}")

    phase_done("serving")

    # ---------------------------------------------- training (second path)
    train, train_batch, train_cluster_x = training_phase(torch, np, dev,
                                                         counters)
    torch.cuda.empty_cache()
    phase_done("training")

    # each main path's launch counts and attention variants, by kernel;
    # the main phase adds its own after it runs
    path_counts = {"serving": (launches, serving_variants),
                   "training": (train["launches"], train["variants"])}

    def path_launches(fn_name):
        by_path = {p: c[fn_name] for p, (c, _) in path_counts.items()}
        out = dict(launches=sum(by_path.values()), launches_by_path=by_path)
        if fn_name in serving_variants:
            out["launches_by_variant"] = {p: v[fn_name] for p, (_, v)
                                          in path_counts.items()}
        return out

    # ----------------------------------------------------------- kernels
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    results = []

    # attention: the three main-path shapes; the largest one is reported
    attn_cases = [("vision blocks 1-6", 384, 50, 12, None),
                  ("vision blocks 7-12", 192, 50, 12, None),
                  ("text", len(QUERIES), 32, 8, "causal")]
    attn_rows = []
    for label, B, L, H, mask_kind in attn_cases:
        D = 64 * H
        qkv = torch.randn((B, L, 3 * D), generator=torch.Generator(
            device=dev).manual_seed(B), device=dev).to(torch.bfloat16)
        mask = (torch.full((L, L), float("-inf"), device=dev).triu(1)
                if mask_kind else None)
        out = attention_cuda.fused_attention(qkv, H, mask)
        ref = attention_cuda.attention_plain(qkv, H, mask)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs()
        ok = bool((err <= BF16_ATOL + BF16_RTOL * ref.float().abs()).all())
        q, k, v = (t.reshape(B, L, H, 64).transpose(1, 2)
                   for t in qkv.split(D, dim=-1))
        ms = time_ms(lambda: attention_cuda.fused_attention(
            qkv, H, mask), flush=flush)
        plain_ms = time_ms(lambda: attention_cuda.attention_plain(
            qkv, H, mask), flush=flush)
        lib_ms = time_ms(lambda: torch.nn.functional
                         .scaled_dot_product_attention(
                             q, k, v, is_causal=mask is not None),
                         flush=flush)
        b_ms, b_by = bound(qkv.numel() * 2 + B * L * D * 2
                           + (L * L * 4 if mask is not None else 0),
                           4.0 * B * H * L * L * 64, bf16_peak, mem_rate)
        variant = attention_cuda.choose_variant(qkv.dtype, 64, L)
        print(f"attention [{label}] qkv {tuple(qkv.shape)} bf16 H={H}, "
              f"{variant} variant: max_abs_err {err.max().item():.3e} (tol "
              f"{BF16_ATOL} + {BF16_RTOL}*|ref|) ms {ms:.4f} plain "
              f"{plain_ms:.4f} sdpa {lib_ms:.4f} bound {b_ms:.4f} ({b_by}); "
              f"ms / sdpa {ms / lib_ms:.3f}, ms / bound {ms / b_ms:.2f}")
        if not ok:
            fail(f"attention [{label}] disagrees with its plain version")
        attn_rows.append(dict(shape=list(qkv.shape), variant=variant,
                              max_abs_err=err.max().item(), ms=ms,
                              plain_ms=plain_ms, library_ms=lib_ms,
                              vs_library=ms / lib_ms, bound_ms=b_ms,
                              bound_by=b_by))
    a = attn_rows[0]
    results.append(dict(
        name="attention_fwd", route="cuda",
        source="centerclip_tpu_torch/csrc/attention.cu",
        replaces="centerclip_tpu/ops/attention_pallas.py:204",
        variant=a["variant"], counter="fused_attention",
        max_abs_err=max(r["max_abs_err"] for r in attn_rows),
        ms=a["ms"], plain_ms=a["plain_ms"], bound_ms=a["bound_ms"],
        bound_by=a["bound_by"], library_ms=a["library_ms"],
        vs_library=a["vs_library"], shapes=attn_rows))

    # LayerNorm: the main path's row counts and dtypes
    ln_cases = [("vision ln_pre/ln_1/ln_2, blocks 1-6", 384 * 50, 768,
                 torch.bfloat16),
                ("vision ln_1/ln_2, blocks 7-12", 192 * 50, 768,
                 torch.bfloat16),
                ("vision ln_post (CLS)", 192, 768, torch.bfloat16),
                ("text ln_1/ln_2/ln_final", len(QUERIES) * 32, 512,
                 torch.bfloat16)]
    ln_rows = []
    for label, R, D, dt in ln_cases:
        gen = torch.Generator(device=dev).manual_seed(R)
        x = (torch.randn((R, D), generator=gen, device=dev) * 3 + 1).to(dt)
        w = torch.randn(D, generator=gen, device=dev) * 0.1 + 1
        b = torch.randn(D, generator=gen, device=dev)
        out = layernorm_triton.layer_norm(x, w, b)
        ref = layernorm_triton.layer_norm_plain(x, w, b)
        torch.cuda.synchronize()
        atol, rtol = ((BF16_ATOL, BF16_RTOL) if dt == torch.bfloat16
                      else (FP32_ATOL, FP32_RTOL))
        err = (out.float() - ref.float()).abs()
        ok = bool((err <= atol + rtol * ref.float().abs()).all())
        if not ok:
            fail(f"layernorm [{label}] disagrees with its plain version")
        times = layernorm_row_times(x, w, b, flush)
        b_ms, b_by = layernorm_bound(x, peaks)
        print(f"layernorm [{label}] x ({R}, {D}) {dt}: max_abs_err "
              f"{err.max().item():.3e} (tol {atol} + {rtol}*|ref|) ms "
              f"{times['ms']:.4f} plain {times['plain_ms']:.4f} F.layer_norm "
              f"({times['library_params']} gamma/beta) "
              f"{times['library_ms']:.4f}, on an fp32 copy "
              f"{times['library_fp32_copy_ms']:.4f} bound {b_ms:.4f} "
              f"({b_by})")
        ln_rows.append(dict(shape=[R, D], dtype=str(dt).split(".")[-1],
                            max_abs_err=err.max().item(), **times,
                            bound_ms=b_ms, bound_by=b_by))
    # the host's cost of a call at the search's and a pipeline
    # microbatch's shapes, where the calls are launch-bound: on inputs
    # that need no gradient (serving) and through the autograd Function
    # (training)
    ln_host = []
    for R, D in ((len(QUERIES) * 32, 512), (96 * 50, 768)):
        x = torch.randn((R, D), device=dev).to(torch.bfloat16)
        w, b = torch.ones(D, device=dev), torch.zeros(D, device=dev)
        wg, bg = (t.clone().requires_grad_(True) for t in (w, b))
        us = host_us_per_call(lambda: layernorm_triton.layer_norm(
            x, w, b))
        us_grad = host_us_per_call(lambda: layernorm_triton.layer_norm(
            x, wg, bg))
        print(f"layernorm x ({R}, {D}) bf16: {us:.2f} host us per call, "
              f"{us_grad:.2f} through the autograd Function (1000 calls, no "
              f"synchronisation)")
        ln_host.append(dict(shape=[R, D], us=us, us_autograd=us_grad))
    a = ln_rows[0]
    results.append(dict(
        name="layernorm_fwd", route="cuda",
        source="centerclip_tpu_torch/csrc/layernorm.cu",
        replaces="centerclip_tpu/ops/layernorm_pallas.py:83",
        counter="layer_norm",
        max_abs_err=max(r["max_abs_err"] for r in ln_rows),
        ms=a["ms"], plain_ms=a["plain_ms"], bound_ms=a["bound_ms"],
        bound_by=a["bound_by"], library_ms=a["library_ms"],
        library_params=a["library_params"],
        library_fp32_copy_ms=a["library_fp32_copy_ms"],
        host_us_per_call=ln_host, shapes=ln_rows))

    # k-medoids on the tokens the serving phase (first batch) and the first
    # training step clustered; the training tokens also as the 12 -> 4
    # presets (msrvtt_vitb32_k4, msvd_vitb32_k4) cluster them: 4 segments of
    # 3 frames, N = 147, K = 49
    spec = cluster_mod.spec
    K, iters = spec.cluster_num, cfg.cluster.iter_limit
    km_rows = [
        kmedoids_case(torch, flush, peaks, "serving", captured["x"],
                      spec.before_frames, spec.after_frames, K, iters),
        kmedoids_case(torch, flush, peaks, "training", train_cluster_x,
                      spec.before_frames, spec.after_frames, K, iters),
        kmedoids_case(torch, flush, peaks, "training, 12 -> 4 frames",
                      train_cluster_x, spec.before_frames, 4, K, iters)]
    del train_cluster_x
    a = km_rows[0]
    results.append(dict(
        name="kmedoids", route="cuda",
        source="centerclip_tpu_torch/csrc/kmedoids.cu",
        replaces="centerclip_tpu/ops/kmedoids_pallas.py:220",
        counter="kmedoids_from_distances",
        max_abs_err=max(r["max_abs_err"] for r in km_rows),
        ms=a["ms"], plain_ms=a["plain_ms"], bound_ms=a["bound_ms"],
        bound_by=a["bound_by"], library_ms=None,
        segments_differing=a["segments_differing"],
        max_rel_cost_gap=a["max_rel_cost_gap"],
        lloyd_steps_mean=a["lloyd_steps_mean"], shapes=km_rows))

    def extend_forward_row(kernel, rows, key="training_shapes"):
        """Add a kernel's rows at another path's shapes (errors, and times
        where they were taken) to its entry; its top-level times stay
        those of its first shape."""
        row = next(r for r in results if r["name"] == kernel)
        row[key] = rows
        row["max_abs_err"] = max([row["max_abs_err"]]
                                 + [r["max_abs_err"] for r in rows])

    # attention backward at the training batch's shapes; the autograd
    # Function must hand back the kernel's gradient bit for bit.  The
    # forward kernel is held at the same shapes on the way.
    TB = train["batch"]
    bwd_cases = [("vision blocks 1-6", TB * FRAMES, 50, 12, None),
                 ("vision blocks 7-12", TB * FRAMES // 2, 50, 12, None),
                 ("text", TB, 32, 8, "causal")]
    bwd_rows, attn_train_rows = [], []
    for case in bwd_cases:
        row, fwd_row = hold_attention_bwd(torch, dev, flush, peaks, *case)
        bwd_rows.append(row)
        attn_train_rows.append(fwd_row)
    extend_forward_row("attention_fwd", attn_train_rows)
    a = bwd_rows[0]
    results.append(dict(
        name="attention_bwd", route="cuda",
        source="centerclip_tpu_torch/csrc/attention_bwd.cu",
        replaces="centerclip_tpu/ops/attention_pallas.py:325",
        variant=a["variant"], counter="attention_backward",
        max_abs_err=max(r["max_abs_err"] for r in bwd_rows),
        ms=a["ms"], plain_ms=a["plain_ms"], bound_ms=a["bound_ms"],
        bound_by=a["bound_by"], library_ms=a["library_ms"],
        vs_library=a["vs_library"], shapes=bwd_rows))

    # LayerNorm backward at the training batch's row counts (bf16 towers;
    # ln_pre has no backward at freeze_layer_num 0)
    lnb_cases = [("vision ln_1/ln_2, blocks 1-6", TB * FRAMES * 50, 768),
                 ("vision ln_1/ln_2, blocks 7-12", TB * FRAMES // 2 * 50, 768),
                 ("vision ln_post (CLS)", TB * FRAMES // 2, 768),
                 ("text ln_1/ln_2/ln_final", TB * 32, 512)]
    lnb_rows, ln_train_rows = [], []
    for case in lnb_cases:
        row, fwd_row = hold_layernorm_bwd(torch, dev, flush, peaks, *case)
        lnb_rows.append(row)
        ln_train_rows.append(fwd_row)
    extend_forward_row("layernorm_fwd", ln_train_rows)
    a = lnb_rows[0]
    results.append(dict(
        name="layernorm_bwd", route="triton",
        source="centerclip_tpu_torch/ops/layernorm_triton.py",
        replaces="centerclip_tpu/ops/layernorm_pallas.py:103",
        counter="layer_norm_backward",
        max_abs_err=max(r["max_abs_err"] for r in lnb_rows),
        ms=a["ms"], plain_ms=a["plain_ms"], bound_ms=a["bound_ms"],
        bound_by=a["bound_by"], library_ms=a["library_ms"],
        device_launches_per_call=max(r["device_launches_per_call"]
                                     for r in lnb_rows), shapes=lnb_rows))
    # QuickGELU (kernel F): its forward's launches by path, as the other
    # kernels' (`counter`), its backward's beside them
    qg_rows = hold_quick_gelu(torch, dev, flush, peaks)
    a = qg_rows[0]
    results.append(dict(
        name="quick_gelu", route="cuda",
        source="centerclip_tpu_torch/csrc/quick_gelu.cu",
        replaces="none: XLA fuses centerclip_tpu/models/layers.py:22",
        counter="quick_gelu_forward",
        ms=a["forward"]["ms"], backward_ms=a["backward"]["ms"],
        bound_ms=a["forward"]["bound_ms"],
        backward_bound_ms=a["backward"]["bound_ms"], bound_by="bytes",
        library_ms=a["forward"]["eager_ms"],
        backward_library_ms=a["backward"]["eager_ms"], shapes=qg_rows))
    del flush
    torch.cuda.empty_cache()
    phase_done("kernels")

    # ------------------------------------------------------------ CPU check
    t0 = time.time()
    torch.set_num_threads(os.cpu_count() or 1)
    cpu_model = build_model(cfg, "cpu", seed=1)
    cpu_model.load_state_dict({k: v.cpu() for k, v in
                               model.state_dict().items()}, strict=True)
    cpu_engine = RetrievalEngine(cpu_model, device="cpu")
    card_video = engine.embed_video_batches(batches(0, 2))
    cpu_video = cpu_engine.embed_video_batches(batches(0, 2))
    card_text = engine.encode_texts(QUERIES)
    cpu_text = cpu_engine.encode_texts(QUERIES)

    cos_v, cos_t = cosines(card_video, cpu_video), cosines(card_text,
                                                           cpu_text)
    print(f"CPU check ({time.time() - t0:.1f} s): video cosine "
          f"{np.round(cos_v, 6).tolist()} (min {VIDEO_MIN_COS}), text "
          f"cosine {np.round(cos_t, 6).tolist()} (min {TEXT_MIN_COS})")
    if cos_v.min() < VIDEO_MIN_COS or cos_t.min() < TEXT_MIN_COS:
        fail("card and CPU embeddings disagree")
    train_check = training_cpu_check(torch, np, dev, train_batch)
    # the main phase builds its own model: free the card of the others
    del model, engine, index, gallery, cluster_mod, captured, cpu_model, \
        cpu_engine, train_batch
    torch.cuda.empty_cache()
    phase_done("cpu_check")

    # ----------------------------------------- main (third path) + report
    import tempfile
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    # the main phase's fixture stays until the preprocess phase reads it
    workdir = tempfile.TemporaryDirectory(dir=_build.BUILD_DIR)
    root = workdir.name
    main_res, handoff = main_phase(torch, np, dev, counters, root)
    path_counts["main"] = (main_res["launches"], main_res["variants"])
    for kernel, rows in main_res["held"].items():
        extend_forward_row(kernel, rows, key="main_shapes")
    torch.cuda.empty_cache()
    phase_done("main")

    # ---------------------------------- serve CLI (fifth path) + report
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    serve_res = serve_phase(torch, np, dev, counters, root, handoff, flush)
    del flush, handoff
    path_counts["serve_cli"] = (serve_res.pop("launches"),
                                serve_res.pop("variants"))
    for kernel, rows in serve_res.pop("held").items():
        extend_forward_row(kernel, rows, key="serve_cli_shapes")
    torch.cuda.empty_cache()
    phase_done("serve")

    # ------------------------------------ ViT-B/16 (fourth path) + report
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    vitb16, b16 = vitb16_phase(torch, np, dev, flush, peaks, counters)
    del flush
    path_counts["vitb16_encode"] = (b16["encode_launches"],
                                    b16["encode_variants"])
    path_counts["vitb16_training"] = (b16["launches"], b16["variants"])
    for kernel in ALL_KERNELS:
        extend_forward_row(kernel, b16[kernel], key="vitb16_shapes")
    phase_done("vitb16")

    # ------- ViT-B/16 on segments of 4 frames (fourteenth path) + report
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    long_seg, ls = long_segments_phase(torch, np, dev, flush, peaks,
                                       counters, root)
    del flush
    long_seg["vitb16_beside"] = {k: vitb16[k] for k in (
        "step_ms", "peak_memory_bytes", "encode_clips_per_s")}
    path_counts.update(ls["paths"])
    for kernel in ("attention_fwd", "attention_bwd", "kmedoids"):
        extend_forward_row(kernel, ls[kernel], key="long_segment_shapes")
    torch.cuda.empty_cache()
    phase_done("long_segments")

    # ----------- fp32 ViT-B/16 and 20-frame segments (fifteenth, sixteenth)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    fp32_res, f32 = fp32_vitb16_phase(torch, np, dev, flush, peaks,
                                      counters, root)
    path_counts.update(f32["paths"])
    for kernel, held in (("attention_fwd", "held_fwd"),
                         ("attention_bwd", "held_bwd")):
        extend_forward_row(kernel, f32[kernel], key="fp32_shapes")
        extend_forward_row(kernel, f32[held], key="fp32_step_shapes")
    torch.cuda.empty_cache()
    phase_done("fp32_vitb16")
    seg20, s20 = seg20_phase(torch, np, dev, flush, peaks, counters)
    del flush
    path_counts.update(s20["paths"])
    extend_forward_row("kmedoids", s20["kmedoids"], key="seg20_shapes")
    torch.cuda.empty_cache()
    phase_done("seg20")

    # --------------------- cluster algorithms and activity (sixth, seventh)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    cluster, cl = cluster_phase(torch, np, dev, flush, peaks, counters)
    torch.cuda.empty_cache()
    phase_done("cluster")
    activity, act = activity_phase(torch, np, dev, flush, peaks, counters)
    torch.cuda.empty_cache()
    phase_done("activity")

    # ---------------- headers, towers, preprocess (eighth to tenth paths)
    headers, hd = headers_phase(torch, np, dev, flush, peaks, counters)
    torch.cuda.empty_cache()
    phase_done("headers")
    towers, tw = towers_phase(torch, np, dev, flush, peaks, counters)
    torch.cuda.empty_cache()
    phase_done("towers")

    # --- data, tensor, sequence and pipeline parallelism on the main
    # fixture (eleventh to thirteenth paths), then A-D at the model axis's
    # per-rank shapes and at the pipe axis's microbatch shapes
    parallel_res, par_paths, pp_held = parallel_phase(torch, np, root, smi)
    path_counts.update(par_paths)
    for kernel, rows in kernel_rows(torch, dev, flush, peaks,
                                    TP_ATTENTION_CASES,
                                    TP_LAYERNORM_CASES).items():
        extend_forward_row(kernel, rows, key="tp_shapes")
    for kernel, rows in kernel_rows(torch, dev, flush, peaks,
                                    PP_ATTENTION_CASES,
                                    PP_LAYERNORM_CASES).items():
        extend_forward_row(kernel, rows, key="pp_shapes")
    for kernel, rows in pp_held.items():
        extend_forward_row(kernel, rows, key="pp_gloo_shapes")
    phase_done("parallel")
    preprocess, pp = preprocess_phase(torch, np, dev, flush, peaks,
                                      counters, root)
    workdir.cleanup()
    phase_done("preprocess")
    del flush
    for extra in (cl, act, hd, tw, pp):
        path_counts.update(extra["paths"])
    for kernel in ("layernorm_fwd", "layernorm_bwd"):
        extend_forward_row(kernel, hd[kernel], key="header_shapes")
    extend_forward_row("kmedoids", pp["kmedoids"], key="preprocess_shapes")
    extend_forward_row("kmedoids", cl["kmedoids"], key="cluster_shapes")
    for kernel in ALL_KERNELS:
        extend_forward_row(kernel, act[kernel], key="activity_shapes")
    for row in results:
        row.update(path_launches(row.pop("counter")))
    qg_bwd = path_launches("quick_gelu_backward")
    next(r for r in results if r["name"] == "quick_gelu").update(
        backward_launches=qg_bwd["launches"],
        backward_launches_by_path=qg_bwd["launches_by_path"])
    # the variants for ViT-B/16's shapes, as rows of their own: their first
    # shapes' numbers, and their launches on the ViT-B/16 path
    for row_name, kernel, fn_name, variant in (
            ("attention_fwd_long", "attention_fwd", "fused_attention",
             attention_cuda.TENSOR_CORE_LONG),
            ("attention_bwd_long", "attention_bwd", "attention_backward",
             attention_cuda.TENSOR_CORE_LONG),
            ("kmedoids_global", "kmedoids", "kmedoids",
             kmedoids_cuda.GLOBAL)):
        base = next(r for r in results if r["name"] == kernel)
        rows = b16[kernel]
        by_path = {p: b16[k][fn_name][variant] for p, k in (
            ("vitb16_encode", "encode_variants"),
            ("vitb16_training", "variants"))}
        by_path.update({p: v[fn_name][variant]
                        for p, (_, v) in ls["paths"].items()})
        a = rows[0]
        results.append(dict(
            name=row_name, route="cuda", source=base["source"],
            replaces=base["replaces"], variant=variant,
            launches=sum(by_path.values()), launches_by_path=by_path,
            max_abs_err=max(r["max_abs_err"] for r in rows), ms=a["ms"],
            plain_ms=a["plain_ms"], bound_ms=a["bound_ms"],
            bound_by=a["bound_by"], library_ms=a.get("library_ms"),
            **({"occupancy": a["occupancy"]} if "occupancy" in a else {}),
            shapes=rows))

    # E's cluster variant (N past 512: the fourteenth and sixteenth paths)
    # and A and B past L = 256, rows of their own: their first shapes'
    # numbers and their launches on those paths; E's scratch variant,
    # which no path runs since the cluster one, a row of its own too: held
    # and timed at one shape
    km_base = next(r for r in results if r["name"] == "kmedoids")
    e_paths = dict(ls["paths"], **s20["paths"])
    for row_name, variant in (("kmedoids_cluster", kmedoids_cuda.CLUSTER),
                              ("kmedoids_scratch", kmedoids_cuda.SCRATCH)):
        rows = [r for r in ls["kmedoids"] + s20["kmedoids"]
                if r["variant"] == variant]
        by_path = {p: v["kmedoids"][variant] for p, (_, v) in e_paths.items()}
        a = rows[0]
        results.append(dict(
            name=row_name, route="cuda", source=km_base["source"],
            replaces=km_base["replaces"], variant=variant,
            launches=sum(by_path.values()), launches_by_path=by_path,
            max_abs_err=max(r["max_abs_err"] for r in rows), ms=a["ms"],
            plain_ms=a["plain_ms"], bound_ms=a["bound_ms"],
            bound_by=a["bound_by"], sector_bound_ms=a["sector_bound_ms"],
            cluster_size=a["cluster_size"], library_ms=None, shapes=rows))
    if not results[-2]["launches"] or results[-1]["launches"]:
        fail(f"E on the fourteenth and sixteenth paths: "
             f"{[(r['name'], r['launches_by_path']) for r in results[-2:]]}"
             f", not its cluster variant alone")
    for row_name, kernel, key in (
            ("attention_fwd_long_past_256", "attention_fwd", "fwd"),
            ("attention_bwd_long_past_256", "attention_bwd", "bwd")):
        base = next(r for r in results if r["name"] == kernel)
        a = ls[kernel][0]
        n = ls["past_256"][key]
        results.append(dict(
            name=row_name, route="cuda", source=base["source"],
            replaces=base["replaces"],
            variant=attention_cuda.TENSOR_CORE_LONG, launches=n,
            launches_by_path={"long_attention_training": n},
            max_abs_err=a["max_abs_err"], ms=a["ms"], plain_ms=a["plain_ms"],
            bound_ms=a["bound_ms"], bound_by=a["bound_by"],
            library_ms=a["library_ms"],
            **({"occupancy": a["occupancy"]} if "occupancy" in a else {}),
            shapes=[a]))
    if not (results[-2]["launches"] and results[-1]["launches"]):
        fail("A or B past L = 256 never launched on the fourteenth path")

    # A's and B's fp32 variants (tf32x3 on the fifteenth path, the
    # CUDA-core one where a path ran it), rows of their own: their first
    # shapes' numbers and their launches on those paths
    for row_name, kernel, fn_name, variant, rows, paths, needed in (
            ("attention_fwd_fp32_tf32x3", "attention_fwd", "fused_attention",
             attention_cuda.TF32X3, f32["attention_fwd"],
             f32["paths"], True),
            ("attention_bwd_fp32_tf32x3", "attention_bwd",
             "attention_backward", attention_cuda.TF32X3,
             f32["attention_bwd"], f32["paths"], True),
            ("attention_fwd_fp32", "attention_fwd", "fused_attention",
             attention_cuda.CUDA_CORE, f32["attention_fwd"], f32["paths"],
             False),
            ("attention_bwd_fp32", "attention_bwd", "attention_backward",
             attention_cuda.CUDA_CORE, f32["attention_bwd"], f32["paths"],
             False)):
        rows = [r for r in rows if r["variant"] == variant]
        by_path = {p: v[fn_name][variant] for p, (_, v) in paths.items()}
        if not sum(by_path.values()) and not needed:
            continue
        if not rows or not sum(by_path.values()):
            fail(f"{row_name}: no row or no launch on its paths {by_path}")
        base = next(r for r in results if r["name"] == kernel)
        a = rows[0]
        results.append(dict(
            name=row_name, route="cuda", source=base["source"],
            replaces=base["replaces"], variant=variant,
            launches=sum(by_path.values()), launches_by_path=by_path,
            max_abs_err=max(r["max_abs_err"] for r in rows), ms=a["ms"],
            plain_ms=a["plain_ms"], bound_ms=a["bound_ms"],
            bound_by=a["bound_by"], library_ms=a.get("library_ms"),
            **({"occupancy": a["occupancy"]} if "occupancy" in a else {}),
            **{k: a[k] for k in ("bound_ffma_ms", "vs_library") if k in a},
            shapes=rows))

    print(f"total {time.time() - t_start:.1f} s; by phase (s) "
          f"{ {k: round(v, 1) for k, v in phase_s.items()} }")
    print(json.dumps({"training": {**{k: v for k, v in train.items()
                                       if k not in ("launches", "variants")},
                                   "cpu_check": train_check}}))
    print(json.dumps({"main": {k: v for k, v in main_res.items()
                               if k not in ("launches", "variants",
                                            "held")}}))
    print(json.dumps({"vitb16": vitb16}))
    print(json.dumps({"long_segments": long_seg}))
    print(json.dumps({"fp32_vitb16": fp32_res}))
    print(json.dumps({"seg20": seg20}))
    print(json.dumps({"serve": serve_res}))
    print(json.dumps({"cluster": cluster}))
    print(json.dumps({"activity": activity}))
    print(json.dumps({"headers": headers}))
    print(json.dumps({"towers": towers}))
    print(json.dumps({"preprocess": preprocess}))
    print(json.dumps({"parallel": parallel_res}))
    print(json.dumps({"kernels": results}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def parallel_worker(argv) -> int:
    """A rank of a parallel leg: `--parallel-leg {single,gloo,tp_gloo,
    pp_gloo,multi,multi_main_tp,multi_main_pp,multi_eval} <root>
    <out.json>` (started by torchrun_leg)."""
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import faulthandler
    faulthandler.enable()     # a rank that crashes prints its Python stack
    leg, root, out_path = argv
    {"single": parallel_leg_single, "gloo": parallel_leg_gloo,
     "tp_gloo": parallel_leg_tp_gloo, "pp_gloo": parallel_leg_pp_gloo,
     "multi": parallel_leg_multi,
     "multi_main_tp": parallel_leg_multi_main_tp,
     "multi_main_pp": parallel_leg_multi_main_pp,
     "multi_eval": parallel_leg_multi_eval}[leg](
        torch, np, root, out_path)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--parallel-leg"]:
        sys.exit(parallel_worker(sys.argv[2:]))
    if sys.argv[1:2] == ["--gpus"]:
        sys.exit(multi_gpu_main(int(sys.argv[2])))
    sys.exit(main())
