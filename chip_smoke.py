#!/usr/bin/env python3
# coding=utf-8
"""Drive the PyTorch/CUDA port (`centerclip_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

1. Prints the card (nvidia-smi name and power limit), checks that TF32 is
   off, and builds the CUDA C++ kernels and the FrameStore reader from
   `centerclip_tpu_torch/csrc` (one nvcc per kernel source and the host
   compiler for the reader, all started together).
2. Serving phase, the first main path: a full-width ViT-B/32 CLIP4Clip
   (meanP, kmediods++ clustering 12 -> 6 frames before block 7, K = 49,
   bf16 towers) on seeded random weights; `RetrievalEngine.build_index` over
   64 seeded uint8 clips [12, 3, 224, 224] in batches of 32 (int8 index),
   then `search` with 4 text queries (k = 5).  Every kernel's launch count
   is zeroed just before this phase and must have moved just after it; the
   attention forward must have run its tensor-core variant only (its fp32
   CUDA-core variant's count must not move).
3. Training phase, the second main path: the JAX package's preset
   `msrvtt_vitb32_k6` (the same model; AdamW lr 2e-3, coef_lr 1e-3, wd 0.2,
   warmup 0.1, freeze_layer_num 0) at its batch of 128 seeded clips with
   128 seeded token rows of 32; 2 untimed and 5 timed steps through
   `Trainer.train_epoch` (forward, symmetric InfoNCE, backward through the
   five kernels, clip, update, logit-scale clamp).  The counts of all five
   kernels are zeroed just before the steps and must have moved after them,
   the attention forward and backward through their tensor-core variants
   only.
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
   128 through the pinned loader and all five kernels (counts zeroed just
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
   encode of 64 seeded clips through `RetrievalEngine` (batches of 32) and
   one search; then 2 untimed and 3 timed training steps at the recipe's
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

Prints a `{"training": ...}`, a `{"main": ...}`, a `{"vitb16": ...}`, a
`{"serve": ...}` and a `{"kernels": [...]}` JSON line (attention's long forward and backward and
the global k-medoids variant as rows of their own) and, last, one JSON line {"ok":
true, "device": {...}}.  Any failed check exits non-zero before it.
Without a CUDA device it exits non-zero at once.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import subprocess
import sys
import time

# card data sheets (dense peaks; NVIDIA's published figures):
# memory bytes/s, bf16 tensor-core flop/s, fp32 (non-tensor) flop/s
CARD_PEAKS = {
    "H100 PCIe": (2.0e12, 756e12, 51e12),
    "H100 NVL": (3.9e12, 835e12, 60e12),
    "H200": (4.8e12, 989e12, 67e12),
    "H100": (3.35e12, 989e12, 67e12),          # SXM (80GB HBM3)
}

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
# the fourth main path: ViT-B/16 at the recipe's batch of 128; the step
# count is what is cut to keep the script inside its time limit
VITB16_PRESET, VITB16_WARMUP_STEPS, VITB16_TIMED_STEPS = \
    "msrvtt_vitb16_k6", 2, 3
VITB16_REMAT = True
VITB16_REMAT_WHY = ("without it the step at batch 128 does not fit in the "
                    "card's 80 GB: python -m centerclip_tpu_torch.profile_train "
                    "--preset msrvtt_vitb16_k6 --remat 0")
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
SLEEP_CYCLES = 4_000_000          # ~2 ms at the H100's ~1.98 GHz boost clock
QUERIES = ["a man is cooking pasta in a kitchen",
           "two dogs are playing in the snow",
           "a woman sings on a stage while people dance",
           "a car drives along a mountain road at night"]


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def card_peaks(name: str):
    for key, peaks in CARD_PEAKS.items():
        if key in name:
            return peaks
    return CARD_PEAKS["H100"]


def bound(bytes_moved: float, ops: float, op_peak: float, mem_rate: float):
    t_bytes, t_ops = bytes_moved / mem_rate, ops / op_peak
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def time_ms(torch, fn, flush, iters=10, warmup=3):
    """Mean device time of `fn` in ms by CUDA events.  Before each launch the
    L2 cache is flushed (the main path's inputs mostly come from device
    memory) and a sleep kernel holds the card busy while the host enqueues
    the events and `fn`, so a launch's host overhead is not timed as device
    time.  (`fn`s that read results back to the host, like the plain
    k-medoids stop test, are timed with their waits.)"""
    for _ in range(warmup):
        fn()
    total = 0.0
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / iters


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
        if by[ac.CUDA_CORE] or by[ac.TENSOR_CORE_LONG]:
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
    import tempfile
    from centerclip_tpu_torch.config import preset
    from centerclip_tpu_torch.models.clip4clip import CLIP4Clip
    from centerclip_tpu_torch.ops import _build
    from centerclip_tpu_torch.train import (Evaluator, Trainer, resume,
                                            save_checkpoint)
    run = preset(TRAIN_PRESET)
    B, cfg = run.batch_size, run.model
    total_steps = TRAIN_WARMUP_STEPS + TRAIN_TIMED_STEPS + 1
    t0 = time.time()
    model = CLIP4Clip(cfg, device=dev, seed=0)
    trainer = Trainer(run, model, total_steps=total_steps)
    g = np.random.default_rng(1)
    ids, amask = token_rows(np, g, B, cfg.max_words)
    batch = {"input_ids": ids, "attention_mask": amask,
             "video": g.integers(0, 256, (B, 1, cfg.max_frames, 3, RES, RES),
                                 dtype=np.uint8),
             "video_mask": np.ones((B, cfg.max_frames), np.int32)}
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

    # the first step's k-medoids input, for the kernel phase (the hook
    # returns None: a returned value would replace the module's input)
    captured = {}
    cluster_mod = next(b.tokencluster_inter
                       for b in model.clip.visual.transformer.resblocks
                       if b.tokencluster_inter is not None)

    def capture(module, args):
        captured["x"] = args[0].detach().clone()
    hook = cluster_mod.register_forward_pre_hook(capture)

    zero_counts(counters)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_s, losses = [], []
    for step in range(TRAIN_WARMUP_STEPS + TRAIN_TIMED_STEPS):
        t0 = time.time()
        loss, gstep = trainer.train_epoch(0, [batch], n_display=1)
        torch.cuda.synchronize()
        step_s.append(time.time() - t0)
        losses.append(loss)
        if not np.isfinite(loss):
            fail(f"training loss {loss} at step {gstep} is not finite")
        hook.remove()                      # one capture, in the first step
    if "step" in vars(trainer.optimizer):
        fail("the first training step did not reach the optimizer")
    launches = {fn.__name__: fn.launches for fn in counters}
    variants = attention_variant_counts("training", backward=True)
    peak = torch.cuda.max_memory_allocated()
    timed = sorted(step_s[TRAIN_WARMUP_STEPS:])
    med = timed[len(timed) // 2]
    print(f"training: losses {[round(x, 6) for x in losses]}, step times "
          f"(host clock, ends in a sync, copies from host included) "
          f"{[round(x * 1e3, 3) for x in step_s]} ms; median of the "
          f"{TRAIN_TIMED_STEPS} timed {med * 1e3:.3f} ms = "
          f"{B / med:.2f} clips/s; peak memory allocated "
          f"{peak / 2**30:.3f} GiB; logit_scale "
          f"{float(model.clip.logit_scale.detach()):.6f}")
    print(f"launches during the training steps: {launches}")
    for fn_name, n in launches.items():
        if n == 0:
            fail(f"{fn_name} was never launched on the training path")

    # checkpoint, resume into a fresh model and optimizer, one more step each
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        t0 = time.time()
        path = save_checkpoint(tmp, trainer.state, epoch=0, best_r1=0.0)
        other = CLIP4Clip(cfg, device=dev, seed=1)
        trainer2 = Trainer(run, other, total_steps=total_steps)
        _, epoch, _ = resume(path, trainer2.state)
        t_ckpt = time.time() - t0
    # ckpt of epoch 0: the resumed run starts at epoch 1
    if trainer2.state.global_step != trainer.state.global_step or epoch != 1:
        fail("resume did not restore the step counters")
    trainer.train_epoch(1, [batch], n_display=1)
    trainer2.train_epoch(1, [batch], n_display=1)
    other_sd = other.state_dict()
    diff = [k for k, v in model.state_dict().items()
            if not torch.equal(v, other_sd[k])]
    print(f"checkpoint save + resume {t_ckpt:.2f} s; one more step from the "
          f"trained and the resumed state: {len(diff)} of {len(other_sd)} "
          f"tensors differ")
    if diff:
        fail(f"the resumed step differs: {diff[:5]}")
    del trainer2, other, other_sd

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
    result = dict(batch=B, step_ms=med * 1e3, clips_per_s=B / med,
                  step_ms_all=[x * 1e3 for x in step_s], losses=losses,
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
                  distance="euclidean", norm_p=2.0, pre_norm=False, **_):
    """The k-medoids kernel against its plain version on [B, N, Dim]
    points (the keywords of `ops.kmedoids_cuda.kmedoids`; the plain
    version's `threshold` is not read by the kernel): ids equal on at least
    KMEDOIDS_MIN_SAME of the segments, where they differ a clustering no
    costlier than the plain one's (KMEDOIDS_COST_RTOL), and equal
    assignments where the ids agree.  Returns the row and (X, D, l2,
    steps) for timing."""
    from centerclip_tpu_torch.ops import kmedoids_cuda
    from centerclip_tpu_torch.ops.kmedoids import (_assign_step, _update_step,
                                                   kmedoids_inputs,
                                                   kmedoids_on_distances)
    X, D, l2 = kmedoids_inputs(points, distance, norm_p, pre_norm)
    a1, m1, steps = kmedoids_cuda.kmedoids_from_distances(
        D, l2, K, iter_limit, id_sort)
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
    print(f"kmedoids [{label}] X {tuple(X.shape)} K={K}: segments with "
          f"other ids {n_diff}/{Bs}, max relative cost gap {cost_rel:.3e} "
          f"(tol {KMEDOIDS_COST_RTOL}), Lloyd steps min/mean/max "
          f"{int(st.min())}/{st.float().mean().item():.2f}/{int(st.max())}, "
          f"segments the plain version left short of their fixed point "
          f"{short}/{Bs}")
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
               plain_short_of_fixed_point=short)
    return row, (X, D, l2, steps)


def hold_attention_bwd(torch, dev, flush, peaks, label, B, L, H, mask_kind):
    """Kernel B against `attention_bwd_plain` on seeded bf16 qkv
    [B, L, 3 * 64 H] and dO (causal mask if `mask_kind`): within one bf16
    ulp, the share of differing values printed, the autograd Function's
    gradient the kernel's bit for bit; kernel A's forward held and timed
    (beside SDPA) on the way.  Times the kernel, the plain version and
    SDPA's backward.  Returns (B's row, A's row)."""
    from centerclip_tpu_torch.ops import attention_cuda
    mem_rate, bf16_peak, _ = peaks
    D = 64 * H
    gen = torch.Generator(device=dev).manual_seed(B + L)
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
    f_ms = time_ms(torch, lambda: attention_cuda.fused_attention(
        qkv, H, mask), flush=flush)
    f_plain_ms = time_ms(torch, lambda: attention_cuda.attention_plain(
        qkv, H, mask), flush=flush)
    qh, kh, vh = (t.reshape(B, L, H, 64).transpose(1, 2)
                  for t in qkv.split(D, dim=-1))
    f_lib_ms = time_ms(torch, lambda: torch.nn.functional
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
    ms = time_ms(torch, lambda: attention_cuda.attention_backward(
        qkv, dout, H, mask), flush=flush)
    plain_ms = time_ms(torch, lambda: attention_cuda.attention_bwd_plain(
        qkv, dout, H, mask), flush=flush)
    q, k, v = (t.reshape(B, L, H, 64).transpose(1, 2).detach()
               .requires_grad_(True) for t in qkv.split(D, dim=-1))
    o = torch.nn.functional.scaled_dot_product_attention(
        q, k, v, is_causal=mask is not None)
    do_h = dout.reshape(B, L, H, 64).transpose(1, 2)
    # autograd.grad returns fresh gradients: nothing accumulates into
    # q.grad, k.grad, v.grad from one timed call to the next
    lib_ms = time_ms(torch, lambda: torch.autograd.grad(
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


def hold_layernorm_bwd(torch, dev, flush, peaks, label, R, D):
    """Kernel D against `layer_norm_bwd_plain` on seeded bf16 x, dy [R, D]
    (dx within one bf16 ulp, dgamma/dbeta within SUM_RTOL of the sum of
    the terms' magnitudes, the autograd Function's gradients the kernel's,
    a second call equal to the bit, its device launches per call counted);
    kernel C's forward held and timed on the way.  Times the kernel, the
    plain version and ATen's fp32 backward.  Returns (D's row, C's row)."""
    from centerclip_tpu_torch.ops import layernorm_triton
    mem_rate, _, fp32_peak = peaks
    gen = torch.Generator(device=dev).manual_seed(R + 1)
    x = (torch.randn((R, D), generator=gen, device=dev) * 3 + 1).to(
        torch.bfloat16)
    dy = torch.randn((R, D), generator=gen, device=dev).to(torch.bfloat16)
    w = torch.randn(D, generator=gen, device=dev) * 0.1 + 1
    b = torch.randn(D, generator=gen, device=dev)
    dx, dw, db = layernorm_triton.layer_norm_backward(x, w, dy)
    rx, rw, rb = layernorm_triton.layer_norm_bwd_plain(x, w, dy)
    xs, ws, bs = (t.clone().requires_grad_(True) for t in (x, w, b))
    out = layernorm_triton.layer_norm(xs, ws, bs)
    out.backward(dy)
    # kernel C's forward at the training shape
    fwd_ref = layernorm_triton.layer_norm_plain(x, w, b)
    torch.cuda.synchronize()
    fwd_err = (out.detach().float() - fwd_ref.float()).abs()
    if not bool((fwd_err <= BF16_ATOL
                 + BF16_RTOL * fwd_ref.float().abs()).all()):
        fail(f"layernorm [{label}, training] disagrees with its plain "
             f"version")
    passes = (torch.equal(xs.grad, dx) and torch.equal(ws.grad, dw)
              and torch.equal(bs.grad, db))
    del xs, ws, bs, out, fwd_ref
    xf, dyf = x.float(), dy.float()
    f_ms = time_ms(torch, lambda: layernorm_triton.layer_norm(x, w, b),
                   flush=flush)
    f_plain_ms = time_ms(torch, lambda: layernorm_triton.layer_norm_plain(
        x, w, b), flush=flush)
    f_lib_ms = time_ms(torch, lambda: torch.nn.functional.layer_norm(
        xf, (D,), w, b, 1e-5), flush=flush)
    f_b_ms, f_b_by = bound(2 * x.numel() * x.element_size() + 2 * D * 4,
                           8.0 * R * D, fp32_peak, mem_rate)
    fwd_row = dict(shape=[R, D], dtype="bfloat16",
                   max_abs_err=fwd_err.max().item(), ms=f_ms,
                   plain_ms=f_plain_ms, library_ms=f_lib_ms, bound_ms=f_b_ms,
                   bound_by=f_b_by)
    print(f"layernorm [{label}, training] x ({R}, {D}) bf16: "
          f"max_abs_err {fwd_err.max().item():.3e} (tol {BF16_ATOL} + "
          f"{BF16_RTOL}*|ref|) ms {f_ms:.4f} plain {f_plain_ms:.4f} "
          f"F.layer_norm(fp32) {f_lib_ms:.4f} bound {f_b_ms:.4f} "
          f"({f_b_by})")
    del fwd_err
    xhat = (xf - xf.mean(-1, keepdim=True)) * torch.rsqrt(
        xf.var(-1, correction=0, keepdim=True) + 1e-5)
    err_x = (dx.float() - rx.float()).abs()
    ok = bool((err_x <= BF16_ATOL + BF16_RTOL * rx.float().abs()).all())
    err_wb = 0.0
    for out, ref, terms in ((dw, rw, (dyf * xhat).abs().sum(0)),
                            (db, rb, dyf.abs().sum(0))):
        e = (out - ref).abs()
        ok = ok and bool((e <= SUM_RTOL * terms + 1e-6).all())
        err_wb = max(err_wb, e.max().item())
    del xhat, rx
    ms = time_ms(torch, lambda: layernorm_triton.layer_norm_backward(
        x, w, dy), flush=flush)
    plain_ms = time_ms(torch, lambda: layernorm_triton
                       .layer_norm_bwd_plain(x, w, dy), flush=flush)
    _, mean, rstd = torch.ops.aten.native_layer_norm(xf, [D], w, b, 1e-5)
    lib_ms = time_ms(torch, lambda: torch.ops.aten
                     .native_layer_norm_backward(
                         dyf, xf, [D], mean, rstd, w, b,
                         [True, True, True]), flush=flush)
    b_ms, b_by = bound(3 * x.numel() * 2 + 3 * D * 4, 16.0 * R * D,
                       fp32_peak, mem_rate)
    again = layernorm_triton.layer_norm_backward(x, w, dy)
    bitwise = all(torch.equal(u, v) for u, v in zip(again, (dx, dw, db)))
    del again
    dev_names = device_launches(torch, lambda: layernorm_triton
                                .layer_norm_backward(x, w, dy))
    print(f"layernorm bwd [{label}] x ({R}, {D}) bf16: dx max_abs_err "
          f"{err_x.max().item():.3e} (tol {BF16_ATOL} + {BF16_RTOL}*|ref|)"
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
    if not ok:
        fail(f"layernorm bwd [{label}] disagrees with its plain version")
    if not passes:
        fail(f"layernorm bwd [{label}]: the autograd Function's "
             f"gradients are not the kernel's")
    return dict(shape=[R, D], dtype="bfloat16",
                max_abs_err=max(err_x.max().item(), err_wb), ms=ms,
                plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                bound_by=b_by, device_launches_per_call=len(dev_names)), fwd_row


def kmedoids_case(torch, flush, peaks, label, x, before_frames,
                  after_frames, K, iters):
    """Kernel E held (`hold_kmedoids`) and timed against its plain version
    on the patch tokens `x` [B * before_frames, 1 + P, width] a cluster
    layer took, grouped into `after_frames` segments per clip."""
    from centerclip_tpu_torch.ops import kmedoids_cuda
    from centerclip_tpu_torch.ops.cluster_layer import segment_major
    from centerclip_tpu_torch.ops.kmedoids import kmedoids_on_distances
    mem_rate, _, fp32_peak = peaks
    Bc = x.shape[0] // before_frames
    row, (X, D, l2, steps) = hold_kmedoids(torch, label, segment_major(
        x[:, 1:, :].reshape(Bc, before_frames, -1, x.shape[-1]),
        after_frames, before_frames // after_frames), K, iters)
    Bs, N = X.shape[0], X.shape[1]
    ms = time_ms(torch, lambda: kmedoids_cuda.kmedoids_from_distances(
        D, l2, K, iters), flush=flush)
    plain_ms = time_ms(torch, lambda: kmedoids_on_distances(
        X, D, l2, K, iter_limit=iters), flush=flush)
    st = steps.long()
    ops = float(Bs * 2 * K * N + (st * (2 * N * K + 2 * N * N)).sum()
                + Bs * N * K)
    # outputs: assign [B, N], meds [B, K], steps [B], all int32
    b_ms, b_by = bound(D.numel() * 4 + l2.numel() * 4 + Bs * N * 4
                       + Bs * K * 4 + steps.numel() * 4, ops,
                       fp32_peak, mem_rate)
    variant = kmedoids_cuda.choose_variant(N)
    print(f"kmedoids [{label}] {variant} variant: ms {ms:.4f} plain "
          f"{plain_ms:.4f} bound {b_ms:.5f} ({b_by})")
    return dict(row, variant=variant, ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by)


def vitb16_phase(torch, np, dev, flush, peaks, counters):
    """The fourth main path: ViT-B/16 (the preset msrvtt_vitb16_k6: L = 197
    in blocks 1-6, k-medoids of 2 x 196 = 392 tokens per segment into
    K = 160 before block 7, L = 161 after), encoding a gallery through
    `RetrievalEngine` and training through `Trainer` at batch 128 with
    `remat`; then kernels B and E at their new variants' shapes, and A, C
    and D at the new shapes, against their plain versions."""
    import tempfile
    from centerclip_tpu_torch.config import preset
    from centerclip_tpu_torch.models.clip4clip import CLIP4Clip
    from centerclip_tpu_torch.ops import _build, attention_cuda as ac
    from centerclip_tpu_torch.ops import kmedoids_cuda as kc
    from centerclip_tpu_torch.serve import RetrievalEngine
    from centerclip_tpu_torch.train import Trainer, resume, save_checkpoint
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

    def first_cluster_input(model, store):
        mod = next(b.tokencluster_inter
                   for b in model.clip.visual.transformer.resblocks
                   if b.tokencluster_inter is not None)

        def capture(module, args):
            store.setdefault("x", args[0].detach().clone())
        return mod.register_forward_pre_hook(capture)

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
    hook = first_cluster_input(model, enc_x)
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
    print(f"vitb16 encode: {N_CLIPS} clips in {t_build:.3f} s = "
          f"{N_CLIPS / t_build:.2f} clips/s (batches of {BATCH}; set-up and "
          f"warm-up {t_setup:.2f} s); launches {enc_launches}, by variant "
          f"{enc_variants}")
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
    if not km[kc.GLOBAL] or km[kc.SHARED] or fwd[ac.CUDA_CORE] or \
            fwd[ac.TENSOR_CORE_LONG] != 12 * n_batches or \
            not enc_launches["layer_norm"]:
        fail(f"the ViT-B/16 encode ran other kernel variants: {enc_variants}")
    del engine, index, gallery, model
    torch.cuda.empty_cache()

    # ---- training at batch 128: warm-up and timed steps, then resume
    t0 = time.time()
    model = CLIP4Clip(cfg, device=dev, seed=0)
    steps = VITB16_WARMUP_STEPS + VITB16_TIMED_STEPS
    trainer = Trainer(run, model, total_steps=steps + 1)
    g = np.random.default_rng(17)
    tok, amask = token_rows(np, g, B, cfg.max_words)
    batch = {"input_ids": tok, "attention_mask": amask,
             "video": g.integers(0, 256, (B, 1, cfg.max_frames, 3, RES, RES),
                                 dtype=np.uint8),
             "video_mask": np.ones((B, cfg.max_frames), np.int32)}
    t_setup = time.time() - t0
    train_x = {}
    hook = first_cluster_input(model, train_x)
    zero_counts(counters)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_s, losses = [], []
    for _ in range(steps):
        t0 = time.time()
        loss, _ = trainer.train_epoch(0, [batch], n_display=1)
        torch.cuda.synchronize()
        step_s.append(time.time() - t0)
        losses.append(loss)
        hook.remove()
        if not np.isfinite(loss):
            fail(f"ViT-B/16 training loss {loss} is not finite")
    peak = torch.cuda.max_memory_allocated()
    launches = {fn.__name__: fn.launches for fn in counters}
    train_variants = variants()
    timed = sorted(step_s[VITB16_WARMUP_STEPS:])
    med = timed[len(timed) // 2]
    print(f"vitb16 training ({VITB16_PRESET}, batch {B}, remat "
          f"{'on' if cfg.remat else 'off'}: {VITB16_REMAT_WHY}; set-up "
          f"{t_setup:.2f} s): losses {[round(x, 6) for x in losses]}, step "
          f"times {[round(x * 1e3, 3) for x in step_s]} ms; median of the "
          f"{VITB16_TIMED_STEPS} timed {med * 1e3:.3f} ms = {B / med:.2f} "
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
                ac.CUDA_CORE: 0}
    want_fwd = {ac.TENSOR_CORE_LONG: 12 * per_fwd * steps,
                ac.TENSOR_CORE: 12 * per_fwd * steps, ac.CUDA_CORE: 0}
    if bwd != want_bwd or fwd != want_fwd or \
            kmv != {kc.GLOBAL: steps, kc.SHARED: 0}:
        fail(f"the ViT-B/16 training steps ran other kernel variants than "
             f"the long attention variants (forward {want_fwd}, backward "
             f"{want_bwd}) and the global k-medoids: {train_variants}")
    for fn_name, n in launches.items():
        if n == 0:
            fail(f"{fn_name} was never launched on the ViT-B/16 path")

    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        path = save_checkpoint(tmp, trainer.state, epoch=0, best_r1=0.0)
        other = CLIP4Clip(cfg, device=dev, seed=1)
        trainer2 = Trainer(run, other, total_steps=steps + 1)
        _, epoch, _ = resume(path, trainer2.state)
    if trainer2.state.global_step != trainer.state.global_step or epoch != 1:
        fail("the ViT-B/16 resume did not restore the step counters")
    trainer.train_epoch(1, [batch], n_display=1)
    trainer2.train_epoch(1, [batch], n_display=1)
    other_sd = other.state_dict()
    diff = [k for k, v in model.state_dict().items()
            if not torch.equal(v, other_sd[k])]
    print(f"vitb16 resumed step: {len(diff)} of {len(other_sd)} tensors "
          f"differ from the uninterrupted step")
    if diff:
        fail(f"the ViT-B/16 resumed step differs: {diff[:5]}")
    del trainer, trainer2, model, other, other_sd, batch
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
        step_ms=med * 1e3, clips_per_s=B / med,
        step_ms_all=[x * 1e3 for x in step_s], losses=losses,
        peak_memory_bytes=peak, resumed_step_equal=True,
        encode_clips=N_CLIPS, encode_s=t_build,
        encode_clips_per_s=N_CLIPS / t_build)
    return result, dict(
        launches=launches, variants=train_variants,
        encode_launches=enc_launches, encode_variants=enc_variants,
        attention_bwd=bwd_rows, attention_fwd=fwd_rows,
        layernorm_bwd=ln_rows, layernorm_fwd=lnf_rows, kmedoids=km_rows)


def write_msrvtt_fixture(np, root):
    """The synthetic MSR-VTT: videos/<id>.npy, videos.fstore (the port's
    FrameStoreWriter), train.csv, test.csv (the csv module) and
    MSRVTT_data.json.  Returns the .fstore's path."""
    import csv
    from centerclip_tpu_torch.data.framestore import FrameStoreWriter
    g = np.random.default_rng(5)
    vids = [f"video{i}" for i in range(MAIN_VIDEOS)]
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
    with open(os.path.join(root, "MSRVTT_data.json"), "w") as f:
        json.dump({"sentences": [{"video_id": v, "caption": c}
                                 for v in vids for c in captions[v]],
                   "videos": [{"video_id": v} for v in vids]}, f)
    return store


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
def recording_kernel_inputs(torch, seen, active=lambda: True):
    """Within the block, keep in `seen` a copy of the first input of each
    shape that kernels A, C and E take at the model's call sites, while
    `active()` holds.  The copies are made on first sight only."""
    sites = kernel_call_sites()
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


def hold_recorded(torch, seen, label, what):
    """Kernels A, C and E against their plain versions on the inputs
    `recording_kernel_inputs` kept, with the kernel phase's tolerances;
    rows by kernel.  Fails if a kernel got no input in `what`."""
    from centerclip_tpu_torch.ops import attention_cuda, layernorm_triton
    held = {"attention_fwd": [], "layernorm_fwd": [], "kmedoids": []}
    for (kernel, key), (args, kw) in seen.items():
        case = f"{label} {tuple(args[0].shape)}"
        if kernel == "attention_fwd":
            qkv, H, mask = (list(args) + [None])[:3]
            err = hold_close(torch, f"attention [{case}]",
                             attention_cuda.fused_attention(qkv, H, mask),
                             attention_cuda.attention_plain(qkv, H, mask),
                             BF16_ATOL, BF16_RTOL)
            row = dict(shape=list(qkv.shape), max_abs_err=err)
        elif kernel == "layernorm_fwd":
            x = args[0]
            atol, rtol = ((BF16_ATOL, BF16_RTOL)
                          if x.dtype == torch.bfloat16
                          else (FP32_ATOL, FP32_RTOL))
            err = hold_close(torch, f"layernorm [{case}]",
                             layernorm_triton.layer_norm(*args),
                             layernorm_triton.layer_norm_plain(*args),
                             atol, rtol)
            row = dict(shape=list(x.shape), dtype=str(x.dtype)
                       .split(".")[-1], max_abs_err=err)
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
                    "kmedoids_from_distances"):
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
            torch, lambda: flat.search_device(qb, IVF_K), flush)
        for p in IVF_NPROBES:
            search_ms[f"ivf{p}_b{b}"] = time_ms(
                torch, lambda: ivf.search_device(qb, IVF_K, nprobe=p), flush)
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
    mem_rate, bf16_peak, fp32_peak = peaks
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

    # ----------------------------------------------------- serving (main path)
    cfg = flagship_config()
    t0 = time.time()
    model = build_model(cfg, dev, seed=0)
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

    # warm-up on a 2-clip gallery (Triton compiles its kernel and CUDA loads
    # each kernel module at first launch): not counted, not timed
    engine.build_index(batches(0, 2), video_ids[:2], quantize="int8")
    engine.search(QUERIES, k=2)
    torch.cuda.synchronize()

    # capture the main path's k-medoids input for the kernel phase
    captured = {}
    cluster_mod = next(b.tokencluster_inter
                       for b in model.clip.visual.transformer.resblocks
                       if b.tokencluster_inter is not None)

    def capture(module, args):
        if "x" not in captured:
            captured["x"] = args[0].detach().clone()
    hook = cluster_mod.register_forward_pre_hook(capture)

    counters = (attention_cuda.fused_attention,
                attention_cuda.attention_backward, layernorm_triton.layer_norm,
                layernorm_triton.layer_norm_backward,
                kmedoids_cuda.kmedoids_from_distances)
    serving_kernels = ("fused_attention", "layer_norm",
                       "kmedoids_from_distances")
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
    for fn_name in serving_kernels:
        if launches[fn_name] == 0:
            fail(f"{fn_name} was never launched on the serving path")
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

    # ---------------------------------------------- training (second path)
    train, train_batch, train_cluster_x = training_phase(torch, np, dev,
                                                         counters)
    torch.cuda.empty_cache()

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
        ms = time_ms(torch, lambda: attention_cuda.fused_attention(
            qkv, H, mask), flush=flush)
        plain_ms = time_ms(torch, lambda: attention_cuda.attention_plain(
            qkv, H, mask), flush=flush)
        lib_ms = time_ms(torch, lambda: torch.nn.functional
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
        xf = x.float()
        ms = time_ms(torch, lambda: layernorm_triton.layer_norm(x, w, b),
                     flush=flush)
        plain_ms = time_ms(torch, lambda: layernorm_triton.layer_norm_plain(
            x, w, b), flush=flush)
        lib_ms = time_ms(torch, lambda: torch.nn.functional.layer_norm(
            xf, (D,), w, b, 1e-5), flush=flush)
        b_ms, b_by = bound(2 * x.numel() * x.element_size() + 2 * D * 4,
                           8.0 * R * D, fp32_peak, mem_rate)
        print(f"layernorm [{label}] x ({R}, {D}) {dt}: max_abs_err "
              f"{err.max().item():.3e} (tol {atol} + {rtol}*|ref|) ms "
              f"{ms:.4f} plain {plain_ms:.4f} F.layer_norm(fp32) "
              f"{lib_ms:.4f} bound {b_ms:.4f} ({b_by})")
        if not ok:
            fail(f"layernorm [{label}] disagrees with its plain version")
        ln_rows.append(dict(shape=[R, D], dtype=str(dt).split(".")[-1],
                            max_abs_err=err.max().item(), ms=ms,
                            plain_ms=plain_ms, library_ms=lib_ms,
                            bound_ms=b_ms, bound_by=b_by))
    a = ln_rows[0]
    results.append(dict(
        name="layernorm_fwd", route="triton",
        source="centerclip_tpu_torch/ops/layernorm_triton.py",
        replaces="centerclip_tpu/ops/layernorm_pallas.py:83",
        counter="layer_norm",
        max_abs_err=max(r["max_abs_err"] for r in ln_rows),
        ms=a["ms"], plain_ms=a["plain_ms"], bound_ms=a["bound_ms"],
        bound_by=a["bound_by"], library_ms=a["library_ms"], shapes=ln_rows))

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
    del flush
    torch.cuda.empty_cache()

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

    def cosines(a, b):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1)
                                  * np.linalg.norm(b, axis=-1))
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

    # ----------------------------------------- main (third path) + report
    import tempfile
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as root:
        main_res, handoff = main_phase(torch, np, dev, counters, root)
        path_counts["main"] = (main_res["launches"], main_res["variants"])
        for kernel, rows in main_res["held"].items():
            extend_forward_row(kernel, rows, key="main_shapes")
        torch.cuda.empty_cache()

        # ------------------------------ serve CLI (fifth path) + report
        flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
        serve_res = serve_phase(torch, np, dev, counters, root, handoff,
                                flush)
        del flush, handoff
        path_counts["serve_cli"] = (serve_res.pop("launches"),
                                    serve_res.pop("variants"))
        for kernel, rows in serve_res.pop("held").items():
            extend_forward_row(kernel, rows, key="serve_cli_shapes")
        torch.cuda.empty_cache()

    # ------------------------------------ ViT-B/16 (fourth path) + report
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    vitb16, b16 = vitb16_phase(torch, np, dev, flush, peaks, counters)
    del flush
    path_counts["vitb16_encode"] = (b16["encode_launches"],
                                    b16["encode_variants"])
    path_counts["vitb16_training"] = (b16["launches"], b16["variants"])
    for kernel in ("attention_fwd", "attention_bwd", "layernorm_fwd",
                   "layernorm_bwd", "kmedoids"):
        extend_forward_row(kernel, b16[kernel], key="vitb16_shapes")
    for row in results:
        row.update(path_launches(row.pop("counter")))
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

    print(f"total {time.time() - t_start:.1f} s")
    print(json.dumps({"training": {**{k: v for k, v in train.items()
                                       if k not in ("launches", "variants")},
                                   "cpu_check": train_check}}))
    print(json.dumps({"main": {k: v for k, v in main_res.items()
                               if k not in ("launches", "variants",
                                            "held")}}))
    print(json.dumps({"vitb16": vitb16}))
    print(json.dumps({"serve": serve_res}))
    print(json.dumps({"kernels": results}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
