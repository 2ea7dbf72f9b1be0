#!/usr/bin/env python3
# coding=utf-8
"""Drive the PyTorch/CUDA port (`centerclip_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

1. Prints the card (nvidia-smi name and power limit), checks that TF32 is
   off, and builds the CUDA C++ kernels from `centerclip_tpu_torch/csrc`
   (one nvcc per source, all started together).
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
   counted by torch.profiler), with errors, CUDA-event times, the time
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

Prints a JSON line of per-kernel results and, last, one JSON line
{"ok": true, "device": {...}}.  Any failed check exits non-zero before it.
Without a CUDA device it exits non-zero at once.
"""
from __future__ import annotations

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


def device_launches(torch, fn):
    """Device activities (kernels, copies, memsets) of one call of `fn`, as
    torch.profiler records them; fails if it records none."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    if not names:
        fail("the profiler recorded no device activity")
    return names


def zero_counts(counters):
    """Zero every kernel's launch count, and attention's by variant."""
    from centerclip_tpu_torch.ops import attention_cuda
    for fn in counters:
        fn.launches = 0
    attention_cuda.reset_counts()


def attention_variant_counts(path, backward):
    """The attention wrappers' launches by variant since the counts were
    zeroed; fails unless the tensor-core variants ran (the backward only on
    the training path) and the CUDA-core (fp32) variants did not."""
    from centerclip_tpu_torch.ops import attention_cuda as ac
    counts = {fn.__name__: dict(fn.variant_launches)
              for fn in (ac.fused_attention, ac.attention_backward)}
    print(f"attention launches by variant during the {path} path: {counts}")
    for name, by in counts.items():
        if by[ac.CUDA_CORE]:
            fail(f"{name} launched its CUDA-core variant on the {path} path")
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
    if trainer2.state.global_step != trainer.state.global_step or epoch != 0:
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


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from centerclip_tpu_torch.ops import (_build, attention_cuda,
                                          kmedoids_cuda, layernorm_triton)
    from centerclip_tpu_torch.ops.kmedoids import (kmedoids_inputs,
                                                   kmedoids_on_distances)
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
    mem_rate, bf16_peak, fp32_peak = card_peaks(name)
    dev = torch.device("cuda")

    # ---------------------------------------------------------------- build
    t0 = time.time()
    report = _build.build(force=True)
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

    def path_launches(fn_name):
        by_path = {"serving": launches[fn_name],
                   "training": train["launches"][fn_name]}
        out = dict(launches=sum(by_path.values()), launches_by_path=by_path)
        if fn_name in serving_variants:
            out["launches_by_variant"] = {
                path: by[fn_name] for path, by in
                (("serving", serving_variants),
                 ("training", train["variants"]))}
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
        variant=a["variant"], **path_launches("fused_attention"),
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
        **path_launches("layer_norm"),
        max_abs_err=max(r["max_abs_err"] for r in ln_rows),
        ms=a["ms"], plain_ms=a["plain_ms"], bound_ms=a["bound_ms"],
        bound_by=a["bound_by"], library_ms=a["library_ms"], shapes=ln_rows))

    # k-medoids on the tokens the serving phase (first batch) and the first
    # training step clustered
    from centerclip_tpu_torch.ops.cluster_layer import segment_major
    spec = cluster_mod.spec
    K, iters = spec.cluster_num, cfg.cluster.iter_limit

    def kmedoids_case(label, x):
        Bc = x.shape[0] // spec.before_frames
        X, D, l2 = kmedoids_inputs(segment_major(
            x[:, 1:, :].reshape(Bc, spec.before_frames, -1, x.shape[-1]),
            spec.after_frames, spec.frame_duration))
        a1, m1, steps = kmedoids_cuda.kmedoids_from_distances(D, l2, K, iters)
        a2, m2 = kmedoids_on_distances(X, D, l2, K, iter_limit=iters)
        torch.cuda.synchronize()
        same = (m1 == m2).all(dim=1)
        n_diff = int((~same).sum())

        def cost(meds, assign):
            med_of = torch.gather(meds.long(), 1, assign.long())
            return torch.gather(D.double(), 1,
                                med_of[:, None, :])[:, 0].sum(-1)
        c1, c2 = cost(m1, a1), cost(m2, a2)
        cost_rel = ((c1 - c2).abs() / c2.abs()).max().item()
        Bs, N = X.shape[0], X.shape[1]
        ms = time_ms(torch, lambda: kmedoids_cuda.kmedoids_from_distances(
            D, l2, K, iters), flush=flush)
        plain_ms = time_ms(torch, lambda: kmedoids_on_distances(
            X, D, l2, K, iter_limit=iters), flush=flush)
        st = steps.long()
        ops = float(Bs * 2 * K * N + (st * (2 * N * K + 2 * N * N)).sum()
                    + Bs * N * K)
        b_ms, b_by = bound(D.numel() * 4 + l2.numel() * 4 + a1.numel() * 4
                           + m1.numel() * 4 + steps.numel() * 4, ops,
                           fp32_peak, mem_rate)
        print(f"kmedoids [{label}] X {tuple(X.shape)} K={K}: segments with "
              f"other ids {n_diff}/{Bs}, max relative cost gap "
              f"{cost_rel:.3e} (tol {KMEDOIDS_COST_RTOL}), Lloyd steps "
              f"min/mean/max {int(st.min())}/{st.float().mean().item():.2f}/"
              f"{int(st.max())} ms {ms:.4f} plain {plain_ms:.4f} bound "
              f"{b_ms:.5f} ({b_by})")
        if n_diff and cost_rel > KMEDOIDS_COST_RTOL:
            fail(f"k-medoids kernel [{label}] found a costlier clustering "
                 f"than its plain version")
        if same.float().mean().item() < KMEDOIDS_MIN_SAME:
            fail(f"k-medoids [{label}] ids differ on {n_diff}/{Bs} segments")
        if not torch.equal(a1[same], a2[same]):
            fail(f"k-medoids [{label}] assignments differ where the medoids "
                 f"agree")
        return dict(shape=list(X.shape), max_abs_err=float((m1 != m2).sum()),
                    ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                    segments_differing=n_diff, max_rel_cost_gap=cost_rel,
                    lloyd_steps_mean=st.float().mean().item())
    km_rows = [kmedoids_case("serving", captured["x"]),
               kmedoids_case("training", train_cluster_x)]
    del train_cluster_x
    a = km_rows[0]
    results.append(dict(
        name="kmedoids", route="cuda",
        source="centerclip_tpu_torch/csrc/kmedoids.cu",
        replaces="centerclip_tpu/ops/kmedoids_pallas.py:220",
        **path_launches("kmedoids_from_distances"),
        max_abs_err=max(r["max_abs_err"] for r in km_rows),
        ms=a["ms"], plain_ms=a["plain_ms"], bound_ms=a["bound_ms"],
        bound_by=a["bound_by"], library_ms=None,
        segments_differing=a["segments_differing"],
        max_rel_cost_gap=a["max_rel_cost_gap"],
        lloyd_steps_mean=a["lloyd_steps_mean"], shapes=km_rows))

    def extend_forward_row(kernel, rows):
        """Add a forward kernel's errors (and, for LayerNorm, times) at the
        training shapes to its row (its top-level times stay those of the
        first serving shape)."""
        row = next(r for r in results if r["name"] == kernel)
        row["training_shapes"] = rows
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
    for label, B, L, H, mask_kind in bwd_cases:
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
        attn_train_rows.append(dict(shape=list(qkv.shape),
                                    max_abs_err=fwd_err.max().item()))
        print(f"attention [{label}, training] qkv {tuple(qkv.shape)} bf16 "
              f"H={H}: max_abs_err {fwd_err.max().item():.3e} (tol "
              f"{BF16_ATOL} + {BF16_RTOL}*|ref|)")
        del out, fwd_ref, fwd_err
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
        print(f"attention bwd [{label}] qkv {tuple(qkv.shape)} bf16 H={H}, "
              f"{variant} variant: max_abs_err {err.max().item():.3e} (tol "
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
        bwd_rows.append(dict(shape=list(qkv.shape), variant=variant,
                             max_abs_err=err.max().item(),
                             share_differing=differing, ms=ms,
                             plain_ms=plain_ms, library_ms=lib_ms,
                             vs_library=ms / lib_ms, bound_ms=b_ms,
                             bound_by=b_by))
        del qkv, dout, dqkv
    extend_forward_row("attention_fwd", attn_train_rows)
    a = bwd_rows[0]
    results.append(dict(
        name="attention_bwd", route="cuda",
        source="centerclip_tpu_torch/csrc/attention_bwd.cu",
        replaces="centerclip_tpu/ops/attention_pallas.py:325",
        variant=a["variant"], **path_launches("attention_backward"),
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
    for label, R, D in lnb_cases:
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
        ln_train_rows.append(dict(shape=[R, D], dtype="bfloat16",
                                  max_abs_err=fwd_err.max().item(), ms=f_ms,
                                  plain_ms=f_plain_ms, library_ms=f_lib_ms,
                                  bound_ms=f_b_ms, bound_by=f_b_by))
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
        lnb_rows.append(dict(shape=[R, D], dtype="bfloat16",
                             max_abs_err=max(err_x.max().item(), err_wb),
                             ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                             bound_ms=b_ms, bound_by=b_by,
                             device_launches_per_call=len(dev_names)))
        del x, dy, xf, dyf, dx, mean, rstd
    extend_forward_row("layernorm_fwd", ln_train_rows)
    a = lnb_rows[0]
    results.append(dict(
        name="layernorm_bwd", route="triton",
        source="centerclip_tpu_torch/ops/layernorm_triton.py",
        replaces="centerclip_tpu/ops/layernorm_pallas.py:103",
        **path_launches("layer_norm_backward"),
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

    print(f"total {time.time() - t_start:.1f} s")
    print(json.dumps({"training": {**{k: v for k, v in train.items()
                                       if k not in ("launches", "variants")},
                                   "cpu_check": train_check}}))
    print(json.dumps({"kernels": results}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
