#!/usr/bin/env python3
# coding=utf-8
"""Drive the PyTorch/CUDA port (`centerclip_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

1. Prints the card (nvidia-smi name and power limit), checks that TF32 is
   off, and builds the CUDA C++ kernels from `centerclip_tpu_torch/csrc`
   (one nvcc per source, all started together).
2. Serving phase, the port's main path: a full-width ViT-B/32 CLIP4Clip
   (meanP, kmediods++ clustering 12 -> 6 frames before block 7, K = 49,
   bf16 towers) on seeded random weights; `RetrievalEngine.build_index` over
   64 seeded uint8 clips [12, 3, 224, 224] in batches of 32 (int8 index),
   then `search` with 4 text queries (k = 5).  Every kernel's launch count
   is zeroed just before this phase and must have moved just after it.
3. Kernel phase: each kernel against its plain PyTorch version on the card,
   on the main path's shapes (the k-medoids inputs are the tokens the
   serving phase clustered), with errors, CUDA-event times, the time of one
   PyTorch library call for the same function where there is one, and the
   least time the card could take (bytes over the memory rate, or
   operations over the peak rate, whichever is larger).
4. CPU check: 2 clips and the 4 queries again through the port on the CPU
   (plain versions, same weights and dtype), held to the card's embeddings
   by cosine.

Prints a JSON line of per-kernel results and, last, one JSON line
{"ok": true, "device": {...}}.  Any failed check exits non-zero before it.
Without a CUDA device it exits non-zero at once.
"""
from __future__ import annotations

import json
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
# bf16 kernel vs plain version: both round the same fp32 values to bf16, so
# they differ by at most about one bf16 ulp (2^-7 relative at 1)
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

N_CLIPS, BATCH, FRAMES, RES = 64, 32, 12, 224
SEARCH_REPEATS = 20
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


def build_model(cfg, device, seed=0):
    from centerclip_tpu_torch.models.clip4clip import CLIP4Clip
    return CLIP4Clip(cfg, device=device, seed=seed).eval()


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

    counters = (attention_cuda.fused_attention, layernorm_triton.layer_norm,
                kmedoids_cuda.kmedoids_from_distances)
    for fn in counters:
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.time()
    index = engine.build_index(batches(), video_ids, quantize="int8")
    torch.cuda.synchronize()
    t_build = time.time() - t0
    t0 = time.time()
    hits = engine.search(QUERIES, k=5)
    t_search = time.time() - t0
    launches = {fn.__name__: fn.launches for fn in counters}
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
    for fn_name, n in launches.items():
        if n == 0:
            fail(f"{fn_name} was never launched on the main path")
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
        print(f"attention [{label}] qkv {tuple(qkv.shape)} bf16 H={H}: "
              f"max_abs_err {err.max().item():.3e} (tol {BF16_ATOL} + "
              f"{BF16_RTOL}*|ref|) ms {ms:.4f} plain {plain_ms:.4f} "
              f"sdpa {lib_ms:.4f} bound {b_ms:.4f} ({b_by})")
        if not ok:
            fail(f"attention [{label}] disagrees with its plain version")
        attn_rows.append(dict(shape=list(qkv.shape), max_abs_err=err.max()
                              .item(), ms=ms, plain_ms=plain_ms,
                              library_ms=lib_ms, bound_ms=b_ms,
                              bound_by=b_by))
    a = attn_rows[0]
    results.append(dict(
        name="attention_fwd", route="cuda",
        source="centerclip_tpu_torch/csrc/attention.cu",
        replaces="centerclip_tpu/ops/attention_pallas.py:204",
        launches=launches["fused_attention"],
        max_abs_err=max(r["max_abs_err"] for r in attn_rows),
        ms=a["ms"], plain_ms=a["plain_ms"], bound_ms=a["bound_ms"],
        bound_by=a["bound_by"], library_ms=a["library_ms"],
        shapes=attn_rows))

    # LayerNorm: the main path's row counts and dtypes
    ln_cases = [("vision ln_pre/ln_1/ln_2, blocks 1-6", 384 * 50, 768,
                 torch.bfloat16),
                ("vision ln_1/ln_2, blocks 7-12", 192 * 50, 768,
                 torch.float32),
                ("vision ln_post (CLS)", 192, 768, torch.float32),
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
        launches=launches["layer_norm"],
        max_abs_err=max(r["max_abs_err"] for r in ln_rows),
        ms=a["ms"], plain_ms=a["plain_ms"], bound_ms=a["bound_ms"],
        bound_by=a["bound_by"], library_ms=a["library_ms"], shapes=ln_rows))

    # k-medoids on the tokens the serving phase clustered (first batch)
    from centerclip_tpu_torch.ops.cluster_layer import segment_major
    spec = cluster_mod.spec
    x = captured["x"]
    Bc = x.shape[0] // spec.before_frames
    X, D, l2 = kmedoids_inputs(segment_major(
        x[:, 1:, :].reshape(Bc, spec.before_frames, -1, x.shape[-1]),
        spec.after_frames, spec.frame_duration))
    K, iters = spec.cluster_num, cfg.cluster.iter_limit
    a1, m1, steps = kmedoids_cuda.kmedoids_from_distances(D, l2, K, iters)
    a2, m2 = kmedoids_on_distances(X, D, l2, K, iter_limit=iters)
    torch.cuda.synchronize()
    same = (m1 == m2).all(dim=1)
    n_diff = int((~same).sum())

    def cost(meds, assign):
        med_of = torch.gather(meds.long(), 1, assign.long())
        return torch.gather(D.double(), 1, med_of[:, None, :])[:, 0].sum(-1)
    c1, c2 = cost(m1, a1), cost(m2, a2)
    cost_rel = ((c1 - c2).abs() / c2.abs()).max().item()
    ids_err = float((m1 != m2).sum())
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
    print(f"kmedoids X {tuple(X.shape)} K={K}: segments with other ids "
          f"{n_diff}/{Bs}, max relative cost gap {cost_rel:.3e} (tol "
          f"{KMEDOIDS_COST_RTOL}), Lloyd steps min/mean/max "
          f"{int(st.min())}/{st.float().mean().item():.2f}/{int(st.max())}"
          f" ms {ms:.4f} plain {plain_ms:.4f} bound {b_ms:.5f} ({b_by})")
    if n_diff and cost_rel > KMEDOIDS_COST_RTOL:
        fail("k-medoids kernel found a costlier clustering than its plain "
             "version")
    if same.float().mean().item() < KMEDOIDS_MIN_SAME:
        fail(f"k-medoids ids differ on {n_diff}/{Bs} segments")
    if not torch.equal(a1[same], a2[same]):
        fail("k-medoids assignments differ where the medoids agree")
    results.append(dict(
        name="kmedoids", route="cuda",
        source="centerclip_tpu_torch/csrc/kmedoids.cu",
        replaces="centerclip_tpu/ops/kmedoids_pallas.py:218",
        launches=launches["kmedoids_from_distances"], max_abs_err=ids_err,
        ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
        library_ms=None, segments_differing=n_diff,
        max_rel_cost_gap=cost_rel, lloyd_steps_mean=st.float().mean()
        .item()))

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

    print(f"total {time.time() - t_start:.1f} s")
    print(json.dumps({"kernels": results}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
