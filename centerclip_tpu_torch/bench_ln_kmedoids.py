# coding=utf-8
"""Time kernel C (LayerNorm forward) and kernel E's global and cluster
variants (k-medoids, N > SHARED_MAX_N) against an earlier version of
each, in turns.

    python -m centerclip_tpu_torch.bench_ln_kmedoids --old DIR

DIR holds the `centerclip_tpu_torch/` tree of an earlier commit (`git
archive <commit> centerclip_tpu_torch | tar -x -C DIR`, unpacked where git
ignores it): that package is imported under another name, and its own
`ops/_build.py` builds its kernel sources into its own `build/`.
`chip_smoke.py` times each kernel alone; this times the two versions of
each in turns (old, new, new, old) in one process, with `kernel_timing`'s
helpers.

C: at every shape `chip_smoke.py` times it at (`LAYERNORM_FWD_SHAPES`),
both versions held against `layer_norm_plain` (one bf16 ulp, fp32 1e-5)
and timed beside the plain version, `F.layer_norm` on the same input and
on an fp32 copy, and the bound.  Its host cost (`HOST_SHAPES`, each
version twice in turns) on inputs that need no gradient (serving,
encoding) and with gamma and beta that do (training: the autograd
Function's path).

E: on the tokens ViT-B/16's cluster layer takes (preset
msrvtt_vitb16_k6, seeded weights and clips, the vision tower in eval mode):
an encode batch of 32 clips (D [192, 392, 392]) and the training batch of
128 (D [768, 392, 392]), K = 160, the global variant's; then the same
tokens with the rows of consecutive segments joined into segments of 784
(D [384, 784, 784] and [96, 784, 784]), 588 ([512, 588, 588]) and 2352
tokens (the first 8: [8, 2352, 2352]); then the sixteenth path's tokens
(60 frames in 3 segments of 3920: an encode batch of 32 clips, D
[96, 3920, 3920], and a training batch of 16, [48, 3920, 3920]) at K = 160
and 392, and joined into 12-frame segments at K = N = 2352 ([8, 2352,
2352]).  Each version's wrapper picks its own variant (the parent's
large or scratch one against the cluster one past N = 512).  Both must
give the same ids, assignment and steps; each timed in full and with iter_limit 0 (KKZ, the id sort and the
last assignment alone) in turns with the new one, beside both bounds
(`kmedoids_bound`, `kmedoids_sector_bound`), with the cluster size and the
mean Lloyd steps.  Prints the card and one JSON line.  Needs a CUDA
device.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import torch

from .kernel_timing import (LAYERNORM_FWD_SHAPES, card_peaks,
                            host_us_per_call, kmedoids_bound,
                            kmedoids_sector_bound, layernorm_bound,
                            layernorm_times, time_ms)
from .ops import kmedoids_cuda, layernorm_triton

HOST_SHAPES = ((128, 512), (4800, 768))
E_PRESET, E_CLIPS, E_FRAMES, E_RES = "msrvtt_vitb16_k6", (32, 128), 12, 224
# the sixteenth path's clips: an encode batch and a training batch
SEG20_FRAMES, SEG20_SEGMENTS, SEG20_CLIPS = 60, 3, (32, 16)
BF16_ATOL, BF16_RTOL = 1.6e-2, 1.6e-2
FP32_ATOL, FP32_RTOL = 1e-5, 1e-5


def in_turns(f_old, f_new, timer):
    """(old, new) as the means of four turns: old, new, new, old."""
    t = [timer(f) for f in (f_old, f_new, f_new, f_old)]
    return (t[0] + t[3]) / 2, (t[1] + t[2]) / 2, t


def load_old(tree: str):
    """The earlier version's `centerclip_tpu_torch` package, imported from
    `tree` under another name, so that its modules import its own `_build`
    (which builds its own kernel sources into its own build directory)."""
    name = "old_centerclip_tpu_torch"
    pkg = os.path.join(tree, "centerclip_tpu_torch")
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(pkg, "__init__.py"),
        submodule_search_locations=[pkg])
    old = importlib.util.module_from_spec(spec)
    sys.modules[name] = old
    spec.loader.exec_module(old)
    importlib.import_module(f"{name}.ops.layernorm_triton")
    importlib.import_module(f"{name}.ops.kmedoids_cuda")
    return old


def layernorm_rows(old_ln, flush, dev, peaks):
    rows = []
    for label, R, D, dtype in LAYERNORM_FWD_SHAPES:
        gen = torch.Generator(device=dev).manual_seed(R)
        x = (torch.randn((R, D), generator=gen, device=dev) * 3 + 1).to(dtype)
        w = torch.randn(D, generator=gen, device=dev) * 0.1 + 1
        b = torch.randn(D, generator=gen, device=dev)
        atol, rtol = ((FP32_ATOL, FP32_RTOL) if dtype == torch.float32
                      else (BF16_ATOL, BF16_RTOL))
        ref = layernorm_triton.layer_norm_plain(x, w, b).float()
        errs = {}
        for name, fwd in (("new", layernorm_triton._forward),
                          ("old", old_ln._forward)):
            err = (fwd(x, w, b, 1e-5).float() - ref).abs()
            if not bool((err <= atol + rtol * ref.abs()).all()):
                raise SystemExit(f"bench: {name} layernorm [{label}] "
                                 f"disagrees with its plain version")
            errs[name] = err.max().item()
        del ref
        row = dict(label=label, shape=[R, D], dtype=str(dtype).split(".")[-1],
                   max_abs_err=errs)
        row["old_ms"], row["new_ms"], row["turns_ms"] = in_turns(
            lambda: old_ln._forward(x, w, b, 1e-5),
            lambda: layernorm_triton._forward(x, w, b, 1e-5),
            lambda f: time_ms(f, flush))
        row.update(layernorm_times(x, w, b, flush))
        row["bound_ms"], row["bound_by"] = layernorm_bound(x, peaks)
        print(json.dumps(row))
        rows.append(row)
    host = []
    for R, D in HOST_SHAPES:
        x = torch.randn((R, D), device=dev).to(torch.bfloat16)
        w = torch.ones(D, device=dev)
        b = torch.zeros(D, device=dev)
        wg, bg = (t.clone().requires_grad_(True) for t in (w, b))
        calls = {"us": lambda: layernorm_triton.layer_norm(x, w, b),
                 "us_autograd": lambda: layernorm_triton.layer_norm(x, wg, bg),
                 "old_us": lambda: old_ln.layer_norm(x, w, b),
                 "old_us_autograd": lambda: old_ln.layer_norm(x, wg, bg)}
        row = dict(shape=[R, D])
        for turn in range(2):           # every path twice, in turns
            for key, fn in calls.items():
                row.setdefault(key, []).append(host_us_per_call(fn))
        print(json.dumps(row))
        host.append(row)
    return rows, host


def vitb16_points(dev, frames=E_FRAMES, clips=E_CLIPS, segments=None):
    """[[S, N, 768] points the cluster layer clustered, K, keywords] of one
    eval forward of each batch size in `clips`, at preset msrvtt_vitb16_k6
    on `frames` frames (with `segments`: clustered before block 7 in that
    many segments of 196 frames / segments tokens, K = 160, as the
    sixteenth path's flags do)."""
    import dataclasses
    from .config import preset
    from .models.clip4clip import CLIP4Clip
    from .ops import cluster_layer
    from .serve import RetrievalEngine
    cfg = preset(E_PRESET).model
    if segments is not None:
        cfg = dataclasses.replace(cfg, max_frames=frames, cluster=dataclasses
                                  .replace(cfg.cluster,
                                           cluster_num_blocks=(196,) * 6
                                           + (160,) * 6,
                                           target_frames_blocks=(frames,) * 6
                                           + (segments,) * 6))
    model = CLIP4Clip(cfg, device=dev, seed=0).eval()
    engine = RetrievalEngine(model, device=dev)
    seen, real = {}, cluster_layer.kmedoids

    def record(points, K, **kw):
        seen.setdefault(points.shape[0], (points.detach().clone(), K, kw))
        return real(points, K, **kw)
    cluster_layer.kmedoids = record
    try:
        g = np.random.default_rng(16)
        for n in clips:
            video = g.integers(0, 256, (n, 1, frames, 3, E_RES, E_RES),
                               dtype=np.uint8)
            engine.embed_video_batches([{"video": video, "video_mask":
                                         np.ones((n, frames), np.int32)}])
    finally:
        cluster_layer.kmedoids = real
    del engine, model
    torch.cuda.empty_cache()
    per_clip = frames // 2 if segments is None else segments
    return [seen[n * per_clip] for n in clips]


def kmedoids_cases(dev):
    """(points, K, keywords) of the global variant's ViT-B/16 shapes, then
    the cluster variant's from the same tokens, consecutive rows joined;
    then the sixteenth path's tokens (60 frames in 3 segments of 3920):
    an encode batch of 32 clips and a training batch of 16, at K = 160 and
    392, and 12-frame segments of them at K = N = 2352."""
    cases = vitb16_points(dev)
    train, enc = cases[1][0], cases[0][0]
    W = train.shape[-1]
    for points, n in ((train, 784), (enc, 784), (train, 588),
                      (train, 2352)):
        joined = points.reshape(-1, n, W)
        cases.append((joined[:8] if n == 2352 else joined, *cases[0][1:]))
    enc20, train20 = vitb16_points(dev, SEG20_FRAMES, SEG20_CLIPS,
                                   SEG20_SEGMENTS)
    K, kw = train20[1:]
    cases += [train20, enc20, (train20[0], 392, kw),
              (train20[0].reshape(-1, 2352, W)[:8], 2352, kw)]
    return cases


def kmedoids_rows(old, flush, dev, peaks):
    """E on each case, the new wrapper against the old one (each picks its
    own variant), in turns.  Each row: both variants, the cluster size,
    the Lloyd steps and both bounds (4-byte entries and 32-byte
    sectors)."""
    from .ops.kmedoids import kmedoids_inputs
    kc = kmedoids_cuda
    old_e = old.ops.kmedoids_cuda.kmedoids_from_distances
    new_e = kc.kmedoids_from_distances
    rows = []
    for points, K, kw in kmedoids_cases(dev):
        iters = kw["iter_limit"]
        X, D, l2 = kmedoids_inputs(points, kw["distance"], kw["norm_p"],
                                   kw["pre_norm"])
        B, N = l2.shape
        variant = kc.choose_variant(N, K)
        cs = kc.device_cluster_size(dev, B, N, K) \
            if variant == kc.CLUSTER else None
        new_out = new_e(D, l2, K, iters)
        others = {"old": lambda limit: old_e(D, l2, K, limit)}
        for name, fn in others.items():
            if not all(torch.equal(a, b)
                       for a, b in zip(fn(iters), new_out)):
                raise SystemExit(f"bench: k-medoids [{B}, {N}, {N}] K={K}: "
                                 f"the new {variant} variant's bits differ "
                                 f"from the {name} one's")
        row = dict(shape=[B, N, N], variant=variant, cluster_size=cs, K=K,
                   old_variant=old.ops.kmedoids_cuda.choose_variant(N, K),
                   iter_limit=iters, equal_to=sorted(others),
                   lloyd_steps_mean=new_out[2].float().mean().item(),
                   lloyd_steps_max=int(new_out[2].max()))
        for key, limit in (("", iters), ("kkz_", 0)):
            for name, fn in others.items():
                o, n, t = in_turns(
                    lambda: fn(limit), lambda: new_e(D, l2, K, limit),
                    lambda f: time_ms(f, flush))
                row[f"{name}_{key}ms"], row[f"{name}_{key}turns_ms"] = o, t
                if name == "old":
                    row[f"{key}ms"] = n
        row["bound_ms"], row["bound_by"] = kmedoids_bound(
            K, new_out[0], new_out[2], peaks)
        row["sector_bound_ms"], row["sector_bound_by"] = \
            kmedoids_sector_bound(K, new_out[0], new_out[2], peaks)
        print(json.dumps(row), flush=True)
        rows.append(row)
        del X, D, l2
        torch.cuda.empty_cache()
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", required=True,
                    help="a tree holding an earlier centerclip_tpu_torch/")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_ln_kmedoids: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    dev = torch.device("cuda")
    peaks = card_peaks(torch.cuda.get_device_name(0))
    old = load_old(args.old)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    ln_rows, host = layernorm_rows(old.ops.layernorm_triton, flush, dev,
                                   peaks)
    km_rows = kmedoids_rows(old, flush, dev, peaks)
    print(json.dumps({"card": smi, "torch": torch.__version__,
                      "layernorm_fwd": ln_rows, "layernorm_host": host,
                      "kmedoids": km_rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
