# coding=utf-8
"""Time the attention kernels against an earlier version of their sources.

    python -m centerclip_tpu_torch.bench_attention_ab --old-csrc DIR
    python -m centerclip_tpu_torch.bench_attention_ab --old-csrc DIR --dtype fp32

DIR holds an earlier `attention.cu`, `attention_bwd.cu` and `mma_tile.cuh`
(e.g. `git archive <commit> centerclip_tpu_torch/csrc | tar -x -C <dir>`,
unpacked where git ignores it).  Their entry points for bf16 / fp16 past
L = 128 at that version, `cc_attention_fwd_mma` and `cc_attention_bwd_tiled`,
are built with nvcc into `build/ab_old/` and loaded beside the current
wrappers (`ops/attention_cuda.py`); nothing of the port calls them.

At ViT-B/16's two attention shapes (qkv [1536, 197, 2304] and
[768, 161, 2304], bf16, 12 heads of 64) both versions of kernel A and of
kernel B are held against the plain versions (within one bf16 ulp) and
timed in turns (old, new, new, old) by CUDA events, the L2 cache flushed
before each launch, beside SDPA's forward and backward and the least time
the card could take (bytes over the memory rate, operations over the bf16
peak).

With `--dtype fp32` the earlier sources' fp32 long variant
(`cc_attention_fwd_f32_long` / `cc_attention_bwd_f32_long`, fp32 FFMA on
the CUDA cores, as it was before the tf32x3 variant replaced it) is built
the same way and held, with the current tf32x3 variant (forward with its
log-sum-exp, backward from the forward's output and log-sum-exp, as the
autograd Function runs them), against the plain versions (1e-5 forward,
1e-4 backward) at FP32_SHAPES, timed in turns beside SDPA in fp32 and
two bounds: the FFMA one (the fp32 operations over 67 TFLOP/s) and the
split's (three TF32 passes over 495 TFLOP/s, or the bytes).  Prints the
card and one JSON line.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import torch

from .ops import _build, attention_cuda

SHAPES = ((1536, 197, 12), (768, 161, 12))
# (B, L, H, causal): ViT-B/16's two vision shapes, K = 392's L = 393,
# ViT-B/32's vision, the 32- and 77-word text towers
FP32_SHAPES = ((1536, 197, 12, False), (768, 161, 12, False),
               (384, 393, 12, False), (1536, 50, 12, False),
               (128, 32, 8, True), (128, 77, 8, True))
HD = 64
BF16_ATOL, BF16_RTOL = 1.6e-2, 1.6e-2
FP32_ATOL, FP32_RTOL, FP32_BWD_ATOL, FP32_BWD_RTOL = 1e-5, 1e-5, 1e-4, 1e-4
# H100 SXM data sheet: memory rate, dense bf16, TF32 and fp32 (CUDA core)
MEM_RATE, BF16_PEAK, TF32_PEAK, FP32_PEAK = 3.35e12, 989e12, 495e12, 67e12
SLEEP_CYCLES = 4_000_000


def build_old(csrc: str) -> dict:
    """{name: CDLL} of the earlier sources, each built by one nvcc, both
    started together."""
    out_dir = os.path.join(_build.BUILD_DIR, "ab_old")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name in ("attention", "attention_bwd"):
        lib = os.path.join(out_dir, f"lib{name}.so")
        procs[name] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", lib,
             os.path.join(csrc, f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for the old {name}.cu:\n{out}")
        libs[name] = ctypes.CDLL(lib)
    return libs


def time_ms(fn, flush, iters=10, warmup=3):
    """Mean device time of `fn` by CUDA events, L2 flushed and the card kept
    busy by a sleep kernel while the host enqueues."""
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


def within_ulp(out, ref, atol=BF16_ATOL, rtol=BF16_RTOL):
    err = (out.float() - ref.float()).abs()
    ok = bool((err <= atol + rtol * ref.float().abs()).all())
    return ok, err.max().item()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old-csrc", required=True)
    ap.add_argument("--dtype", choices=("bf16", "fp32"), default="bf16")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_attention_ab: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    old = build_old(args.old_csrc)
    rows = (fp32_rows if args.dtype == "fp32" else bf16_rows)(old)
    if rows is None:
        print("a kernel disagrees with its plain version", file=sys.stderr)
        return 1
    print(json.dumps({"card": smi, "torch": torch.__version__,
                      "dtype": args.dtype, "ab": rows}))
    return 0


def bf16_rows(old):
    """Old and current bf16 A and B at SHAPES; None where a kernel
    disagrees with its plain version."""
    fwd_old = attention_cuda._entry(old["attention"], "cc_attention_fwd_mma",
                                    3, 4, True)
    bwd_old = attention_cuda._entry(old["attention_bwd"],
                                    "cc_attention_bwd_tiled", 4, 4, True)
    dev = torch.device("cuda")
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    rows = []
    for B, L, H in SHAPES:
        D = H * HD
        gen = torch.Generator(device=dev).manual_seed(B + L)
        qkv = torch.randn((B, L, 3 * D), generator=gen, device=dev).to(
            torch.bfloat16)
        dout = torch.randn((B, L, D), generator=gen, device=dev).to(
            torch.bfloat16)
        stream = torch.cuda.current_stream().cuda_stream
        scale = float(HD ** -0.5)
        out_old = torch.empty((B, L, D), dtype=qkv.dtype, device=dev)
        dqkv_old = torch.empty_like(qkv)

        def a_old():
            _build.check(old["attention"], fwd_old(
                qkv.data_ptr(), None, out_old.data_ptr(), B, L, H, HD, 1,
                scale, stream), "old attention")

        def b_old():
            _build.check(old["attention_bwd"], bwd_old(
                qkv.data_ptr(), None, dout.data_ptr(), dqkv_old.data_ptr(), B,
                L, H, HD, 1, scale, stream), "old attention backward")

        def a_new():
            return attention_cuda.fused_attention(qkv, H)

        def b_new():
            return attention_cuda.attention_backward(qkv, dout, H)

        a_old()
        b_old()
        out_new = a_new()
        dqkv_new, _ = b_new()
        ref = attention_cuda.attention_plain(qkv, H)
        dref, _ = attention_cuda.attention_bwd_plain(qkv, dout, H)
        torch.cuda.synchronize()
        checks = dict(a_old=within_ulp(out_old, ref),
                      a_new=within_ulp(out_new, ref),
                      b_old=within_ulp(dqkv_old, dref),
                      b_new=within_ulp(dqkv_new, dref))
        a_equal = torch.equal(out_old, out_new)
        del ref, dref
        times = {}
        for kernel, (f_old, f_new) in (("A", (a_old, a_new)),
                                       ("B", (b_old, b_new))):
            t = [time_ms(f, flush) for f in (f_old, f_new, f_new, f_old)]
            times[kernel] = dict(old_ms=(t[0] + t[3]) / 2,
                                 new_ms=(t[1] + t[2]) / 2, turns_ms=t)
        qh, kh, vh = (x.reshape(B, L, H, HD).transpose(1, 2).detach()
                      .requires_grad_(True) for x in qkv.split(D, dim=-1))
        sdpa = torch.nn.functional.scaled_dot_product_attention
        times["A"]["sdpa_ms"] = time_ms(lambda: sdpa(qh, kh, vh), flush)
        o = sdpa(qh, kh, vh)
        do_h = dout.reshape(B, L, H, HD).transpose(1, 2)
        times["B"]["sdpa_ms"] = time_ms(lambda: torch.autograd.grad(
            o, (qh, kh, vh), do_h, retain_graph=True), flush)
        del qh, kh, vh, o
        flops = 2.0 * B * H * L * L * HD
        times["A"]["bound_ms"] = max(
            (qkv.numel() + B * L * D) * 2 / MEM_RATE, 2 * flops / BF16_PEAK) * 1e3
        times["B"]["bound_ms"] = max(
            (2 * qkv.numel() + dout.numel()) * 2 / MEM_RATE,
            5 * flops / BF16_PEAK) * 1e3
        row = dict(shape=[B, L, 3 * D], checks=checks,
                   a_new_equals_old=a_equal, **{
                       k: v for k, v in times.items()},
                   occupancy={"A": attention_cuda.long_occupancy(
                       torch.bfloat16, HD),
                              "B": attention_cuda.long_occupancy(
                                  torch.bfloat16, HD, backward=True)})
        print(f"qkv {row['shape']}: {json.dumps(row)}")
        if not all(ok for ok, _ in checks.values()):
            return None
        rows.append(row)
    return rows


def fp32_rows(old):
    """The earlier fp32 long variant (FFMA) and the current tf32x3 one at
    FP32_SHAPES, in turns, beside SDPA fp32 and both bounds; None where a
    kernel disagrees with its plain version."""
    fwd_old = attention_cuda._entry(old["attention"],
                                    "cc_attention_fwd_f32_long", 3, 4, False)
    bwd_old = attention_cuda._entry(old["attention_bwd"],
                                    "cc_attention_bwd_f32_long", 5, 4, False)
    stats_len = old["attention_bwd"].cc_attention_bwd_long_stats_len
    stats_len.restype, stats_len.argtypes = ctypes.c_int, [ctypes.c_int]
    x3 = attention_cuda.TF32X3
    dev = torch.device("cuda")
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    rows = []
    for B, L, H, causal in FP32_SHAPES:
        D = H * HD
        gen = torch.Generator(device=dev).manual_seed(B + L)
        qkv = torch.randn((B, L, 3 * D), generator=gen, device=dev)
        dout = torch.randn((B, L, D), generator=gen, device=dev)
        mask = (torch.full((L, L), float("-inf"), device=dev).triu(1)
                if causal else None)
        mask_ptr = mask.data_ptr() if mask is not None else None
        stream = torch.cuda.current_stream().cuda_stream
        scale = float(HD ** -0.5)
        out_old = torch.empty((B, L, D), device=dev)
        dqkv_old = torch.empty_like(qkv)
        stats = torch.empty((3, B * H, stats_len(L)), device=dev)

        def a_old():
            _build.check(old["attention"], fwd_old(
                qkv.data_ptr(), mask_ptr, out_old.data_ptr(), B, L, H, HD,
                scale, stream), "old fp32 attention")

        def b_old():
            _build.check(old["attention_bwd"], bwd_old(
                qkv.data_ptr(), mask_ptr, dout.data_ptr(),
                dqkv_old.data_ptr(), stats.data_ptr(), B, L, H, HD, scale,
                stream), "old fp32 attention backward")

        def a_new():
            return attention_cuda._forward(qkv, H, mask, variant=x3,
                                           lse_out=True)

        out_new, lse = a_new()

        def b_new():
            return attention_cuda.attention_backward(
                qkv, dout, H, mask, variant=x3, out=out_new, lse=lse)

        a_old()
        b_old()
        dqkv_new, _ = b_new()
        ref = attention_cuda.attention_plain(qkv, H, mask)
        dref, _ = attention_cuda.attention_bwd_plain(qkv, dout, H, mask)
        torch.cuda.synchronize()
        checks = dict(
            a_old=within_ulp(out_old, ref, FP32_ATOL, FP32_RTOL),
            a_new=within_ulp(out_new, ref, FP32_ATOL, FP32_RTOL),
            b_old=within_ulp(dqkv_old, dref, FP32_BWD_ATOL, FP32_BWD_RTOL),
            b_new=within_ulp(dqkv_new, dref, FP32_BWD_ATOL, FP32_BWD_RTOL))
        del ref, dref
        times = {}
        for kernel, (f_old, f_new) in (("A", (a_old, a_new)),
                                       ("B", (b_old, b_new))):
            t = [time_ms(f, flush) for f in (f_old, f_new, f_new, f_old)]
            times[kernel] = dict(old_ms=(t[0] + t[3]) / 2,
                                 new_ms=(t[1] + t[2]) / 2, turns_ms=t)
        qh, kh, vh = (x.reshape(B, L, H, HD).transpose(1, 2).detach()
                      .requires_grad_(True) for x in qkv.split(D, dim=-1))
        sdpa = torch.nn.functional.scaled_dot_product_attention
        times["A"]["sdpa_ms"] = time_ms(
            lambda: sdpa(qh, kh, vh, is_causal=causal), flush)
        o = sdpa(qh, kh, vh, is_causal=causal)
        do_h = dout.reshape(B, L, H, HD).transpose(1, 2)
        times["B"]["sdpa_ms"] = time_ms(lambda: torch.autograd.grad(
            o, (qh, kh, vh), do_h, retain_graph=True), flush)
        del qh, kh, vh, o
        # bytes: q, k, v, (mask,) out / dO, dq, dk, dv once each
        flops = 2.0 * B * H * L * L * HD
        mask_bytes = L * L * 4 if causal else 0
        for kernel, n_products, n_bytes in (
                ("A", 2, (qkv.numel() + B * L * D) * 4 + mask_bytes),
                ("B", 5, (2 * qkv.numel() + dout.numel()) * 4 + mask_bytes)):
            r = times[kernel]
            r["bound_ffma_ms"] = max(n_bytes / MEM_RATE,
                                     n_products * flops / FP32_PEAK) * 1e3
            r["bound_ms"] = max(n_bytes / MEM_RATE,
                                3 * n_products * flops / TF32_PEAK) * 1e3
            r["bound_by"] = ("operations" if 3 * n_products * flops
                             / TF32_PEAK > n_bytes / MEM_RATE else "bytes")
            r["vs_sdpa"] = r["new_ms"] / r["sdpa_ms"]
            r["speedup"] = r["old_ms"] / r["new_ms"]
        row = dict(shape=[B, L, 3 * D], causal=causal, checks=checks,
                   **times, occupancy={
                       "A": attention_cuda.long_occupancy(torch.float32, HD),
                       "B": attention_cuda.long_occupancy(torch.float32, HD,
                                                          backward=True)})
        print(f"qkv {row['shape']}: {json.dumps(row)}", flush=True)
        if not all(ok for ok, _ in checks.values()):
            return None
        rows.append(row)
        del qkv, dout, out_new, lse, dqkv_new, out_old, dqkv_old, stats
    return rows


if __name__ == "__main__":
    sys.exit(main())
