# coding=utf-8
"""Time the attention kernels against an earlier version of their sources.

    python -m centerclip_tpu_torch.bench_attention_ab --old-csrc DIR

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
peak).  Prints the card and one JSON line.  Needs a CUDA device.
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
HD = 64
BF16_ATOL, BF16_RTOL = 1.6e-2, 1.6e-2
MEM_RATE, BF16_PEAK = 3.35e12, 989e12      # H100 SXM data sheet
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


def within_ulp(out, ref):
    err = (out.float() - ref.float()).abs()
    ok = bool((err <= BF16_ATOL + BF16_RTOL * ref.float().abs()).all())
    return ok, err.max().item()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old-csrc", required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_attention_ab: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    old = build_old(args.old_csrc)
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
            print("a kernel disagrees with its plain version", file=sys.stderr)
            return 1
        rows.append(row)
    print(json.dumps({"card": smi, "torch": torch.__version__,
                      "ab": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
